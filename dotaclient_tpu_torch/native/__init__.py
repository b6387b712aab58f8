"""Host-native code of the port, loaded with ctypes.

``rollout_codec``: the single-pass C++ encoder and decoder of ``Rollout``
payloads (``build.py`` compiles it at first use into ``native/_build/``),
the fast path of ``transport/serialize.py``'s ``encode_rollout_bytes`` and
``decode_rollout_bytes``.
"""

from dotaclient_tpu_torch.native.build import library_path, load_library

__all__ = ["library_path", "load_library"]

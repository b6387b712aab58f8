"""The wire format's protobuf bindings.

``dota.proto`` and ``dota_pb2.py`` are byte-identical copies of the JAX
package's (``dotaclient_tpu/protos/``), so both packages register the same
descriptor: a port process and a JAX process exchange the same messages.
Regenerate both copies together from the one ``.proto``.
"""

from dotaclient_tpu_torch.protos import dota_pb2  # noqa: F401

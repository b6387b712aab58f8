"""Build and load the native rollout codec (host C++, a plain C ABI over ctypes).

Counterpart of ``dotaclient_tpu/native/build.py``, with its own copy of the
source (``rollout_codec.cc``) and the same struct layouts. The library is
compiled with ``g++ -O2 -shared -fPIC -std=c++17`` at first use into
``native/_build/`` (ignored by git), never beside the source, under a name
that carries the source's hash: an edited source builds a new library, and
a process never loads a stale one. Processes that start together each
compile to a private temporary file and rename it into place, so a
half-written library is never loaded.

``load_library()`` returns the loaded library, or None when it cannot be
built or loaded (no ``g++``, a refused compile); the reason is logged once
and kept in ``load_error``. The codec's callers then take the protobuf path
and count it (``transport/serialize.py`` ``CODEC_CALLS``).

    python -m dotaclient_tpu_torch.native.build    # compile, print the path
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "rollout_codec.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
load_error: Optional[str] = None


def library_path() -> str:
    """Where the library of the current source lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"librollout_codec-{digest}.so")


def build(force: bool = False) -> str:
    """Compile the library unless the current source's is built; returns
    its path. Raises when the compile fails."""
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


class TensorEntry(ctypes.Structure):
    _fields_ = [
        ("name_off", ctypes.c_uint32), ("name_len", ctypes.c_uint32),
        ("dtype_off", ctypes.c_uint32), ("dtype_len", ctypes.c_uint32),
        ("data_off", ctypes.c_uint32), ("data_len", ctypes.c_uint32),
        ("shape", ctypes.c_int32 * 8), ("ndim", ctypes.c_int32),
    ]


class RolloutHeader(ctypes.Structure):
    _fields_ = [
        ("model_version", ctypes.c_int32), ("env_id", ctypes.c_int32),
        ("rollout_id", ctypes.c_uint64), ("length", ctypes.c_int32),
        ("total_reward", ctypes.c_float),
    ]


class EncodeTensor(ctypes.Structure):
    _fields_ = [
        ("name_off", ctypes.c_uint32), ("name_len", ctypes.c_uint32),
        ("dtype_off", ctypes.c_uint32), ("dtype_len", ctypes.c_uint32),
        ("data_ptr", ctypes.c_uint64), ("data_len", ctypes.c_uint64),
        ("shape", ctypes.c_int32 * 8), ("ndim", ctypes.c_int32),
    ]


def load_library() -> Optional[ctypes.CDLL]:
    """The codec library, built and loaded once a process; None when it
    cannot be (the first failure is logged and kept in ``load_error``)."""
    global _lib, _load_failed, load_error
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build())
            lib.dota_decode_rollout.restype = ctypes.c_int32
            # void* (not char*): callers pass bytes, or a raw pointer into a
            # memoryview (the shm lane's zero-copy frames)
            lib.dota_decode_rollout.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(RolloutHeader),
                ctypes.POINTER(TensorEntry), ctypes.c_int32,
            ]
            lib.dota_encode_rollout.restype = ctypes.c_int64
            lib.dota_encode_rollout.argtypes = [
                ctypes.POINTER(RolloutHeader), ctypes.c_char_p, ctypes.POINTER(EncodeTensor), ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_uint64,
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError, AttributeError) as e:
            _load_failed = True
            stderr = getattr(e, "stderr", b"") or b""
            load_error = f"{type(e).__name__}: {e} {stderr.decode(errors='replace')[-500:]}".strip()
            logger.warning("native rollout codec unavailable (%s): the protobuf codec runs instead", load_error)
    return _lib


if __name__ == "__main__":
    print(build(force=True))

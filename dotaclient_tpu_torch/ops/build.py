"""Build the port's CUDA kernels from the sources in this package.

``kernel_library()`` compiles ``csrc/*.cu`` for Hopper at first use with
``torch.utils.cpp_extension.load`` and returns the shared library, loaded
with ``ctypes``. The sources expose plain C entry points (no PyTorch headers
beyond c10's error checks), so a build takes seconds, not minutes. The
architecture flags are set here explicitly, so ``TORCH_CUDA_ARCH_LIST``
cannot change them, and the output goes to ``ops/_build/`` (ignored by git),
so nothing outside the checkout is read or written, unless
``set_build_dir`` points the build elsewhere (the learner's
``--compile-cache DIR``: processes that share ``DIR`` build once, and a
read-only checkout can still cache its build).

Every failure raises: a missing compiler, a refused build, an entry point
that is not in the library. There is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIBRARY_NAME = "dotaclient_tpu_torch_kernels"
SOURCES = ("lstm_seq.cu",)
CUDA_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types; every entry point returns int (0 = ok)
_SIGNATURES = {
    # 10 tensors; B, T, D, H; the plan's cluster, rows, grid, threads and
    # smem_bytes; stream, error buffer and its length
    "dota_lstm_seq_forward": [_P] * 10 + [_I] * 4 + [_I] * 5 + [_P, ctypes.c_char_p, _I],
    # the same tensors and sizes; the grid plan's rows, grid, threads,
    # units, kslices, kchunk, resident and smem_bytes; stream, error buffer
    # and its length
    "dota_lstm_seq_grid_forward": [_P] * 10 + [_I] * 4 + [_I] * 8 + [_P, ctypes.c_char_p, _I],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def set_build_dir(path: str) -> None:
    """Build the library in (and load it from) ``path`` instead of
    ``ops/_build/``; before the first ``kernel_library`` call of the
    process (raises after it, if ``path`` is another directory)."""
    global BUILD_DIR
    path = os.path.abspath(path)
    with _lock:
        if _library is not None and path != BUILD_DIR:
            raise RuntimeError(f"the kernel library is already loaded from {BUILD_DIR}; set the build directory "
                               "before the first kernel launch")
        BUILD_DIR = path


def library_file() -> str:
    """Where the built library lives in the current build directory."""
    return os.path.join(BUILD_DIR, LIBRARY_NAME + ".so")


def source_paths() -> List[str]:
    return [os.path.join(CSRC_DIR, name) for name in SOURCES]


def _build(verbose: bool) -> ctypes.CDLL:
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    # ptxas's register report is always asked for (``verbose`` only shows
    # it): the flags are part of the build's hash, so a quiet process reuses
    # a verbose one's build instead of compiling again
    flags = list(CUDA_FLAGS) + ["-Xptxas=-v"]
    path = load(
        name=LIBRARY_NAME,
        sources=source_paths(),
        extra_cuda_cflags=flags,
        build_directory=BUILD_DIR,
        with_cuda=True,
        is_python_module=False,
        verbose=verbose,
    )
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def kernel_library(verbose: bool = False) -> ctypes.CDLL:
    """The built kernel library, compiled once per process (``load`` skips
    the compile when sources and flags are unchanged since the last build in
    ``BUILD_DIR``). ``verbose`` prints the compiler's output, register and
    shared-memory use included; it only matters on the first call."""
    global _library
    with _lock:
        if _library is None:
            _library = _build(verbose)
        return _library


def check(status: int, err: ctypes.Array, what: str) -> None:
    """Raise if a C entry point reported a failure."""
    if status != 0:
        raise RuntimeError(f"{what} failed: {err.value.decode(errors='replace')}")

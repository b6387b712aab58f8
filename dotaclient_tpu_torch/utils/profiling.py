"""A device trace of a block of work: the learner's ``--profile DIR``.

Counterpart of ``dotaclient_tpu/utils/profiling.py``'s ``trace``, over
``torch.profiler``: the enclosed block's host activity and, when a CUDA card
is present, its CUDA activity (kernels, copies, the runtime calls that
issued them), written as one Chrome trace (``trace_<pid>.json``) into the
directory, which ``chrome://tracing`` or Perfetto opens. With ``None`` it
does nothing::

    with trace("runs/profile"):
        learner.train(100)
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block into ``logdir`` (no-op when None). The
    trace is written when the block ends, raised out of or not."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
    prof.start()
    try:
        yield
    finally:
        try:
            if cuda:
                torch.cuda.synchronize()   # the block's kernels end inside the window
        finally:
            prof.stop()
            prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))

"""Tracing-plane keys and the device memory gauge.

Copy of ``ensure_metrics`` and ``update_memory_gauges`` from
``dotaclient_tpu/utils/tracing.py``, so a port process reports the same
trace/compile/memory keys (zeros when nothing fired). The cross-process
trace records, ``TraceWriter`` and the CLIs' ``--trace-jsonl`` wait for
ROADMAP queue 1, item 8; the per-program compile counters
(``instrument_jit`` there) have no counterpart: PyTorch runs eagerly and
compiles nothing per program.
"""

from __future__ import annotations

from typing import Optional

import torch

from dotaclient_tpu_torch.device import DeviceLike
from dotaclient_tpu_torch.utils import telemetry


def ensure_metrics(registry: Optional[telemetry.Registry] = None) -> None:
    """Eager-create the trace/compile/mem keys."""
    reg = registry if registry is not None else telemetry.get_registry()
    for key in (
        "trace/emitted_total",
        "trace/dropped_total",
        "compile/compiles_total",
        "compile/retraces_total",
        "compile/compile_time_s_total",
    ):
        reg.counter(key)
    reg.gauge("mem/hbm_peak_bytes")


def update_memory_gauges(registry: Optional[telemetry.Registry] = None, device: DeviceLike = None) -> float:
    """Set ``mem/hbm_peak_bytes`` to the caching allocator's peak on
    ``device`` (``torch.cuda.max_memory_allocated``: allocator metadata,
    no synchronisation), or to 0 for a CPU device; returns it."""
    reg = registry if registry is not None else telemetry.get_registry()
    device = torch.device(device) if device is not None else torch.device("cpu")
    peak = float(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0.0
    reg.gauge("mem/hbm_peak_bytes").set(peak)
    return peak

"""Helpers the per-layer metric readers share: each reader is a small file
of its own under ``benchmark/metrics/`` that calls one of these on the run's
context and returns a number, or None when the run has nothing to read."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

from benchmark import yardstick

# the port's LSTM kernels, by the names their launches carry in a trace
LSTM_KERNELS: Tuple[str, ...] = ("lstm_seq_cluster_kernel", "lstm_seq_grid_kernel")


class MetricError(RuntimeError):
    """The trace disagrees with what the cell's configuration implies."""


def roofline_pct(ctx: Mapping[str, Any], family: str, names: Tuple[str, ...] = LSTM_KERNELS) -> Optional[float]:
    """The kernel's share of its roofline over the profiled sub-window: the
    least time of each expected launch (``yardstick.lstm_bound_s`` of its
    B, T, D, H), summed, over the device time of the launches found by
    name. The count found has to be the count the configuration implies."""
    prof = ctx.get("profile")
    if ctx.get("family") != family or prof is None or not prof.device:
        return None
    expected = ctx["profiled_lstm_launches"]
    found = prof.kernels(names)
    if len(found) != len(expected):
        raise MetricError(f"the profile holds {len(found)} {names} launches; the configuration implies "
                          f"{len(expected)}")
    if not found:
        return None
    bound = sum(yardstick.lstm_bound_s(*shape)[0] for shape in expected)
    busy = sum(e - s for _, s, e in found) / 1e6
    return 100.0 * bound / busy


def idle_share_pct(ctx: Mapping[str, Any], family: str) -> Optional[float]:
    prof = ctx.get("profile")
    if ctx.get("family") != family or prof is None or not prof.device or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)


def mfu_pct(ctx: Mapping[str, Any], family: str) -> Optional[float]:
    """Model FLOPs of the work done over its host-clock seconds, as a share
    of the card's dense bf16 peak."""
    if ctx.get("family") != family or not ctx.get("model_seconds"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["model_seconds"] / yardstick.PEAK_BF16_FLOPS


def device_kernels(prof) -> Optional[int]:
    """Kernels in the profile (copies and fills left out); None without a
    device trace."""
    if not prof.device:
        return None
    return sum(1 for name, _, _ in prof.device if not name.startswith(("Memcpy", "Memset")))

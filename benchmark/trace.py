"""One profiled sub-window: ``torch.profiler`` over a block that ends in a
synchronise, reduced in memory to what the per-layer metrics read (device
operations with their intervals, host operations for naming idle gaps); no
trace file is written.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass
class Profile:
    window_s: float                               # host clock over the block
    device: List[Tuple[str, float, float]]        # (name, start_us, end_us), start order
    host: List[Tuple[str, float, float]]          # host operations, same clock

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device intervals)."""
        busy, end = 0.0, float("-inf")
        for _, s, e in self.device:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def kernels(self, names: Tuple[str, ...]) -> List[Tuple[str, float, float]]:
        return [ev for ev in self.device if any(n in ev[0] for n in names)]

    def top_device_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            total[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time between operations, summed by the innermost
        host operation running at each gap's middle (the latest-starting
        one that still spans it)."""
        by: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda ev: ev[1])
        starts = [ev[1] for ev in host]
        end = None
        for _, s, e in self.device:
            if end is not None and s > end:
                mid = 0.5 * (s + end)
                name = "host: no traced operation"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 2000, -1), -1):
                    if host[j][2] >= mid:
                        name = host[j][0]
                        break
                by[name] += (s - end) / 1e6
            end = e if end is None else max(end, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _events(prof) -> Tuple[List, List]:
    """(device, host) events from the profiler's Kineto results."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
        else:
            s, d = float(ev.start_us()), float(ev.duration_us())
        item = (ev.name(), s, s + d)
        if ev.device_type() == DeviceType.CUDA:
            # a record_function span leaves a device-side annotation over
            # its block: not an operation (on the host it names idle gaps)
            if "annotation" not in str(getattr(ev, "activity_type", lambda: "")()):
                device.append(item)
        else:
            host.append(item)
    device.sort(key=lambda ev: ev[1])
    return device, host


class Profiler:
    """``start`` and ``stop`` around a sub-window (host and CUDA activity;
    host alone where there is no card); ``stop`` synchronises first, so the
    window's device work lies inside."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = torch_profile(activities=activities)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> Profile:
        if self._cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        device, host = _events(self._prof)
        self._prof = None
        return Profile(window, device, host)

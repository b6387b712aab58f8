"""Dependency-free telemetry: one registry of counters, gauges and timers.

Copy of the primitives of ``dotaclient_tpu/utils/telemetry.py`` with the
same key schema, so a port process reports the keys the reference's tools
read:

* counters and gauges: ``<name>`` -> float value;
* timers: ``<name>/count``, ``/total_s``, ``/last_s``, ``/mean_s``,
  ``/ema_s``, ``/p95_s``; spans are timers named ``span/<stage>``.

Everything is host wall clock; recording never touches the device.
The sinks ``MetricsLogger`` (``utils/metrics.py``) drives, as the
reference's: ``ConsoleSink`` (the short line, telemetry keys left out),
``TensorBoardSink`` (tensorboardX, when it is installed) and ``JsonlSink``
(the learner's ``--metrics-jsonl``, the serve CLI's
``--serve-metrics-jsonl``, the router CLI's ``--metrics-jsonl``: one line a
boundary, structured events such as ``ALERT`` included), read back by
``load_jsonl`` and scanned by ``json_records`` and ``scan_metrics``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, TextIO, Tuple

# Pipeline tracing's sample cadence (``utils/tracing.py``): with a trace log
# configured, every Nth sampling decision (a chunk's encode, a dispatch, a
# serve request) carries or emits a record; ``--trace-sample`` overrides it
# a process.
trace_sample_n = 16

# Fleet-health snapshot cadence in seconds (the utilization plane's fold
# interval defaults to it).
fleet_interval_s = 5.0


class Counter:
    """Monotone counter. ``inc`` is the only mutator."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins level (assignment is atomic under the GIL)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


# Histogram buckets: powers of two from 1 us; bucket i covers
# [2^i, 2^(i+1)) us and 36 buckets reach ~64 s.
_N_BUCKETS = 36
_BUCKET0_S = 1e-6


class Timer:
    """Duration accumulator: count/total/last, EMA, approximate quantiles."""

    __slots__ = ("count", "total", "last", "ema", "_buckets", "_lock")

    EMA_ALPHA = 0.2

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.last = 0.0
        self.ema = 0.0
        self._buckets = [0] * _N_BUCKETS
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        seconds = max(float(seconds), 0.0)
        with self._lock:
            self.count += 1
            self.total += seconds
            self.last = seconds
            self.ema = (
                seconds
                if self.count == 1
                else self.EMA_ALPHA * seconds + (1 - self.EMA_ALPHA) * self.ema
            )
            if seconds > 0:
                i = int(math.log2(max(seconds, _BUCKET0_S) / _BUCKET0_S))
                self._buckets[min(max(i, 0), _N_BUCKETS - 1)] += 1
            else:
                self._buckets[0] += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile from the bucket upper bounds (within 2x)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            seen = 0
            for i, c in enumerate(self._buckets):
                seen += c
                if seen >= target:
                    return _BUCKET0_S * (2.0 ** (i + 1))
        return _BUCKET0_S * (2.0 ** _N_BUCKETS)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            count, total, last, ema = self.count, self.total, self.last, self.ema
        return {
            "count": float(count),
            "total_s": total,
            "last_s": last,
            "mean_s": total / count if count else 0.0,
            "ema_s": ema,
            "p95_s": self.quantile(0.95),
        }


class Registry:
    """Named counters/gauges/timers plus the nesting ``span`` timer, with
    create-or-get semantics; all mutation is thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timers: Dict[str, Timer] = {}
        self._span_stack = threading.local()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = Timer()
            return t

    @contextlib.contextmanager
    def span(self, stage: str) -> Iterator[None]:
        """Time one stage into ``span/<stage>``. A bare name nests under the
        enclosing span of this thread; a name with "/" is absolute."""
        stack: List[str] = getattr(self._span_stack, "names", None) or []
        full = stage if "/" in stage or not stack else f"{stack[-1]}/{stage}"
        self._span_stack.names = stack + [full]
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timer(f"span/{full}").observe(time.perf_counter() - t0)
            self._span_stack.names = stack

    def snapshot(self) -> Dict[str, float]:
        """Flatten every metric to ``name -> float`` per the key schema."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            timers = list(self._timers.items())
        out: Dict[str, float] = {}
        for name, c in counters:
            out[name] = c.value
        for name, g in gauges:
            out[name] = g.value
        for name, t in timers:
            for stat, v in t.stats().items():
                out[f"{name}/{stat}"] = v
        return out

    def counters_and_gauges(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Counter totals and gauge values as two plain dicts, timers left
        out: what the alert engine evaluates and the router CLI snapshots."""
        with self._lock:
            return (
                {n: c.value for n, c in self._counters.items()},
                {n: g.value for n, g in self._gauges.items()},
            )

    def clear(self) -> None:
        """Drop every metric (test isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()


class ConsoleSink:
    """The short console line: only keys without a "/" print (every
    telemetry key has one), so a log line stays readable."""

    def __init__(self, t0: Optional[float] = None) -> None:
        self._t0 = t0 if t0 is not None else time.time()

    def emit(self, step: int, scalars: Dict[str, float]) -> None:
        parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(scalars.items()) if "/" not in k)
        print(f"[{time.time() - self._t0:8.1f}s] step {step}: {parts}", flush=True)

    def close(self) -> None:
        pass


class TensorBoardSink:
    """tensorboardX scalars. Build it with :meth:`create`, which returns
    None with one warning when tensorboardX is not installed: a ``logdir``
    never stops a run, the other sinks go on."""

    def __init__(self, writer) -> None:
        self._writer = writer

    @classmethod
    def create(cls, logdir: str) -> Optional["TensorBoardSink"]:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            print(f"WARNING: tensorboardX not installed: logdir {logdir!r} ignored; continuing with the console "
                  "and JSONL sinks only", flush=True)
            return None
        return cls(SummaryWriter(logdir))

    def emit(self, step: int, scalars: Dict[str, float]) -> None:
        for name, v in scalars.items():
            self._writer.add_scalar(name, v, step)

    def close(self) -> None:
        self._writer.close()


def _json_safe(v: float) -> Optional[float]:
    # NaN/Inf are not JSON: a diverged value becomes null
    return v if math.isfinite(v) else None


class JsonlSink:
    """Append one JSON object per emit: ``{"ts": <unix>, "step": <int>,
    "scalars": {name: number|null}}``, and per ``emit_event`` one
    ``{"ts": <unix>, "event": ..., ...}`` line. Every line is one write of a
    whole line and a flush, so a killed process tears at most its last
    line; a torn last line left by an earlier process is cut before
    appending, and ``close`` fsyncs."""

    def __init__(self, path: str) -> None:
        self.path = path
        _seal_torn_tail(path)
        self._f: Optional[TextIO] = open(path, "a", buffering=1)
        self._lock = threading.Lock()

    def emit(self, step: int, scalars: Dict[str, float]) -> None:
        line = json.dumps(
            {
                "ts": time.time(),
                "step": int(step),
                "scalars": {k: _json_safe(float(v)) for k, v in scalars.items()},
            },
            sort_keys=True,
        )
        self._write_line(line)

    def emit_event(self, event: Dict[str, object]) -> None:
        """Append one structured event line (``{"ts", "event", ...}``, keys
        sorted) to the stream of metric lines: the alert channel."""
        self._write_line(json.dumps({"ts": time.time(), **event}, sort_keys=True))

    def _write_line(self, line: str) -> None:
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                except (OSError, ValueError):
                    pass  # durability is best-effort; close must not raise
                self._f.close()
                self._f = None


def _seal_torn_tail(path: str) -> None:
    """Cut an unterminated trailing fragment from an existing JSONL file
    (best-effort: a missing or unwritable file is left as it is)."""
    try:
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return
            f.seek(size - 1)
            if f.read(1) == b"\n":
                return
            pos = size
            while pos > 0:
                step = min(4096, pos)
                f.seek(pos - step)
                idx = f.read(step).rfind(b"\n")
                if idx >= 0:
                    f.truncate(pos - step + idx + 1)
                    return
                pos -= step
            f.truncate(0)
    except OSError:
        return


def load_jsonl(path: str) -> List[str]:
    """The complete lines of a JSONL file: an unterminated last line (a
    write cut by a kill) is dropped, never parsed, and bytes torn inside a
    UTF-8 sequence are replaced rather than raised on."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    if not text:
        return []
    lines = text.split("\n")
    # the piece after the last newline: "" when the file ends with one,
    # else the torn line
    lines.pop()
    return lines


def json_records(lines: List[str]) -> List[dict]:
    """The JSON objects among a record's lines, in order: a torn line, or a
    value that is not an object, is skipped."""
    out = []
    for raw in lines:
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            out.append(obj)
    return out


class MetricsScan(NamedTuple):
    """A run record read by ``scan_metrics``."""
    points: List[Tuple[int, Dict[str, float]]]  # (step, numeric scalars) a metrics line with an int step
    union: Dict[str, float]  # the latest union of the metrics lines' numeric scalars
    last_ts: Optional[float]  # the last numeric ts: a corrupt one keeps the last good one
    last_step: Optional[int]
    events: List[dict]  # the event lines (``ALERT`` and the like), in order


def scan_metrics(lines: List[str]) -> MetricsScan:
    """The metrics lines of a run record (``{"ts", "step", "scalars"}``),
    and its event lines apart. Torn lines and lines without a dict of
    scalars are skipped; the union carries counters and gauges forward
    (fleet mirrors may ride some lines only)."""
    scan = MetricsScan([], {}, None, None, [])
    last_ts, last_step = None, None
    for obj in json_records(lines):
        if "event" in obj:
            scan.events.append(obj)
            continue
        sc = obj.get("scalars")
        if not isinstance(sc, dict):
            continue
        numeric = {k: v for k, v in sc.items() if isinstance(v, (int, float))}
        scan.union.update(numeric)
        ts = obj.get("ts")
        if isinstance(ts, (int, float)):
            last_ts = ts
        step = obj.get("step")
        if isinstance(step, int):
            last_step = step
            scan.points.append((step, numeric))
    return scan._replace(last_ts=last_ts, last_step=last_step)


# One process-wide registry; tests that want isolation construct their own.
_GLOBAL = Registry()


def get_registry() -> Registry:
    return _GLOBAL

"""Pipeline tracing plane: cross-process trace records, the trace log, the
trace/compile/memory keys.

Copy of ``dotaclient_tpu/utils/tracing.py`` without its device hooks. A
sampled rollout chunk, every weights frame a tracing learner publishes and
a sampled serve request carry a compact trace record as the in-band
``__trace__`` entry of their frame (``transport/serialize.py``): origin
pid and actor, a trace id, the weights version at collect, and hop
timestamps. The blob's bytes are the reference's, so a JAX actor's chunk
and a port actor's parse the same on both sides.

* **Hops of a chunk.** ``collect`` and ``encode`` at the actor (the vec
  pool), ``recv`` (transport receive and CRC check, one stamp: both lanes
  check in the same pass) and ``consume`` (drain decode) at the learner's
  ``decode_drained_payloads``, ``admit`` at the ring's insertion,
  ``gather`` at its ``take`` (ring residency = gather - admit), and
  ``dispatch`` when the learner issues the update that consumes it. The
  weights leg: ``publish`` at the learner, an ``apply`` event at the
  actor. A serve request: ``encode`` -> ``recv`` -> ``reply`` -> ``done``.
* **Clocks.** Every stamp is ``time.monotonic()`` plus a per-process epoch
  offset taken at import (:func:`now`): monotonic within a process,
  wall-aligned across processes on one host. Every stamp is a host clock
  read on host metadata; tracing reads no device tensor.
* **The log.** Events go to a per-process JSONL file (the CLIs'
  ``--trace-jsonl``), one in every ``telemetry.trace_sample_n`` sampling
  decisions (``--trace-sample``). The hot path appends to a deque; one
  writer thread writes and flushes whole lines, so a SIGKILLed process
  tears at most its last line. With tracing off, each site is one
  ``is not None`` test of the tracer its object captured at construction
  (:func:`get`). ``utils/trace_report.py`` joins a run's logs.

Not ported: ``instrument_jit``, the reference's per-program compile
counters. Eager PyTorch compiles nothing per program, so the
``compile/*`` keys :func:`ensure_metrics` creates stay zeros.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Dict, Optional

from dotaclient_tpu_torch.utils import telemetry

if TYPE_CHECKING:
    from dotaclient_tpu_torch.device import DeviceLike

# monotonic deltas within a process, wall-aligned across processes
_EPOCH_OFFSET = time.time() - time.monotonic()


def now() -> float:
    """Epoch-aligned monotonic timestamp (seconds)."""
    return time.monotonic() + _EPOCH_OFFSET


# a chunk's blob is padded to this many bytes, so every traced chunk of one
# layout has one frame size
TRACE_WIRE_LEN = 192


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


def update_memory_gauges(registry: Optional[telemetry.Registry] = None, device: "DeviceLike" = None) -> float:
    """Set ``mem/hbm_peak_bytes`` to the caching allocator's peak on
    ``device`` (``torch.cuda.max_memory_allocated``: allocator metadata,
    no synchronisation), or to 0 for a CPU device; returns it."""
    import torch   # here: the socket lane and the router import this module without torch

    reg = registry if registry is not None else telemetry.get_registry()
    device = torch.device(device) if device is not None else torch.device("cpu")
    peak = float(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0.0
    reg.gauge("mem/hbm_peak_bytes").set(peak)
    return peak


# -- trace records -----------------------------------------------------------
#
# Host form: {"tid": str, "pid": int, "actor": int, "wv": int,
#             "hops": [[name, ts], ...]}.
# Wire form: newline-joined ASCII, a header line and a line a hop:
#     tid=<id> pid=<int> actor=<int> wv=<int>
#     h <name> <ts.6f>
# padded with spaces to TRACE_WIRE_LEN on a chunk, unpadded elsewhere.


def new_record(tid: str, actor: int, weights_version: int) -> Dict[str, Any]:
    return {"tid": tid, "pid": os.getpid(), "actor": int(actor), "wv": int(weights_version), "hops": []}


def append_hop(record: Dict[str, Any], name: str, ts: Optional[float] = None) -> Dict[str, Any]:
    record["hops"].append([name, now() if ts is None else ts])
    return record


def record_to_blob(record: Dict[str, Any], pad: bool = True) -> bytes:
    lines = [f"tid={record['tid']} pid={record['pid']} actor={record['actor']} wv={record['wv']}"]
    lines += [f"h {name} {ts:.6f}" for name, ts in record["hops"]]
    blob = "\n".join(lines).encode()
    if pad and len(blob) < TRACE_WIRE_LEN:
        blob = blob.ljust(TRACE_WIRE_LEN, b" ")
    return blob


def parse_blob(blob: Any) -> Optional[Dict[str, Any]]:
    """Wire blob -> host record; None on anything unparseable (a corrupt
    trace entry never takes a consume path down)."""
    try:
        text = bytes(blob).decode("ascii", "replace")
    except (TypeError, ValueError):
        return None
    record: Optional[Dict[str, Any]] = None
    for line in text.split("\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith("tid="):
            fields = dict(kv.split("=", 1) for kv in line.split() if "=" in kv)
            try:
                record = {"tid": fields["tid"], "pid": int(fields["pid"]), "actor": int(fields["actor"]),
                          "wv": int(fields["wv"]), "hops": []}
            except (KeyError, ValueError):
                return None
        elif line.startswith("h ") and record is not None:
            parts = line.split()
            if len(parts) == 3:
                try:
                    record["hops"].append([parts[1], float(parts[2])])
                except ValueError:
                    return None
    return record


def stamp_serve_recv(meta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The serve lane's ``recv`` stamp (receive and CRC check are one
    ``_recv_frame`` pass) on a decoded request's record, promoted to
    ``meta["trace"]``."""
    record = parse_blob(meta.get("trace_blob"))
    if record is None:
        return None
    record["hops"].append(["recv", now()])
    meta["trace"] = record
    return record


def weights_record(version: int) -> Dict[str, Any]:
    """The record a weights frame carries: the learner's pid and a
    ``publish`` hop (``actor`` -1 marks the learner), so an actor's apply
    event dates the fanout."""
    return append_hop(new_record(f"w{os.getpid():x}-{int(version):x}", -1, version), "publish")


def stamp_wire_hops(meta: Dict[str, Any], recv_ts: Optional[float]) -> Optional[Dict[str, Any]]:
    """Promote a decoded payload's blob (``meta["trace_blob"]``) to the host
    record (``meta["trace"]``) and stamp the learner's ingest hops:
    ``recv`` (the transport's stamp, when it gave one) and ``consume``
    (now). An unparseable blob is dropped."""
    record = parse_blob(meta.get("trace_blob"))
    if record is None:
        return None
    if recv_ts is not None:
        record["hops"].append(["recv", recv_ts])
    record["hops"].append(["consume", now()])
    meta["trace"] = record
    return record


# -- the writer thread -------------------------------------------------------


class TraceWriter:
    """A process's trace-event sink: a deque the hot paths append to and one
    writer thread writing JSON lines. The queue is bounded: when the writer
    falls behind, new events are dropped and counted in
    ``trace/dropped_total`` (a slow disk never holds back the train loop).
    Each drained batch is flushed line-complete."""

    MAX_QUEUE = 8192

    def __init__(self, path: str, registry: Optional[telemetry.Registry] = None) -> None:
        reg = registry if registry is not None else telemetry.get_registry()
        self._emitted = reg.counter("trace/emitted_total")
        self._dropped = reg.counter("trace/dropped_total")
        self._f = open(path, "a", buffering=1)   # line-buffered
        self._queue: deque = deque()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, name="trace-writer", daemon=True)
        self._thread.start()

    def enqueue(self, event: Dict[str, Any]) -> None:
        """The hot path: one length check and one append (atomic under the
        interpreter lock)."""
        if self._stopped:
            return
        if len(self._queue) >= self.MAX_QUEUE:
            self._dropped.inc()
            return
        self._queue.append(event)

    def _run(self) -> None:
        while True:
            drained = 0
            while self._queue:
                event = self._queue.popleft()
                try:
                    self._f.write(json.dumps(event, sort_keys=True) + "\n")
                except (OSError, ValueError, TypeError):
                    self._dropped.inc()
                    continue
                drained += 1
            if drained:
                self._emitted.inc(drained)
                try:
                    self._f.flush()
                except OSError:
                    pass
            if self._stopped and not self._queue:
                return
            time.sleep(0.05)

    def close(self, timeout: float = 5.0) -> None:
        """Drain and stop the writer, then flush, fsync and close the file."""
        self._stopped = True
        self._thread.join(timeout)
        # lint-ok: thread-ownership(join() above: the writer thread has
        # exited before this thread touches the file)
        f = self._f
        try:
            f.flush()
            os.fsync(f.fileno())
        except (OSError, ValueError):
            pass
        try:
            f.close()
        except OSError:
            pass


class Tracer:
    """Sampling and event emission for one process."""

    def __init__(self, jsonl_path: Optional[str], sample_n: int,
                 registry: Optional[telemetry.Registry] = None) -> None:
        self.sample_n = max(1, int(sample_n))
        self._seq = 0
        self.pid = os.getpid()
        self._writer = TraceWriter(jsonl_path, registry) if jsonl_path else None

    def should_sample(self) -> bool:
        """One increment and one modulo: the cost of an unsampled decision."""
        self._seq += 1
        return self._seq % self.sample_n == 0

    def next_tid(self, actor: int) -> str:
        return f"{self.pid:x}-{actor & 0xFFFF:x}-{self._seq:x}"

    def emit(self, event: str, **fields: Any) -> None:
        if self._writer is not None:
            self._writer.enqueue({"ts": now(), "pid": self.pid, "event": event, **fields})

    def emit_chunk(self, record: Dict[str, Any]) -> None:
        """One chunk's record as this process knows it (emitted at its last
        hop here)."""
        if self._writer is not None:
            self._writer.enqueue({
                "ts": now(), "pid": self.pid, "event": "chunk", "tid": record["tid"],
                "origin_pid": record["pid"], "actor": record["actor"], "wv": record["wv"],
                # a copy: the in-process path goes on appending hops to the
                # live record while the writer serializes this one
                "hops": list(record["hops"]),
            })

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


_ACTIVE: Optional[Tracer] = None


def get() -> Optional[Tracer]:
    """The process tracer, or None when tracing is off. Hot paths capture
    it once at construction, so tracing off costs one ``is not None``
    test a site."""
    return _ACTIVE


def configure(jsonl_path: Optional[str], sample_n: Optional[int] = None,
              registry: Optional[telemetry.Registry] = None) -> Optional[Tracer]:
    """Install (or, with ``jsonl_path=None``, remove) the process tracer.
    Call it before building the pools, buffers, learners and engines that
    capture :func:`get`. ``sample_n`` defaults to
    ``telemetry.trace_sample_n``."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
        _ACTIVE = None
    if jsonl_path is None:
        return None
    ensure_metrics(registry)
    n = telemetry.trace_sample_n if sample_n is None else sample_n
    _ACTIVE = Tracer(jsonl_path, n, registry)
    return _ACTIVE


def shutdown() -> None:
    """Drain and close the process tracer (the clean-exit paths)."""
    configure(None)


__all__ = [
    "TRACE_WIRE_LEN", "TraceWriter", "Tracer", "append_hop", "configure", "ensure_metrics", "get", "new_record",
    "now", "parse_blob", "record_to_blob", "shutdown", "stamp_serve_recv", "stamp_wire_hops",
    "update_memory_gauges", "weights_record",
]

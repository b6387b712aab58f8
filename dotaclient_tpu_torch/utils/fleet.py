"""Fleet health plane: peer labels, metric snapshots and the learner's aggregator.

Copy of ``peer_label``, the snapshot codec (``encode_snapshot``,
``decode_snapshot``) and ``FleetAggregator`` of
``dotaclient_tpu/utils/fleet.py``:

* a snapshot is one peer's counter totals and gauge values, filtered to the
  fleet's namespaces, carried by the rollout codec (scalar float64 leaves
  under ``c/`` and ``g/``; the peer's pid, id, sequence number and kind in
  the rollout header);
* ``FleetAggregator`` merges the snapshots that reader threads ``ingest``
  on its own thread: per-peer keys ``fleet/<peer>/<metric>`` (counters
  merged as deltas, so a restarted peer never counts twice; gauges last
  write wins; a derived ``env_fps``) and rollups
  ``fleet/agg/<metric>/{min,max,mean}`` over live peers, with
  ``fleet/peers_stale`` for the silent ones; the alert engine
  (``utils/alerts.py``) evaluates on the same thread. Its construction
  creates every ``fleet/`` and ``alerts/`` key, so a learner record
  carries them whether or not a fleet reports. The learner builds one on
  every run; its thread starts only in the external actor modes, which
  come with ROADMAP queue 1, item 4b.

``SessionRouter.status`` names each backend's row with ``peer_label``. The
peer side (``FleetPublisher``) waits for item 8. This module imports no
torch at load: the router CLI, which holds no CUDA context, imports it.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.utils import telemetry

# the namespaces a peer ships (timers never ship: their leaves are derived)
SNAPSHOT_PREFIXES = ("actor/", "transport/", "serve/", "faults/", "trace/", "shm/", "outcome/", "util/")

# peer kinds, indexed by the rollout header's ``length`` field
PEER_KINDS = ("actor", "serve")


def peer_label(kind: str, peer_id: int) -> str:
    """``<kind initial><peer id>``: ``a0``, ``s7788``. Serve peers key on
    their listen port, so a label survives a restart of the process and the
    router can name a backend's row from its address alone."""
    return f"{kind[0]}{int(peer_id)}"


# rollups: metric -> (source kind, the peer's key). "gauge" is the peer's
# last value, "counter" its merged total, "rate" the per-second rate of
# actor/env_steps between snapshots
AGG_SOURCES: Dict[str, Tuple[str, str]] = {
    "weight_staleness": ("gauge", "actor/weight_refresh_lag"),
    "env_fps": ("rate", "actor/env_steps"),
    "reconnects": ("counter", "transport/reconnects_total"),
    "corrupt_frames": ("counter", "transport/frames_corrupt_total"),
    "ship_wait": ("gauge", "util/actor/ship_wait"),
}
AGG_STATS = ("min", "max", "mean")
AGG_KEYS = tuple(f"{metric}/{stat}" for metric in AGG_SOURCES for stat in AGG_STATS)

# the codec's entry table holds 64 tensors: the snapshot keeps 60 leaves,
# the operational keys first, then the outcome keys, the episode-length
# histogram last
_MAX_SNAPSHOT_LEAVES = 60


def _cut_priority(name: str) -> int:
    if name.startswith("outcome/ep_len_hist/"):
        return 2
    if name.startswith("outcome/"):
        return 1
    return 0


def encode_snapshot(peer_id: int, kind: str, seq: int, counters: Dict[str, float], gauges: Dict[str, float],
                    pid: Optional[int] = None) -> bytes:
    """One metric snapshot as wire bytes. Counter totals are cumulative;
    the aggregator takes deltas, which survives lost frames and restarts."""
    from dotaclient_tpu_torch.transport.serialize import encode_rollout_bytes

    names = sorted((n for n in (*counters, *gauges) if n.startswith(SNAPSHOT_PREFIXES)),
                   key=lambda n: (_cut_priority(n), n))[:_MAX_SNAPSHOT_LEAVES]
    keep = set(names)
    flat: Dict[str, np.ndarray] = {}
    for name, v in counters.items():
        if name in keep:
            flat[f"c/{name}"] = np.float64(v)
    for name, v in gauges.items():
        if name in keep:
            flat[f"g/{name}"] = np.float64(v)
    return bytes(encode_rollout_bytes(
        flat,
        model_version=os.getpid() if pid is None else int(pid),
        env_id=int(peer_id),
        rollout_id=int(seq),
        length=PEER_KINDS.index(kind),
        total_reward=0.0,
    ))


def decode_snapshot(payload: Any) -> Optional[Dict[str, Any]]:
    """Wire bytes -> snapshot dict, or None for anything that does not
    parse (a bad snapshot never takes a reader thread down)."""
    from dotaclient_tpu_torch.transport.serialize import decode_rollout_bytes, flatten_tree

    try:
        meta, arrays = decode_rollout_bytes(payload)
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        for name, arr in flatten_tree(arrays).items():
            if name.startswith("c/"):
                counters[name[2:]] = float(arr.reshape(-1)[0])
            elif name.startswith("g/"):
                gauges[name[2:]] = float(arr.reshape(-1)[0])
        kind_idx = int(meta["length"])
        kind = PEER_KINDS[kind_idx] if 0 <= kind_idx < len(PEER_KINDS) else "actor"
        return {
            "peer": peer_label(kind, int(meta["env_id"])),
            "kind": kind,
            "pid": int(meta["model_version"]),
            "seq": int(meta["rollout_id"]),
            "counters": counters,
            "gauges": gauges,
        }
    except Exception:  # noqa: BLE001 - a peer's bad frame is dropped, never raised
        return None


class _PeerState:
    """The aggregator thread's view of one peer."""

    __slots__ = ("pid", "kind", "last_seen", "last_raw", "totals", "gauges", "rate_samples")

    def __init__(self, kind: str) -> None:
        self.pid = 0
        self.kind = kind
        self.last_seen = 0.0
        self.last_raw: Dict[str, float] = {}   # the current pid's raw totals (the delta base)
        self.totals: Dict[str, float] = {}     # merged across restarts
        self.gauges: Dict[str, float] = {}
        self.rate_samples: deque = deque()     # (t, actor/env_steps total)


class FleetAggregator:
    """Merges peers' snapshots and evaluates the alert rules.

    ``ingest`` runs on reader threads and only parks a decoded snapshot
    under the lock; ``tick`` (the merge, the rollups, the tick hooks, the
    alert evaluation) runs on this object's thread once ``start`` is
    called, or on the caller's in tests. Everything the rest of the process
    reads goes through the registry."""

    def __init__(
        self,
        registry: Optional[telemetry.Registry] = None,
        interval_s: Optional[float] = None,
        stale_after_s: Optional[float] = None,
        forget_after_s: float = 300.0,
        emit_event: Optional[Callable[[Dict[str, object]], None]] = None,
        rules: Optional[tuple] = None,
    ) -> None:
        from dotaclient_tpu_torch.utils.alerts import AlertEngine

        self._reg = registry if registry is not None else telemetry.get_registry()
        self.interval_s = max(0.05, telemetry.fleet_interval_s if interval_s is None else float(interval_s))
        # several missed snapshots, floored so a slow host's jitter does
        # not flap the stale gauge
        self.stale_after_s = max(4.0 * self.interval_s, 6.0) if stale_after_s is None else float(stale_after_s)
        self.forget_after_s = float(forget_after_s)
        self._lock = threading.Lock()
        self._inbox: List[Tuple[float, Dict[str, Any]]] = []
        self._peers: Dict[str, _PeerState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # run every tick after the rollup and before the alerts (the
        # outcome aggregator's tick, which locks on its own)
        self._tick_hooks: List[Callable[[], None]] = []
        for key in ("fleet/snapshots_total", "fleet/bad_snapshots_total"):
            self._reg.counter(key)
        for key in ("fleet/peers", "fleet/peers_stale"):
            self._reg.gauge(key)
        for name in AGG_KEYS:
            self._reg.gauge(f"fleet/agg/{name}")
        self._engine = AlertEngine(rules=rules, registry=self._reg, emit=emit_event)

    # -- reader threads ---------------------------------------------------------

    def ingest(self, payload: Any, recv_ts: Optional[float] = None) -> bool:
        """Decode one metrics frame and park it; a bad one is counted and
        dropped."""
        snap = decode_snapshot(payload)
        if snap is None:
            self._reg.counter("fleet/bad_snapshots_total").inc()
            return False
        self._reg.counter("fleet/snapshots_total").inc()
        ts = time.monotonic() if recv_ts is None else recv_ts
        with self._lock:
            self._inbox.append((ts, snap))
        return True

    # -- the aggregator's thread ------------------------------------------------

    def add_tick_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` every tick (register before ``start``)."""
        self._tick_hooks.append(hook)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="fleet-aggregator", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def _run(self) -> None:
        import warnings

        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - the aggregation outlives a bad tick
                warnings.warn(f"fleet aggregator tick failed: {e}")

    def tick(self, now: Optional[float] = None) -> None:
        """One merge, rollup and alert pass."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            batch, self._inbox = self._inbox, []
        for recv_ts, snap in batch:
            self._merge(recv_ts, snap)
        self._rollup(now)
        for hook in self._tick_hooks:
            hook()
        counters, gauges = self._reg.counters_and_gauges()
        self._engine.evaluate({**counters, **gauges}, now)

    def _merge(self, recv_ts: float, snap: Dict[str, Any]) -> None:
        label = snap["peer"]
        st = self._peers.get(label)
        if st is None:
            st = self._peers[label] = _PeerState(snap["kind"])
        if st.pid != snap["pid"]:
            # a restarted peer: its totals start from zero again; the old
            # pid's are merged already
            st.pid = snap["pid"]
            st.last_raw = {}
            st.rate_samples.clear()
        st.last_seen = recv_ts
        for name, v in snap["counters"].items():
            prev = st.last_raw.get(name, 0.0)
            delta = v - prev if v >= prev else v   # a reset within one pid
            st.last_raw[name] = v
            st.totals[name] = st.totals.get(name, 0.0) + delta
            self._reg.counter(f"fleet/{label}/{name}").inc(delta)
        for name, v in snap["gauges"].items():
            st.gauges[name] = v
            self._reg.gauge(f"fleet/{label}/{name}").set(v)
        total = st.totals.get("actor/env_steps")
        if total is not None:
            st.rate_samples.append((recv_ts, total))
            while len(st.rate_samples) > 2 and recv_ts - st.rate_samples[0][0] > 4 * self.interval_s:
                st.rate_samples.popleft()
            t0, v0 = st.rate_samples[0]
            span = recv_ts - t0
            fps = (total - v0) / span if span > 0 else 0.0
            st.gauges["env_fps"] = fps
            self._reg.gauge(f"fleet/{label}/env_fps").set(fps)

    @staticmethod
    def _peer_metric(st: _PeerState, metric: str) -> Optional[float]:
        source, key = AGG_SOURCES[metric]
        if source == "gauge":
            return st.gauges.get(key)
        if source == "counter":
            return st.totals.get(key)
        return st.gauges.get(metric)   # "rate": the derived env_fps

    def _rollup(self, now: float) -> None:
        for label in [label for label, st in self._peers.items() if now - st.last_seen > self.forget_after_s]:
            del self._peers[label]
        live = [st for st in self._peers.values() if now - st.last_seen <= self.stale_after_s]
        self._reg.gauge("fleet/peers").set(float(len(live)))
        self._reg.gauge("fleet/peers_stale").set(float(len(self._peers) - len(live)))
        for metric in AGG_SOURCES:
            values = [v for st in live if (v := self._peer_metric(st, metric)) is not None]
            stats = (min(values), max(values), sum(values) / len(values)) if values else (0.0, 0.0, 0.0)
            for stat_name, v in zip(AGG_STATS, stats):
                self._reg.gauge(f"fleet/agg/{metric}/{stat_name}").set(v)

"""Runbook-encoded alert engine: a rule table over telemetry values.

Copy of ``AlertRule``, ``RULES``, ``ALERT_WAIVERS`` and ``AlertEngine``
from the reference's ``utils/alerts.py``, with the same rule names,
thresholds and runbook anchors (``rb:<name>``, rows of the "Failure modes"
table in ``docs/OPERATIONS.md``). The learner's ``FleetAggregator``
(``utils/fleet.py``) runs the engine over the learner's registry at its
cadence, and the router CLI over its own, so ``serve_peer_dead`` pages and
``sessions_rehomed_burst`` warns as ``ALERT`` lines in its metrics JSONL.
``ALERT_WAIVERS`` names each documented failure mode that has no rule, with
the reason, as a plain dict literal.

Rule predicates (``AlertRule.kind``):

* ``threshold``: compare the watched value against ``value`` with ``op``
  (``>``/``<``/``>=``/``<=``);
* ``rate``: rate of change of a monotone counter over ``window_s``
  seconds, compared ``> value`` per second (``value=0``: any increase);
* ``stale``: the watched key has not changed for more than ``value``
  seconds.

``for_s`` is the debounce: the condition must hold that long before the
alert fires; a firing alert resolves at the first evaluation where the
condition clears. ``key`` may be an ``fnmatch`` pattern, aggregated across
matching keys with ``agg`` (``max`` or ``sum``). A rule whose key has no
value in the snapshot is skipped, so rules over planes a process does not
run stay silent.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import time
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from dotaclient_tpu_torch.utils import telemetry

__all__ = ["ALERT_WAIVERS", "AlertRule", "AlertEngine", "RULES"]


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative runbook rule."""

    name: str              # stable id
    key: str               # registry key or fnmatch pattern it watches
    kind: str              # "threshold" | "rate" | "stale"
    value: float           # threshold level / rate-per-sec bound / stale seconds
    op: str = ">"          # threshold comparison
    window_s: float = 60.0   # rate-of-change lookback
    for_s: float = 0.0     # condition must hold this long before firing
    agg: str = "max"       # pattern-key aggregation: "max" | "sum"
    severity: str = "warn"   # "warn" | "page"
    runbook: str = ""      # mandatory `rb:<anchor>` in docs/OPERATIONS.md
    summary: str = ""


# The shipped rule table, row for row the reference's.
RULES: Tuple[AlertRule, ...] = (
    AlertRule(
        "weight_staleness_high", key="buffer/batch_staleness",
        kind="threshold", op=">", value=64.0, for_s=10.0, severity="warn",
        runbook="rb:staleness-spike",
        summary="consumed batches trained on weights > 64 versions old",
    ),
    AlertRule(
        "fleet_peer_stale", key="fleet/peers_stale",
        kind="threshold", op=">", value=0.0, for_s=0.0, severity="page",
        runbook="rb:fleet-peer-stale",
        summary="a fleet peer stopped reporting metric snapshots",
    ),
    AlertRule(
        "corrupt_frame_rate", key="transport/frames_corrupt_total",
        kind="rate", value=0.02, window_s=30.0, severity="warn",
        runbook="rb:corrupt-frames",
        summary="wire frames failing CRC faster than background rate",
    ),
    AlertRule(
        "peer_quarantined", key="transport/peers_quarantined",
        kind="rate", value=0.0, window_s=60.0, severity="page",
        runbook="rb:corrupt-frames",
        summary="a peer was quarantined for a poison-frame streak",
    ),
    AlertRule(
        "buffer_starved", key="buffer/occupancy",
        kind="threshold", op="<", value=0.02, for_s=60.0, severity="warn",
        runbook="rb:buffer-starvation",
        summary="trajectory ring near-empty: the learner is starved",
    ),
    AlertRule(
        "nonfinite_ingest", key="buffer/nonfinite_rejected_total",
        kind="rate", value=0.0, window_s=60.0, severity="warn",
        runbook="rb:nonfinite-payload",
        summary="actors shipping NaN/Inf payloads (admission rejecting)",
    ),
    AlertRule(
        "intbound_ingest", key="buffer/intbound_rejected_total",
        kind="rate", value=0.0, window_s=60.0, severity="warn",
        runbook="rb:intbound-reject",
        summary="f32-wire actor exceeding the narrow ring's int bounds",
    ),
    AlertRule(
        "stale_ingest_rejections", key="buffer/stale_rejected_total",
        kind="rate", value=0.5, window_s=30.0, severity="warn",
        runbook="rb:stale-rejection",
        summary="ingest rejecting over-stale frames faster than churn",
    ),
    AlertRule(
        "health_latched", key="health/nonfinite_steps_total",
        kind="rate", value=0.0, window_s=60.0, severity="page",
        runbook="rb:divergence",
        summary="the in-graph health probe flagged a non-finite step",
    ),
    AlertRule(
        "checkpoint_save_failures", key="checkpoint/save_failures_total",
        kind="rate", value=0.0, window_s=120.0, severity="page",
        runbook="rb:disk-full",
        summary="periodic checkpoint saves degrading (disk/permissions)",
    ),
    AlertRule(
        "manifest_failures", key="checkpoint/manifest_failures_total",
        kind="rate", value=0.0, window_s=120.0, severity="page",
        runbook="rb:corrupt-checkpoint",
        summary="checkpoint integrity manifests failing verification",
    ),
    AlertRule(
        "snapshot_errors", key="snapshot/errors_total",
        kind="rate", value=0.0, window_s=60.0, severity="warn",
        runbook="rb:snapshot-failures",
        summary="async snapshot jobs (publish/metrics) failing",
    ),
    AlertRule(
        "weights_publish_stalled", key="transport/weights_published",
        kind="stale", value=120.0, severity="warn",
        runbook="rb:snapshot-failures",
        summary="no weights publish reached the transport for 2 minutes",
    ),
    AlertRule(
        "trace_drops", key="trace/dropped_total",
        kind="rate", value=1.0, window_s=30.0, severity="warn",
        runbook="rb:trace-drops",
        summary="trace writer falling behind: events dropped",
    ),
    AlertRule(
        "serve_p99_over_budget", key="fleet/*/serve/p99_latency_ms",
        kind="threshold", op=">", value=100.0, agg="max", for_s=10.0,
        severity="warn", runbook="rb:serve-latency",
        summary="a serve peer's p99 reply latency exceeds the budget",
    ),
    AlertRule(
        "reconnect_storm", key="fleet/*/transport/reconnects_total",
        kind="rate", value=0.5, window_s=30.0, agg="sum", severity="warn",
        runbook="rb:learner-crash",
        summary="fleet-wide reconnect storm: actors losing the learner",
    ),
    # -- outcome attribution plane --
    AlertRule(
        "win_rate_collapse", key="outcome/win_rate/vs_scripted",
        kind="threshold", op="<", value=0.2, for_s=120.0, severity="page",
        runbook="rb:win-rate-collapse",
        summary="windowed win-rate vs scripted bots collapsed below 0.2",
    ),
    AlertRule(
        "episode_len_anomaly", key="outcome/episode_len_anomaly",
        kind="threshold", op=">", value=0.0, for_s=60.0, severity="warn",
        runbook="rb:episode-len-anomaly",
        summary="median episode length degenerate: envs are churn-resetting",
    ),
    AlertRule(
        "outcome_stream_stale", key="outcome/stream_age_s",
        kind="threshold", op=">", value=90.0, for_s=0.0, severity="warn",
        runbook="rb:outcome-stale",
        summary="no completed-episode outcome reached the learner for 90 s",
    ),
    # -- pipeline utilization plane --
    AlertRule(
        "learner_duty_cycle_low", key="util/duty_cycle",
        kind="threshold", op="<", value=0.1, for_s=120.0, severity="warn",
        runbook="rb:duty-cycle-low",
        summary="donated dispatch in flight under 10% of wall-clock",
    ),
    AlertRule(
        "throughput_regression", key="util/throughput_regression",
        kind="threshold", op=">", value=0.5, for_s=60.0, severity="warn",
        runbook="rb:throughput-regression",
        summary="learner steps/s EMA regressed below 0.7x its baseline",
    ),
    # -- serve-fleet failover (serve/router.py) --
    AlertRule(
        # zero in every healthy fleet: the router declares a backend dead
        # only after router_dead_after_s of refused reconnects
        "serve_peer_dead", key="router/backends_dead",
        kind="threshold", op=">", value=0.0, for_s=0.0, severity="page",
        runbook="rb:serve-peer-dead",
        summary="a serve backend is dead past the probe grace window",
    ),
    AlertRule(
        # every re-home is a state discontinuity for a live game
        "sessions_rehomed_burst", key="router/sessions_rehomed_total",
        kind="rate", value=0.0, window_s=60.0, severity="warn",
        runbook="rb:sessions-rehomed",
        summary="sessions re-homing off dead serve backends",
    ),
)


# Documented failure modes with no alert rule, by runbook anchor, each with
# the reason it is not watchable from a registry. A plain dict literal.
ALERT_WAIVERS: Dict[str, str] = {
    "rb:actor-death": (
        "supervisor-restarted churn is steady state; sustained silence "
        "pages via rb:fleet-peer-stale instead"
    ),
    "rb:graceful-drain": "clean-exit path; exit code is the signal",
    "rb:half-open-conn": (
        "idle drops auto-heal per connection; a fleet-wide stall also "
        "surfaces as rb:fleet-peer-stale silence"
    ),
    "rb:garbage-sender": (
        "covered by the rb:corrupt-frames rules (same counters)"
    ),
    "rb:crash-pending-snapshot": (
        "post-mortem signal read from the LAST line after death; nothing "
        "to watch while alive"
    ),
    "rb:stall-diagnostics": (
        "diagnostic gauge pair with no universal threshold; compared "
        "against bench stages by a human"
    ),
    "rb:advantage-speedup": (
        "bench-time capability gate; the runtime overlap fraction varies "
        "legitimately with consume patterns (serial consume-time passes "
        "are correct, just unoverlapped) — compared against bench stages "
        "by a human"
    ),
    "rb:divergence-exhausted": (
        "terminal non-zero exit is its own page; the precursor pages via "
        "rb:divergence"
    ),
    "rb:divergence-no-ckpt": (
        "config-time condition warned once at startup, not a runtime level"
    ),
    "rb:cross-process-latency": (
        "needs a traced run and trace_report's critical path; no single "
        "registry level encodes it"
    ),
    "rb:tpu-preflight": "startup tool (run_multichip.py), not a live signal",
    "rb:fused-lane-divisibility": (
        "construction-time ValueError before any compile; the process "
        "never reaches a runtime level to watch"
    ),
    "rb:serve-stuck-window": (
        "needs a cross-rate comparison (requests vs dispatches) the rule "
        "grammar deliberately excludes; p99 blowups page via "
        "rb:serve-latency"
    ),
    "rb:serve-version-skew": (
        "surfaces as the serve server's corrupt-frame/quarantine "
        "counters — rb:corrupt-frames covers the watchable half"
    ),
    "rb:serve-slots": (
        "capacity planning, not an incident: rejects are by design at "
        "the configured ceiling"
    ),
    "rb:lint-ci": "CI-time failure; never reachable from a running fleet",
    "rb:alerts-stuck": (
        "the alert plane cannot page on itself; operator row for reading "
        "alerts/active directly"
    ),
}


def _match_keys(pattern: str, snapshot: Mapping[str, float]) -> List[float]:
    return [v for k, v in snapshot.items() if v is not None and fnmatch.fnmatchcase(k, pattern)]


class _RuleState:
    __slots__ = ("since", "active", "samples", "last_value", "last_change")

    def __init__(self) -> None:
        self.since: Optional[float] = None       # condition-true start
        self.active = False
        self.samples: deque = deque()            # (t, value) for rate rules
        self.last_value: Optional[float] = None  # for stale rules
        self.last_change: Optional[float] = None


class AlertEngine:
    """Evaluate the rule table against registry snapshots.

    Single-threaded: ``evaluate`` runs on one thread (the router CLI's main
    loop). ``emit`` receives one dict per fire or resolve transition; the
    router CLI hands it ``JsonlSink.emit_event``."""

    def __init__(
        self,
        rules: Optional[Tuple[AlertRule, ...]] = None,
        registry: Optional[telemetry.Registry] = None,
        emit: Optional[Callable[[Dict[str, object]], None]] = None,
    ) -> None:
        self.rules = RULES if rules is None else tuple(rules)
        for rule in self.rules:
            if not rule.runbook.startswith("rb:"):
                raise ValueError(
                    f"alert rule {rule.name!r} has no OPERATIONS.md runbook anchor (rb:<name>): "
                    f"every rule must point operators at its triage row"
                )
        reg = registry if registry is not None else telemetry.get_registry()
        for key in ("alerts/fired_total", "alerts/resolved_total"):
            reg.counter(key)
        reg.gauge("alerts/active")
        self._reg = reg
        self._emit = emit
        self._state: Dict[str, _RuleState] = {rule.name: _RuleState() for rule in self.rules}

    # -- predicate plumbing ------------------------------------------------

    def _observe(self, rule: AlertRule, snapshot: Mapping[str, float]) -> Optional[float]:
        if "*" in rule.key or "?" in rule.key or "[" in rule.key:
            values = _match_keys(rule.key, snapshot)
            if not values:
                return None
            return sum(values) if rule.agg == "sum" else max(values)
        v = snapshot.get(rule.key)
        return None if v is None else float(v)

    def _condition(self, rule: AlertRule, st: _RuleState, value: float, now: float) -> bool:
        if rule.kind == "threshold":
            return {
                ">": value > rule.value,
                "<": value < rule.value,
                ">=": value >= rule.value,
                "<=": value <= rule.value,
            }[rule.op]
        if rule.kind == "rate":
            if st.samples and value < st.samples[-1][1]:
                st.samples.clear()  # counter reset: restart the window
            st.samples.append((now, value))
            while st.samples and now - st.samples[0][0] > rule.window_s:
                st.samples.popleft()
            if len(st.samples) < 2:
                return False
            t0, v0 = st.samples[0]
            span = now - t0
            return span > 0 and (value - v0) / span > rule.value
        if rule.kind == "stale":
            if st.last_value is None or value != st.last_value:
                st.last_value = value
                st.last_change = now
                return False
            return st.last_change is not None and now - st.last_change > rule.value
        raise ValueError(f"unknown alert rule kind {rule.kind!r}")

    # -- the evaluation tick -----------------------------------------------

    def evaluate(
        self,
        snapshot: Optional[Mapping[str, float]] = None,
        now: Optional[float] = None,
    ) -> Tuple[List[str], List[str]]:
        """One evaluation pass over ``snapshot`` (default: the registry's
        counters and gauges) at ``now`` (default: the monotonic clock);
        returns (fired rule names, resolved rule names)."""
        if snapshot is None:
            counters, gauges = self._reg.counters_and_gauges()
            snapshot = {**counters, **gauges}
        if now is None:
            now = time.monotonic()
        fired: List[str] = []
        resolved: List[str] = []
        active = 0
        for rule in self.rules:
            st = self._state[rule.name]
            value = self._observe(rule, snapshot)
            cond = self._condition(rule, st, value, now) if value is not None else False
            if cond:
                if st.since is None:
                    st.since = now
                if not st.active and now - st.since >= rule.for_s:
                    st.active = True
                    fired.append(rule.name)
                    self._reg.counter("alerts/fired_total").inc()
                    self._event(rule, "fired", value)
            else:
                st.since = None
                if st.active:
                    st.active = False
                    resolved.append(rule.name)
                    self._reg.counter("alerts/resolved_total").inc()
                    self._event(rule, "resolved", value)
            if st.active:
                active += 1
        self._reg.gauge("alerts/active").set(float(active))
        return fired, resolved

    def active_rules(self) -> List[str]:
        return [n for n, st in self._state.items() if st.active]

    def _event(self, rule: AlertRule, state: str, value: Optional[float]) -> None:
        if self._emit is None:
            return
        self._emit(
            {
                "event": "ALERT",
                "state": state,
                "rule": rule.name,
                "severity": rule.severity,
                "runbook": rule.runbook,
                "key": rule.key,
                "kind": rule.kind,
                "value": None if value is None else float(value),
                "threshold": rule.value,
                "summary": rule.summary,
            }
        )

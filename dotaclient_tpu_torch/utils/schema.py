"""The key tiers a run record must carry, and their check.

Copy of every tier tuple of ``scripts/check_telemetry_schema.py`` (the base
tier of a learner's ``--metrics-jsonl`` record; the snapshot, health,
trace, advantage, fleet, outcome, utilization, multichip and wire tiers
every port learner's record meets; the socket, shm and fault tiers of a
learner serving actor processes; the serve tier of a serve CLI's record and
the router tier of a router's), and of its ``validate_lines`` (a record of
a learner serving actor processes, marked by its transport server's
gauges, is not held to the keys only an in-process actor emits; a serve or
router record is held to ``base_required=()`` instead of the learner's
base tier). ``utils/check_telemetry_schema.py`` is the CLI over them, and
``chip_smoke.py`` checks records on the card with them.
``tests/test_torch_runrecord.py`` and ``tests/test_torch_multichip_tools.py``
hold these tuples equal to the script's. ``validate_lines(lines,
MULTICHIP_KEYS)`` is ``--require-multichip``; every port learner's record
meets it, at every world size.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

# the base tier: the learner pipeline's spans, gauges and counters
REQUIRED_KEYS = (
    "span/actor/collect/mean_s",
    "span/actor/drain/mean_s",
    "span/buffer/insert/mean_s",
    "span/buffer/sample/mean_s",
    "span/learner/dispatch/mean_s",
    "span/learner/metrics_fetch/mean_s",
    "span/transport/publish_weights/mean_s",
    "transport/queue_depth",
    "actor/weight_staleness",
    "buffer/occupancy",
    "learner/prefetch_hit_rate",
    "learner/overlap_fraction",
    "actor/frames_shipped",
    "actor/rollouts_shipped",
)

# the stat leaves every span timer carries
TIMER_LEAVES = (
    "count",
    "total_s",
    "last_s",
    "mean_s",
    "ema_s",
    "p95_s",
)

# --require-snapshot: the snapshot engine
SNAPSHOT_KEYS = (
    "snapshot/pending",
    "snapshot/d2h_ms",
    "learner/publish_stall_ms",
    "learner/stall_fraction",
)

# --require-health: the health guardian
HEALTH_KEYS = (
    "health/nonfinite_steps_total",
    "health/rollbacks_total",
    "health/last_good_step",
    "buffer/stale_rejected_total",
)

# --require-trace: the trace, compile and memory keys
TRACE_KEYS = (
    "trace/emitted_total",
    "trace/dropped_total",
    "compile/compiles_total",
    "compile/retraces_total",
    "compile/compile_time_s_total",
    "mem/hbm_peak_bytes",
)

# --require-advantage: the one-pass advantage plane
ADVANTAGE_KEYS = (
    "advantage/one_pass",
    "advantage/pass_ms",
    "advantage/overlap_fraction",
    "advantage/passes_total",
)

# --require-fleet: the fleet aggregator's rollups and the alert engine
FLEET_KEYS = (
    "fleet/peers",
    "fleet/peers_stale",
    "fleet/snapshots_total",
    "fleet/bad_snapshots_total",
    "fleet/agg/weight_staleness/min",
    "fleet/agg/weight_staleness/max",
    "fleet/agg/weight_staleness/mean",
    "fleet/agg/env_fps/min",
    "fleet/agg/env_fps/max",
    "fleet/agg/env_fps/mean",
    "fleet/agg/reconnects/min",
    "fleet/agg/reconnects/max",
    "fleet/agg/reconnects/mean",
    "fleet/agg/corrupt_frames/min",
    "fleet/agg/corrupt_frames/max",
    "fleet/agg/corrupt_frames/mean",
    "fleet/agg/ship_wait/min",
    "fleet/agg/ship_wait/max",
    "fleet/agg/ship_wait/mean",
    "alerts/fired_total",
    "alerts/resolved_total",
    "alerts/active",
)

# --require-outcome: the outcome curves and the actor-side counters
OUTCOME_KEYS = (
    "outcome/win_rate/vs_scripted",
    "outcome/win_rate/vs_league",
    "outcome/win_rate/overall",
    "outcome/episode_len_p50",
    "outcome/episode_len_anomaly",
    "outcome/stream_age_s",
    "outcome/episodes_total",
    "outcome/episodes_recent",
    "outcome/reward/xp",
    "outcome/reward/gold",
    "outcome/reward/hp",
    "outcome/reward/enemy_hp",
    "outcome/reward/last_hits",
    "outcome/reward/denies",
    "outcome/reward/kills",
    "outcome/reward/deaths",
    "outcome/reward/tower_damage",
    "outcome/reward/own_tower",
    "outcome/reward/win",
    "outcome/episodes/vs_scripted",
    "outcome/episodes/vs_league",
    "outcome/episodes/vs_selfplay",
    "outcome/wins/vs_scripted",
    "outcome/wins/vs_league",
    "outcome/wins/vs_selfplay",
    "outcome/episodes_side/radiant",
    "outcome/episodes_side/dire",
    "outcome/ep_len_sum",
    "outcome/ep_len_hist/00",
    "outcome/ep_len_hist/01",
    "outcome/ep_len_hist/02",
    "outcome/ep_len_hist/03",
    "outcome/ep_len_hist/04",
    "outcome/ep_len_hist/05",
    "outcome/ep_len_hist/06",
    "outcome/ep_len_hist/07",
    "outcome/ep_len_hist/08",
    "outcome/ep_len_hist/09",
    "outcome/ep_len_hist/10",
    "outcome/ep_len_hist/11",
    "outcome/reward_sum/xp",
    "outcome/reward_sum/gold",
    "outcome/reward_sum/hp",
    "outcome/reward_sum/enemy_hp",
    "outcome/reward_sum/last_hits",
    "outcome/reward_sum/denies",
    "outcome/reward_sum/kills",
    "outcome/reward_sum/deaths",
    "outcome/reward_sum/tower_damage",
    "outcome/reward_sum/own_tower",
    "outcome/reward_sum/win",
)

# --require-utilization: the learner's utilization plane
UTILIZATION_KEYS = (
    "util/armed",
    "util/duty_cycle",
    "util/steps_per_sec_ema",
    "util/steps_per_sec_baseline",
    "util/throughput_regression",
    "util/phase/dispatch_inflight",
    "util/phase/ingest_wait",
    "util/phase/gather",
    "util/phase/advantage_pass",
    "util/phase/publish_stall",
    "util/phase/checkpoint_stall",
    "util/phase/host_other",
)

# --require-multichip: the mesh's geometry, the lane split, the ring's
# resident bytes a rank and the startup all-reduce probe
MULTICHIP_KEYS = (
    "mesh/n_devices",
    "mesh/data_shards",
    "mesh/lane_shards",
    "fused/lanes_per_shard",
    "buffer/shard_bytes",
    "learner/psum_ms",
)

# --require-transport: the socket server's fanout (made at construction)
SOCKET_TRANSPORT_KEYS = (
    "transport/weights_coalesced",
    "transport/fanout_conns_dropped",
    "transport/weights_sent",
    "transport/fanout_lag_max",
    "transport/fanout_queue_depth",
    "transport/actors_connected",
)

# --require-shm: the shared-memory lane (made at construction)
SHM_TRANSPORT_KEYS = (
    "shm/ring_occupancy",
    "shm/ring_dropped_total",
    "transport/queue_depth",
)

# --require-faults: a socket learner with a checkpoint directory (the
# counters made at construction; 0 in a run that saw no fault)
FAULT_KEYS = (
    "transport/frames_corrupt_total",
    "transport/peers_quarantined",
    "transport/conn_idle_drops",
    "transport/heartbeats_sent",
    "transport/reader_exits",
    "checkpoint/save_failures_total",
)

# --require-serve: a serve CLI's record (--serve-metrics-jsonl); the engine
# and the server make every key at construction
SERVE_KEYS = (
    "serve/requests_total",
    "serve/batch_fill",
    "serve/batch_window_hits",
    "serve/p99_latency_ms",
    "serve/weights_version",
    "serve/dispatches_total",
    "serve/max_batch_hits",
    "serve/weight_swaps_total",
    "serve/dispatch_errors_total",
    "serve/replies_total",
    "serve/reply_errors_total",
    "serve/clients_connected",
    "serve/slots_in_use",
    "serve/conns_rejected_total",
    "serve/carry_installs_total",
)

# --require-router: a router's record (--metrics-jsonl); the router makes
# every key at construction (the per-backend router/backend/<i>/sessions
# are dynamic and not in the tier)
ROUTER_KEYS = (
    "router/sessions_attached_total",
    "router/sessions_detached_total",
    "router/sessions_rehomed_total",
    "router/carry_resets_total",
    "router/spares_promoted_total",
    "router/backend_deaths_total",
    "router/probe_reconnects_total",
    "router/route_requests_total",
    "router/route_errors_total",
    "router/backends_live",
    "router/backends_dead",
    "router/spares_available",
    "router/sessions_active",
)

# the wire tier: a socket or shm learner's rollout bytes, at their full
# width, and the ratio (both servers make them at construction, the gauge
# at 1.0)
WIRE_KEYS = (
    "transport/rollout_bytes_total",
    "transport/rollout_raw_bytes_total",
    "transport/rollout_compression_ratio",
)

# keys only an in-process actor emits, waived for a record that carries an
# external transport's marker
IN_PROC_ACTOR_KEYS = (
    "span/actor/collect/mean_s",
    "span/actor/drain/mean_s",
    "actor/frames_shipped",
    "actor/rollouts_shipped",
)
EXTERNAL_TRANSPORT_MARKERS = (
    "transport/actors_connected",
    "shm/ring_occupancy",
)

# every tier a port learner's record meets
LEARNER_TIERS = (SNAPSHOT_KEYS + HEALTH_KEYS + TRACE_KEYS + ADVANTAGE_KEYS + FLEET_KEYS + OUTCOME_KEYS
                 + UTILIZATION_KEYS + MULTICHIP_KEYS)


def validate_lines(lines: Sequence[str], extra_required: tuple = (),
                   base_required: Optional[tuple] = None) -> List[str]:
    """The violations of a record's lines (empty when the schema holds):
    each line's envelope ``{"ts": number, "step": int >= 0, "scalars":
    {str: number | null}}`` (event lines skipped), the union of the
    scalars' keys against the base tier (``REQUIRED_KEYS``, or
    ``base_required`` for another process class's record) and
    ``extra_required``, and every span timer's full set of stat leaves."""
    if not lines:
        return ["JSONL file is empty: no metrics were emitted"]
    errors: List[str] = []
    union: Dict[str, object] = {}
    for i, raw in enumerate(lines, 1):
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: not valid JSON ({e})")
            continue
        if not isinstance(obj, dict):
            errors.append(f"line {i}: top level is {type(obj).__name__}, not object")
            continue
        if "event" in obj:
            continue   # the structured event channel (ALERT lines)
        if not isinstance(obj.get("ts"), (int, float)):
            errors.append(f"line {i}: missing/invalid 'ts'")
        if not isinstance(obj.get("step"), int) or obj.get("step", -1) < 0:
            errors.append(f"line {i}: missing/invalid 'step'")
        scalars = obj.get("scalars")
        if not isinstance(scalars, dict):
            errors.append(f"line {i}: missing/invalid 'scalars'")
            continue
        for k, v in scalars.items():
            if v is not None and not isinstance(v, (int, float)):
                errors.append(f"line {i}: scalar {k!r} is {type(v).__name__}")
        union.update(scalars)
    required = (*(REQUIRED_KEYS if base_required is None else base_required), *extra_required)
    if any(m in union for m in EXTERNAL_TRANSPORT_MARKERS):
        required = tuple(k for k in required if k not in IN_PROC_ACTOR_KEYS)
    missing = [k for k in required if k not in union]
    if missing:
        errors.append("required telemetry keys never emitted: " + ", ".join(missing))
    roots = {k.rsplit("/", 1)[0] for k in union if k.startswith("span/") and k.rsplit("/", 1)[1] in TIMER_LEAVES}
    for root in sorted(roots):
        for leaf in TIMER_LEAVES:
            if f"{root}/{leaf}" not in union:
                errors.append(f"timer {root!r} missing stat leaf {leaf!r}")
    return errors

"""Run-status console: the fleet in one screen, from a learner's (or the router's) run record.

Copy of ``scripts/fleet_status.py`` over the port's torn-line-tolerant
reader (``utils/telemetry.py`` ``load_jsonl``, ``scan_metrics``), so a run on the card is read
without the script, which loads the JAX package's telemetry module. From the
metrics lines the fleet aggregator's ``fleet/`` keys ride, and the ``ALERT``
event lines of the alert engine, it renders:

* the **fleet table**: one row a reporting peer (actors ``aN``, serve
  ``sN``) with env steps/s, weights staleness, reconnects, corrupt frames,
  rollouts shipped and serve p99, and the min/max/mean rows;
* the **outcome panel**: the win rates, episodes and the stream's age;
* the **utilization panel**: the learner's duty cycle, its top three
  phases and the throughput sentinel;
* the **router panel** (only when the stream carries ``router/*``):
  backends live and dead, spares, sessions a backend, re-homes, promotions;
* the **alert board**: every alert fired and not resolved, with its
  severity and runbook anchor;
* a ``FLEET_STATUS {json}`` line.

One-shot by default; ``--follow`` re-reads the live file every
``--interval`` seconds (a torn last line is dropped, so a killed learner's
record reads too). It imports neither torch nor the rest of the package::

    python -m dotaclient_tpu_torch.utils.fleet_status RUN/learner.jsonl [--follow]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.utils.telemetry import load_jsonl, scan_metrics

# the fleet table's columns: label -> the key under fleet/<peer>/
_COLUMNS = (
    ("fps", "env_fps"),
    ("staleness", "actor/weight_refresh_lag"),
    ("reconnects", "transport/reconnects_total"),
    ("corrupt", "transport/frames_corrupt_total"),
    ("rollouts", "actor/rollouts_shipped"),
    ("p99_ms", "serve/p99_latency_ms"),
)
# the aggregate rows: the column's key -> the fleet/agg/<metric>/<stat> metric
_AGG = {
    "env_fps": "env_fps",
    "actor/weight_refresh_lag": "weight_staleness",
    "transport/reconnects_total": "reconnects",
    "transport/frames_corrupt_total": "corrupt_frames",
}
_RESERVED_SEGMENTS = {"agg", "peers", "peers_stale", "snapshots_total", "bad_snapshots_total"}


def parse_stream(lines: List[str]) -> Tuple[Dict[str, float], List[dict], Optional[float], Optional[int]]:
    """-> (the latest union of numeric scalars, the ALERT events in order,
    the last numeric ``ts``, the last step)."""
    scan = scan_metrics(lines)
    return scan.union, [ev for ev in scan.events if ev.get("event") == "ALERT"], scan.last_ts, scan.last_step


def active_alerts(events: List[dict]) -> List[dict]:
    """Replay the fired and resolved transitions: what remains is active."""
    active: Dict[str, dict] = {}
    for ev in events:
        rule = ev.get("rule")
        if not isinstance(rule, str):
            continue
        if ev.get("state") == "fired":
            active[rule] = ev
        elif ev.get("state") == "resolved":
            active.pop(rule, None)
    return list(active.values())


def fleet_peers(scalars: Dict[str, float]) -> List[str]:
    peers = set()
    for key in scalars:
        if key.startswith("fleet/"):
            seg = key.split("/", 2)[1]
            if seg and seg not in _RESERVED_SEGMENTS:
                peers.add(seg)
    return sorted(peers)


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.2f}"


def _table(rows: List[List[str]]) -> List[str]:
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    out = []
    for i, row in enumerate(rows):
        out.append("  ".join(cell.ljust(widths[c]) for c, cell in enumerate(row)))
        if i == 0:
            out.append("  ".join("-" * w for w in widths))
    return out


def render(scalars: Dict[str, float], events: List[dict], last_ts: Optional[float],
           last_step: Optional[int]) -> Tuple[str, dict]:
    """-> (the console text, the ``FLEET_STATUS`` dict)."""
    g = scalars.get
    peers = fleet_peers(scalars)
    actives = active_alerts(events)
    age = f"{time.time() - last_ts:.0f}s ago" if last_ts else "n/a"
    n_live, n_stale = g("fleet/peers", 0.0), g("fleet/peers_stale", 0.0)
    lines = [
        f"== fleet status @ step {last_step if last_step is not None else '?'} (last metrics line {age}) ==",
        f"peers: {int(n_live)} reporting, {int(n_stale)} stale | snapshots merged: "
        f"{int(g('fleet/snapshots_total', 0))} (bad: {int(g('fleet/bad_snapshots_total', 0))})",
    ]
    rows = [["peer"] + [label for label, _ in _COLUMNS]]
    rows += [[peer] + [_fmt(g(f"fleet/{peer}/{suffix}")) for _, suffix in _COLUMNS] for peer in peers]
    for stat in ("min", "max", "mean"):
        rows.append([f"agg/{stat}"] + [
            _fmt(g(f"fleet/agg/{_AGG[suffix]}/{stat}") if suffix in _AGG else None) for _, suffix in _COLUMNS])
    lines += _table(rows)
    # the outcome panel: is the policy winning, against whom, and is the stream alive
    stream_age = g("outcome/stream_age_s", -1.0)
    lines.append(f"outcome: win_rate vs_scripted {_fmt(g('outcome/win_rate/vs_scripted'))} | vs_league "
                 f"{_fmt(g('outcome/win_rate/vs_league'))} | overall {_fmt(g('outcome/win_rate/overall'))}")
    lines.append(f"         episodes {int(g('outcome/episodes_total', 0))} "
                 f"({int(g('outcome/episodes_recent', 0))} in window) | "
                 f"ep_len p50 {_fmt(g('outcome/episode_len_p50'))} | stream "
                 + ("unarmed" if stream_age is None or stream_age < 0 else f"{stream_age:.0f}s since last episode"))
    # the utilization panel: the duty cycle, the top stall phases, the sentinel
    util_armed = g("util/armed", 0.0)
    if util_armed:
        top_phases = sorted(((k.rsplit("/", 1)[1], v) for k, v in scalars.items() if k.startswith("util/phase/")),
                            key=lambda kv: -kv[1])[:3]
        regression = g("util/throughput_regression", 0.0)
        lines.append(f"util: duty_cycle {_fmt(g('util/duty_cycle'))} | "
                     + " | ".join(f"{name} {frac:.2f}" for name, frac in top_phases))
        lines.append(f"      steps/s ema {_fmt(g('util/steps_per_sec_ema'))} (baseline "
                     f"{_fmt(g('util/steps_per_sec_baseline'))}) | sentinel " + ("REGRESSED" if regression else "ok"))
    else:
        lines.append("util: unarmed (no fold yet)")
    # the router panel, only where the stream carries router/* keys
    has_router = any(k.startswith("router/") for k in scalars)
    per_backend = sorted((k.split("/")[2], int(v)) for k, v in scalars.items()
                         if k.startswith("router/backend/") and k.endswith("/sessions"))
    if has_router:
        lines.append(f"router: backends {int(g('router/backends_live', 0))} live / "
                     f"{int(g('router/backends_dead', 0))} dead | spares {int(g('router/spares_available', 0))} | "
                     f"sessions {int(g('router/sessions_active', 0))} active"
                     + (" (" + " ".join(f"b{i}={n}" for i, n in per_backend) + ")" if per_backend else ""))
        lines.append(f"        rehomed {int(g('router/sessions_rehomed_total', 0))} (carry_resets "
                     f"{int(g('router/carry_resets_total', 0))}) | promoted "
                     f"{int(g('router/spares_promoted_total', 0))} | deaths "
                     f"{int(g('router/backend_deaths_total', 0))} | probe_reconnects "
                     f"{int(g('router/probe_reconnects_total', 0))}")
    fired_total = g("alerts/fired_total", 0.0)
    lines.append(f"alerts: {len(actives)} active, {int(fired_total)} fired this run")
    for ev in actives:
        lines.append(f"  [{ev.get('severity', '?').upper():4s}] {ev.get('rule')}: {ev.get('summary', '')} "
                     f"(runbook {ev.get('runbook')}, value {_fmt(ev.get('value'))} vs {_fmt(ev.get('threshold'))})")
    router_keys = ("backends_live", "backends_dead", "spares_available", "sessions_active", "sessions_rehomed_total",
                   "spares_promoted_total", "backend_deaths_total")
    summary = {
        "step": last_step,
        "outcome": {
            "win_rate_vs_scripted": g("outcome/win_rate/vs_scripted"),
            "win_rate_vs_league": g("outcome/win_rate/vs_league"),
            "win_rate_overall": g("outcome/win_rate/overall"),
            "episodes_total": int(g("outcome/episodes_total", 0)),
            "episode_len_p50": g("outcome/episode_len_p50"),
            "stream_age_s": g("outcome/stream_age_s"),
        },
        "util": {
            "armed": bool(util_armed),
            "duty_cycle": g("util/duty_cycle"),
            "steps_per_sec_ema": g("util/steps_per_sec_ema"),
            "throughput_regression": bool(g("util/throughput_regression", 0.0)),
        },
        "router": ({**{k: int(g(f"router/{k}", 0)) for k in router_keys}, "backend_sessions": dict(per_backend)}
                   if has_router else None),
        "peers": peers,
        "n_peers": int(n_live),
        "peers_stale": int(n_stale),
        "snapshots_total": int(g("fleet/snapshots_total", 0)),
        "active_alerts": [{"rule": ev.get("rule"), "severity": ev.get("severity"), "runbook": ev.get("runbook")}
                          for ev in actives],
        "alerts_fired_total": int(fired_total),
        "ok": n_stale == 0 and not any(ev.get("severity") == "page" for ev in actives),
    }
    return "\n".join(lines), summary


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a learner's --metrics-jsonl file")
    p.add_argument("--follow", action="store_true",
                   help="re-read and re-render every --interval seconds until interrupted")
    p.add_argument("--interval", type=float, default=2.0)
    args = p.parse_args(argv)
    while True:
        try:
            lines = load_jsonl(args.path)
        except OSError as e:
            print(f"fleet_status: cannot read {args.path}: {e}", file=sys.stderr)
            return 1
        text, summary = render(*parse_stream(lines))
        print(text, flush=True)
        print("FLEET_STATUS " + json.dumps(summary, sort_keys=True), flush=True)
        if not args.follow:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
        print(flush=True)


if __name__ == "__main__":
    sys.exit(main())

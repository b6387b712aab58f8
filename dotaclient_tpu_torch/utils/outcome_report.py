"""Outcome report: win-rate curves and the per-opponent table of a learner's run record.

Copy of ``scripts/outcome_report.py`` over the port's torn-line-tolerant
reader (``utils/telemetry.py`` ``load_jsonl``, ``scan_metrics``), so a run on the card is read
without the script, which loads the JAX package's telemetry module. From a
learner's ``--metrics-jsonl`` it renders:

* **curves**: the windowed ``outcome/win_rate/{vs_scripted,vs_league,
  overall}`` gauges across log boundaries, as sparklines with the latest
  values;
* the **per-opponent table**: lifetime episodes, wins and win rate per
  opponent bucket, from the learner's outcome counters plus every
  ``fleet/<peer>/outcome/...`` mirror external actors shipped;
* the **game-quality row**: the windowed episode-length p50, the stream's
  age and the per-episode reward decomposition by shaping term;
* an ``OUTCOME_STATUS {json}`` line (the chaos supervisor reads it).

It imports neither torch nor the rest of the package. Usage::

    python -m dotaclient_tpu_torch.utils.outcome_report RUN/learner.jsonl [--points 60]

Exit 0 when the record holds curves with episodes, else 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.utils.telemetry import load_jsonl, scan_metrics

BUCKETS = ("vs_scripted", "vs_league", "vs_selfplay")
RATE_KEYS = (
    ("vs_scripted", "outcome/win_rate/vs_scripted"),
    ("vs_league", "outcome/win_rate/vs_league"),
    ("overall", "outcome/win_rate/overall"),
)
REWARD_TERMS = ("xp", "gold", "hp", "enemy_hp", "last_hits", "denies", "kills", "deaths", "tower_damage",
                "own_tower", "win")
# the outcome counter families; gauges share the namespace and are not summed
COUNTER_FAMILIES = ("episodes", "wins", "episodes_side", "ep_len_sum", "ep_len_hist", "reward_sum")
_SPARK = "▁▂▃▄▅▆▇█"


def parse_stream(lines: List[str]) -> Tuple[List[Tuple[int, Dict[str, float]]], Dict[str, float], Optional[float]]:
    """-> ([(step, numeric scalars) a metrics line], the latest union of
    them, the last numeric ``ts``). Event lines and torn lines are skipped."""
    scan = scan_metrics(lines)
    return scan.points, scan.union, scan.last_ts


def outcome_totals(scalars: Dict[str, float]) -> Dict[str, float]:
    """The learner's own outcome counters plus every fleet peer's mirror,
    summed by ``outcome/...`` name."""
    totals: Dict[str, float] = {}
    for name, v in scalars.items():
        if name.startswith("outcome/"):
            if name.split("/", 2)[1] in COUNTER_FAMILIES:
                totals[name] = totals.get(name, 0.0) + v
        elif name.startswith("fleet/") and "/outcome/" in name:
            key = "outcome/" + name.split("/outcome/", 1)[1]
            totals[key] = totals.get(key, 0.0) + v
    return totals


def sparkline(values: List[float]) -> str:
    if not values:
        return "(no data)"
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _SPARK[3] * len(values)
    return "".join(_SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)), len(_SPARK) - 1)] for v in values)


def _fmt(v: Optional[float], digits: int = 3) -> str:
    return "-" if v is None else f"{v:.{digits}f}"


def render(points: List[Tuple[int, Dict[str, float]]], union: Dict[str, float], last_ts: Optional[float],
           n_points: int) -> Tuple[str, dict]:
    """-> (the console text, the ``OUTCOME_STATUS`` dict)."""
    lines: List[str] = []
    age = f"{time.time() - last_ts:.0f}s ago" if last_ts else "n/a"
    last_step = points[-1][0] if points else None
    lines.append(f"== outcome report @ step {last_step if points else '?'} (last metrics line {age}) ==")
    # the curve's points: log boundaries at which the plane had any episode
    curve_pts = [(step, sc) for step, sc in points if sc.get("outcome/episodes_total", 0.0) > 0]
    lines.append(f"win-rate curves ({len(curve_pts)} points with episode data, last {n_points} shown):")
    for label, key in RATE_KEYS:
        vals = [sc[key] for _, sc in curve_pts[-n_points:] if key in sc]
        lines.append(f"  {label:12s} {sparkline(vals)}  latest {_fmt(union.get(key))}")
    totals = outcome_totals(union)
    total_eps = sum(totals.get(f"outcome/episodes/{b}", 0.0) for b in BUCKETS)
    lines.append("per-opponent table (lifetime, all sources):")
    rows = [["opponent", "episodes", "wins", "win_rate"]]
    for bucket in BUCKETS:
        eps = totals.get(f"outcome/episodes/{bucket}", 0.0)
        wins = totals.get(f"outcome/wins/{bucket}", 0.0)
        rows.append([bucket, f"{eps:.0f}", f"{wins:.0f}", _fmt(wins / eps if eps else None)])
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    for i, row in enumerate(rows):
        lines.append("  " + "  ".join(c.ljust(widths[j]) for j, c in enumerate(row)))
        if i == 0:
            lines.append("  " + "  ".join("-" * w for w in widths))
    p50 = union.get("outcome/episode_len_p50")
    stream_age = union.get("outcome/stream_age_s", -1.0)
    mean_len = totals.get("outcome/ep_len_sum", 0.0) / total_eps if total_eps else None
    stream = "unarmed" if stream_age is None or stream_age < 0 else f"{stream_age:.0f}s since last episode"
    lines.append(f"game quality: ep_len p50 {_fmt(p50, 1)} env steps | mean len {_fmt(mean_len, 1)} | stream {stream}")
    terms = {term: union.get(f"outcome/reward/{term}") for term in REWARD_TERMS}
    shown = {t: round(v, 4) for t, v in terms.items() if v is not None and v != 0}
    lines.append("reward decomposition (windowed per-episode means): "
                 + (" ".join(f"{t}={v:+.3f}" for t, v in shown.items()) if shown else "(no data)"))
    status = {
        "ok": bool(curve_pts) and total_eps > 0,
        "step": last_step,
        "curve_points": len(curve_pts),
        "episodes_total": total_eps,
        "win_rate_vs_scripted": union.get("outcome/win_rate/vs_scripted"),
        "win_rate_vs_league": union.get("outcome/win_rate/vs_league"),
        "win_rate_overall": union.get("outcome/win_rate/overall"),
        "episode_len_p50": p50,
        "stream_age_s": stream_age,
        "buckets": {b: {"episodes": totals.get(f"outcome/episodes/{b}", 0.0),
                        "wins": totals.get(f"outcome/wins/{b}", 0.0)} for b in BUCKETS},
        "reward_terms": shown,
    }
    return "\n".join(lines), status


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a learner's --metrics-jsonl file")
    p.add_argument("--points", type=int, default=40, help="sparkline tail length (curve points shown per bucket)")
    args = p.parse_args(argv)
    try:
        lines = load_jsonl(args.path)
    except OSError as e:
        print(f"outcome_report: cannot read {args.path}: {e}", file=sys.stderr)
        return 1
    text, status = render(*parse_stream(lines), args.points)
    print(text, flush=True)
    print("OUTCOME_STATUS " + json.dumps(status, sort_keys=True), flush=True)
    return 0 if status["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

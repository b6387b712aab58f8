"""Utilization report: where each process of a run spends its wall clock, from a learner's run record.

Copy of ``scripts/utilization_report.py`` over the port's torn-line-tolerant
reader (``utils/telemetry.py`` ``load_jsonl``, ``scan_metrics``), so a run on the card is read
without the script, which loads the JAX package's telemetry module. From a
learner's ``--metrics-jsonl`` it renders:

* the **learner row**: its duty cycle and the closed learner phase set
  (``util/phase/*``) as an attribution row;
* **peer rows**: every fleet peer that shipped ``util/actor/*`` or
  ``util/serve/*`` fractions on its snapshots (``fleet/<peer>/util/...``);
* the **sentinel row**: the steps/s fast EMA against the warm-up baseline,
  and whether the ``throughput_regression`` latch is up;
* a ``UTILIZATION_STATUS {json}`` line.

It imports neither torch nor the rest of the package. Usage::

    python -m dotaclient_tpu_torch.utils.utilization_report RUN/learner.jsonl

Exit 0 iff the plane is armed, the learner row folded and the sentinel not
latched.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.utils.telemetry import load_jsonl, scan_metrics

# utils/utilization.py's phase sets, repeated so the report never imports torch
LEARNER_PHASES = ("dispatch_inflight", "ingest_wait", "gather", "advantage_pass", "publish_stall",
                  "checkpoint_stall", "host_other")
ACTOR_PHASES = ("env_step", "featurize", "encode", "ship_wait", "other")
SERVE_PHASES = ("window_wait", "dispatch", "reply", "other")


def parse_stream(lines: List[str]) -> Tuple[Dict[str, float], Optional[float], Optional[int]]:
    """-> (the latest union of the metrics lines' numeric scalars, the last
    numeric ``ts``, the last step)."""
    scan = scan_metrics(lines)
    return scan.union, scan.last_ts, scan.last_step


def _phase_row(scalars: Dict[str, float], prefix: str, phases: Tuple[str, ...]) -> Optional[Dict[str, float]]:
    """The phase fractions under ``prefix``; None until one is nonzero (the
    eager zeros mean not folded yet)."""
    row = {p: scalars.get(f"{prefix}{p}", 0.0) for p in phases}
    return row if any(v > 0.0 for v in row.values()) else None


def peer_rows(scalars: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``fleet/<peer>/util/{actor,serve}/<phase>`` mirrors -> one row a peer
    that shipped any fraction."""
    rows: Dict[str, Dict[str, float]] = {}
    for kind, phases in (("actor", ACTOR_PHASES), ("serve", SERVE_PHASES)):
        marker = f"/util/{kind}/"
        peers = {key.split("/", 2)[1] for key in scalars if key.startswith("fleet/") and marker in key}
        for peer in peers:
            row = _phase_row(scalars, f"fleet/{peer}/util/{kind}/", phases)
            if row is not None:
                rows[peer] = row
    return rows


def _fmt(v: Optional[float], digits: int = 3) -> str:
    return "-" if v is None else f"{v:.{digits}f}"


def render(scalars: Dict[str, float], last_ts: Optional[float], last_step: Optional[int]) -> Tuple[str, dict]:
    """-> (the console text, the ``UTILIZATION_STATUS`` dict)."""
    lines: List[str] = []
    age = f"{time.time() - last_ts:.0f}s ago" if last_ts else "n/a"
    lines.append(f"== utilization report @ step {last_step if last_step is not None else '?'} "
                 f"(last metrics line {age}) ==")
    armed = scalars.get("util/armed", 0.0) > 0.0
    duty = scalars.get("util/duty_cycle")
    learner_row = _phase_row(scalars, "util/phase/", LEARNER_PHASES)
    peers = peer_rows(scalars)
    # one row a process, one column a phase of the three sets' union
    all_phases: List[str] = list(LEARNER_PHASES)
    for p in ACTOR_PHASES + SERVE_PHASES:
        if p not in all_phases:
            all_phases.append(p)
    table_rows = ([("learner", learner_row)] if learner_row is not None else []) + [
        (peer, peers[peer]) for peer in sorted(peers)]
    if table_rows:
        used = [p for p in all_phases if any(p in row for _, row in table_rows)]
        header = ["process"] + used
        rows = [header] + [[name] + [f"{row[p]:.3f}" if p in row else "-" for p in used] for name, row in table_rows]
        widths = [max(len(r[c]) for r in rows) for c in range(len(header))]
        for i, row in enumerate(rows):
            lines.append("  ".join(c.ljust(widths[j]) for j, c in enumerate(row)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
    else:
        lines.append("no phase attribution yet (plane " + ("armed but not folded" if armed else "unarmed") + ")")
    ema = scalars.get("util/steps_per_sec_ema")
    baseline = scalars.get("util/steps_per_sec_baseline")
    regression = scalars.get("util/throughput_regression", 0.0) > 0.0
    lines.append(f"duty cycle {_fmt(duty)} | steps/s ema {_fmt(ema)} (baseline {_fmt(baseline)}) | sentinel "
                 + ("REGRESSED" if regression else "ok"))
    status = {
        "ok": armed and learner_row is not None and not regression,
        "armed": armed,
        "step": last_step,
        "duty_cycle": duty,
        "steps_per_sec_ema": ema,
        "steps_per_sec_baseline": baseline,
        "throughput_regression": regression,
        "phases": learner_row or {},
        "peers": peers,
    }
    return "\n".join(lines), status


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a learner's --metrics-jsonl file")
    args = p.parse_args(argv)
    try:
        lines = load_jsonl(args.path)
    except OSError as e:
        print(f"utilization_report: cannot read {args.path}: {e}", file=sys.stderr)
        return 1
    text, status = render(*parse_stream(lines))
    print(text, flush=True)
    print("UTILIZATION_STATUS " + json.dumps(status, sort_keys=True), flush=True)
    return 0 if status["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Cross-record trajectory of the port's bench lines.

Counterpart of the reference's ``scripts/bench_trajectory.py``, for the
records of ``python -m dotaclient_tpu_torch.bench`` (its JSON line saved as
``BENCH_*.json`` in a directory of the caller's: the port keeps none at the
repo's root). A record's headline frames/s means something only beside a
record of the same card, so the tool:

* reads each record's card fingerprint (``host``: platform, device name and
  count, power limit, torch and CUDA versions) with its headline and stage
  numbers, in both historical shapes (the flat line, and a wrapper whose
  ``parsed`` holds the line);
* compares absolute headline numbers only between records of the same
  fingerprint, and the within-run ratios (speedups, overheads,
  recoveries, parities) across every record that carries them;
* prints a table and one ``BENCH_TRAJECTORY`` JSON line.

A record that is not the port's (its ``host`` names no torch: the repo's own
``BENCH_*.json`` are the JAX package's runs) is counted with the unreadable
ones and compared with nothing.

Usage:
    python -m dotaclient_tpu_torch.utils.bench_trajectory --dir DIR [--gate [--tolerance 0.05]]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

# Stage keys that are within-run ratios or fractions: dimensionless, so
# comparable across unlike cards (absolute *_fps / *_ms stages are not);
# the ``stages`` keys of the port's bench line.
RATIO_STAGES = (
    "stall_sync_recovery",
    "stall_async_recovery",
    "health_overhead",
    "trace_overhead",
    "fleet_overhead",
    "outcome_overhead",
    "rollout_compression",
    "quantize_optimizer_ratio",
    "advantage_speedup",
    "advantage_overlap",
    "advantage_parity",
    "multichip_parity",
    "scaling_efficiency",
    "fused_multichip_parity",
    "fused_scaling_efficiency",
    "serve_parity",
    "prefetch_hit_rate",
    "overlap_fraction",
    "utilization_overhead",
)


def _stage_regression(stage: str, prev: float, cur: float, tolerance: float) -> Optional[float]:
    """The regression's magnitude when ``prev -> cur`` regresses ``stage``
    beyond ``tolerance``, else None. ``*_overhead`` stages are shares of
    throughput lost: a rise, compared absolutely (they sit near 0, where
    relative deltas explode). Every other ratio is higher-is-better: a
    relative drop."""
    if stage.endswith("_overhead"):
        delta = cur - prev
        return delta if delta > tolerance else None
    drop = (prev - cur) / max(abs(prev), 1e-9)
    return drop if prev > 0 and drop > tolerance else None


def load_record(path: str) -> Optional[Dict]:
    """One record -> a normalized dict, or None when it is unreadable or not
    the port's."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(raw, dict):
        return None
    body = raw.get("parsed") if isinstance(raw.get("parsed"), dict) else raw
    if not isinstance(body, dict) or "value" not in body:
        return None
    host = body.get("host") if isinstance(body.get("host"), dict) else None
    if host is None or "torch" not in host:
        return None
    return {
        "name": os.path.basename(path),
        "value": body.get("value"),
        "unit": body.get("unit"),
        "vs_baseline": body.get("vs_baseline"),
        "stages": body.get("stages") if isinstance(body.get("stages"), dict) else {},
        "host": host,
    }


def fingerprint(host: Optional[Dict]) -> Tuple:
    """A card's comparable identity; an unknown one compares with nothing
    (the None sentinel: two unknown hosts are not assumed alike)."""
    if not host:
        return (None,)
    return tuple(host.get(k) for k in ("platform", "device_kind", "device_count", "power_limit", "torch", "cuda"))


def fingerprint_label(host: Optional[Dict]) -> str:
    if not host:
        return "unknown"
    return f"{host.get('device_kind', '?')} x{host.get('device_count', '?')}"


def build_trajectory(records: List[Dict]) -> Dict:
    """Headline ratios between consecutive records of one fingerprint; the
    ratio stages across every record."""
    comparisons = []
    prev_by_fp: Dict[Tuple, Dict] = {}
    for rec in records:
        fp = fingerprint(rec["host"])
        prev = prev_by_fp.get(fp) if fp != (None,) else None
        if prev is not None and prev["value"] and rec["value"] is not None:
            comparisons.append({"from": prev["name"], "to": rec["name"], "host": fingerprint_label(rec["host"]),
                                "headline_ratio": round(rec["value"] / prev["value"], 4)})
        if fp != (None,):
            prev_by_fp[fp] = rec
    ratio_trajectory: Dict[str, List] = {}
    for stage in RATIO_STAGES:
        series = [{"record": rec["name"], "value": rec["stages"][stage]} for rec in records if stage in rec["stages"]]
        if series:
            ratio_trajectory[stage] = series
    return {
        "records": [
            {"name": rec["name"], "value": rec["value"], "unit": rec["unit"], "vs_baseline": rec["vs_baseline"],
             "host": fingerprint_label(rec["host"]), "host_known": rec["host"] is not None,
             "n_stages": len(rec["stages"])}
            for rec in records
        ],
        "headline_comparisons": comparisons,
        "ratio_stages": ratio_trajectory,
    }


def gate_regressions(records: List[Dict], tolerance: float) -> List[Dict]:
    """Ratio-stage regressions between consecutive records of one
    fingerprint: a verdict holds the card constant, even for the
    dimensionless stages."""
    regressions: List[Dict] = []
    prev_by_fp: Dict[Tuple, Dict] = {}
    for rec in records:
        fp = fingerprint(rec["host"])
        if fp == (None,):
            continue
        prev = prev_by_fp.get(fp)
        if prev is not None:
            for stage in RATIO_STAGES:
                a, b = prev["stages"].get(stage), rec["stages"].get(stage)
                if a is None or b is None:
                    continue
                magnitude = _stage_regression(stage, a, b, tolerance)
                if magnitude is not None:
                    regressions.append({"stage": stage, "from": prev["name"], "to": rec["name"], "prev": a,
                                        "value": b, "magnitude": round(magnitude, 4),
                                        "host": fingerprint_label(rec["host"])})
        prev_by_fp[fp] = rec
    return regressions


def render(trajectory: Dict) -> str:
    lines: List[str] = ["== bench trajectory =="]
    rows = [["record", "headline", "unit", "vs_baseline", "host"]]
    for rec in trajectory["records"]:
        rows.append([
            rec["name"],
            f"{rec['value']:.1f}" if rec["value"] is not None else "-",
            str(rec["unit"] or "-"),
            f"{rec['vs_baseline']}" if rec["vs_baseline"] is not None else "-",
            rec["host"],
        ])
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    for i, row in enumerate(rows):
        lines.append("  ".join(c.ljust(widths[j]) for j, c in enumerate(row)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    if trajectory["headline_comparisons"]:
        lines.append("headline comparisons (like-fingerprint hosts only):")
        for c in trajectory["headline_comparisons"]:
            lines.append(f"  {c['from']} → {c['to']}: ×{c['headline_ratio']} ({c['host']})")
    else:
        lines.append("headline comparisons: none — no two records share a known host fingerprint (absolute "
                     "frames/sec across unlike hosts is a host artifact, not a trajectory)")
    if trajectory["ratio_stages"]:
        lines.append("within-run ratio stages (host-comparable):")
        for stage, series in sorted(trajectory["ratio_stages"].items()):
            path = " → ".join(f"{s['value']}@{s['record'].replace('BENCH_', '').replace('.json', '')}"
                              for s in series)
            lines.append(f"  {stage:26s} {path}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", required=True, help="directory holding the port's BENCH_*.json records")
    p.add_argument("--gate", action="store_true",
                   help="exit nonzero when a like-fingerprint record regresses a ratio stage beyond --tolerance")
    p.add_argument("--tolerance", type=float, default=0.05,
                   help="gate tolerance: max relative drop for higher-is-better stages / max absolute rise for "
                   "*_overhead stages (default 0.05)")
    args = p.parse_args(argv)
    paths = sorted(glob.glob(os.path.join(args.dir, "BENCH_*.json")))
    records = [r for r in (load_record(p_) for p_ in paths) if r is not None]
    trajectory = build_trajectory(records)
    trajectory["skipped_unreadable"] = len(paths) - len(records)
    print(render(trajectory), flush=True)
    print("BENCH_TRAJECTORY " + json.dumps(trajectory, sort_keys=True), flush=True)
    if args.gate:
        regressions = gate_regressions(records, args.tolerance)
        for r in regressions:
            print(f"BENCH_GATE FAIL {r['stage']}: {r['prev']} → {r['value']} ({r['from']} → {r['to']}, {r['host']}, "
                  f"magnitude {r['magnitude']} > tol {args.tolerance})", flush=True)
        if regressions:
            return 1
        print(f"BENCH_GATE PASS ({len(records)} records, tolerance {args.tolerance})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Join a run's per-process trace logs into the pipeline report.

Copy of ``scripts/trace_report.py`` over the port's torn-line-tolerant
reader (``utils/telemetry.py`` ``load_jsonl``), so a run on the card is read
without the script, which loads the JAX package's telemetry module. Each
process of a run (the learner's, the actors' and the serve CLI's
``--trace-jsonl``; ``utils/tracing.py``) appends sampled events to its own
log; this joins them into:

* the **per-chunk end-to-end latency** (collect -> dispatch) and its
  histogram, from the chunks' hop timelines merged by trace id (the
  learner emits the whole timeline, an actor its part, which survives the
  actor's SIGKILL);
* the **critical path**: mean, p50 and p95 of each adjacent hop's delta
  (actor compute, wire, drain wait, admission, ring residency, dispatch
  wait) over the chunks that have both ends;
* the **weights staleness** of each chunk at dispatch, split into
  publish -> apply (fanout), apply -> encode (actor hold) and encode ->
  dispatch (pipeline);
* the **serve round trips** (encode -> recv -> reply -> done) and the
  **compile events** (none in the port: it compiles nothing per program).

The report's JSON is the script's on the same logs. Usage::

    python -m dotaclient_tpu_torch.utils.trace_report RUN_DIR        # every *.jsonl in it
    python -m dotaclient_tpu_torch.utils.trace_report a.jsonl b.jsonl
    python -m dotaclient_tpu_torch.utils.trace_report --json RUN_DIR # the summary line only

Exit 0 with a ``TRACE_REPORT {json}`` line; 1 when no trace event was
found.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.utils.telemetry import load_jsonl

# the experience pipeline's hops in order; adjacent deltas are the
# critical path's segments
PIPELINE_HOPS = ("collect", "encode", "recv", "consume", "admit", "gather", "dispatch")
SEGMENT_LABELS = {
    ("collect", "encode"): "actor compute",
    ("encode", "recv"): "wire",
    ("recv", "consume"): "drain wait",
    ("consume", "admit"): "admission",
    ("admit", "gather"): "ring residency",
    ("gather", "dispatch"): "dispatch wait",
}
SERVE_HOPS = ("encode", "recv", "reply", "done")


def load_events(paths: List[str]) -> Tuple[List[dict], int]:
    """Every trace event of ``paths`` (files, or directories for every
    ``*.jsonl`` in them) and the count of lines skipped: torn tails and
    lines that are not trace events (a metrics record in the same
    directory)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        else:
            files.append(p)
    events: List[dict] = []
    skipped = 0
    for path in files:
        try:
            lines = load_jsonl(path)
        except OSError:
            skipped += 1
            continue
        for line in lines:
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(obj, dict) and "event" in obj:
                events.append(obj)
            else:
                skipped += 1
    return events, skipped


def _clean_hops(raw: object) -> Dict[str, float]:
    """The well-formed hops (``[name, ts]`` with a string name and a numeric
    stamp), first stamp of a name kept: a malformed hop reads as absent."""
    hops: Dict[str, float] = {}
    if not isinstance(raw, (list, tuple)):
        return hops
    for entry in raw:
        if (isinstance(entry, (list, tuple)) and len(entry) == 2 and isinstance(entry[0], str)
                and isinstance(entry[1], (int, float))):
            hops.setdefault(entry[0], float(entry[1]))
    return hops


def merge_chunks(events: List[dict]) -> Dict[str, dict]:
    """Trace id -> the merged record of a rollout chunk. The processes that
    emitted one id contribute their hops, the first stamp of a name
    winning. Serve records (a ``reply`` or ``done`` hop) are left to
    :func:`serve_rtts`: their encode and recv hops would pollute the
    wire segment."""
    chunks: Dict[str, dict] = {}
    for ev in events:
        if ev.get("event") != "chunk":
            continue
        tid = ev.get("tid")
        if not tid:
            continue
        hops = _clean_hops(ev.get("hops"))
        if hops.keys() & {"reply", "done"}:
            continue
        rec = chunks.setdefault(tid, {"tid": tid, "origin_pid": ev.get("origin_pid"), "actor": ev.get("actor"),
                                      "wv": ev.get("wv"), "hops": {}})
        for name, ts in hops.items():
            rec["hops"].setdefault(name, ts)
    return chunks


def _quantiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "n": 0}
    s = sorted(values)
    return {"mean": sum(s) / len(s), "p50": s[len(s) // 2],
            "p95": s[min(len(s) - 1, int(math.ceil(0.95 * len(s))) - 1)], "n": len(s)}


def critical_path(chunks: Dict[str, dict]) -> Dict[str, dict]:
    """Each adjacent hop pair's delta statistics over the chunks that have
    both hops."""
    out: Dict[str, dict] = {}
    for a, b in zip(PIPELINE_HOPS, PIPELINE_HOPS[1:]):
        deltas = [rec["hops"][b] - rec["hops"][a] for rec in chunks.values() if a in rec["hops"] and b in rec["hops"]]
        if deltas:
            out[SEGMENT_LABELS[(a, b)]] = {"from": a, "to": b, **_quantiles(deltas)}
    return out


def e2e_histogram(chunks: Dict[str, dict]) -> Tuple[List[float], Dict[str, float], List[Tuple[str, int]]]:
    """(each chunk's collect -> dispatch seconds, their statistics, counts
    in power-of-two millisecond buckets)."""
    lat: List[float] = []
    for rec in chunks.values():
        hops = rec["hops"]
        start = hops.get("collect", hops.get("encode"))
        end = hops.get("dispatch")
        if start is not None and end is not None and end >= start:
            lat.append(end - start)
    buckets: Dict[int, int] = {}
    for v in lat:
        b = max(0, int(math.log2(max(v * 1e3, 1e-3))) + 1)
        buckets[b] = buckets.get(b, 0) + 1
    return lat, _quantiles(lat), [(f"< {2 ** b} ms", buckets[b]) for b in sorted(buckets)]


def staleness_attribution(chunks: Dict[str, dict], events: List[dict]) -> dict:
    """Each chunk's weights age at dispatch, split. ``publish`` events date
    version V's fanout, ``apply`` events (pid, V)'s apply (their echoed
    ``publish_ts`` stands in for a missing learner log): publish -> apply
    is the fanout, apply -> encode the actor's hold, encode -> dispatch
    the pipeline. ``dominant`` names the largest on average."""
    publishes: Dict[int, float] = {}
    applies: Dict[Tuple[int, int], float] = {}
    for ev in events:
        version = ev.get("version")
        if not isinstance(version, (int, float)):
            continue   # a malformed event reads as absent
        ts = ev.get("ts")
        ts = float(ts) if isinstance(ts, (int, float)) else 0.0
        if ev.get("event") == "publish":
            publishes.setdefault(int(version), ts)
            continue
        if ev.get("event") == "apply":
            applies.setdefault((ev.get("pid"), int(version)), ts)
            if isinstance(ev.get("publish_ts"), (int, float)):
                publishes.setdefault(int(version), float(ev["publish_ts"]))
    fanout: List[float] = []
    hold: List[float] = []
    transit: List[float] = []
    total: List[float] = []
    for rec in chunks.values():
        hops = rec["hops"]
        wv = rec.get("wv")
        encode = hops.get("encode")
        dispatch = hops.get("dispatch")
        if not isinstance(wv, (int, float)) or encode is None or dispatch is None:
            continue
        pub = publishes.get(int(wv))
        app = applies.get((rec.get("origin_pid"), int(wv)))
        if app is not None and encode >= app:
            hold.append(encode - app)
            if pub is not None and app >= pub:
                fanout.append(app - pub)
        transit.append(dispatch - encode)
        if pub is not None and dispatch >= pub:
            total.append(dispatch - pub)
    components = {
        "publish→apply (fanout)": _quantiles(fanout),
        "apply→encode (actor hold)": _quantiles(hold),
        "encode→dispatch (pipeline)": _quantiles(transit),
    }
    measured = {k: v for k, v in components.items() if v["n"]}
    dominant = max(measured, key=lambda k: measured[k]["mean"]) if measured else None
    return {"components": components, "weights_age_at_dispatch_s": _quantiles(total), "dominant": dominant,
            "publishes_seen": len(publishes), "applies_seen": len(applies)}


def serve_rtts(events: List[dict]) -> dict:
    """Serve round trips (encode -> done) and their server side (recv ->
    reply) from the clients' records."""
    rtts = []
    server_side = []
    for ev in events:
        if ev.get("event") != "chunk":
            continue
        hops = _clean_hops(ev.get("hops"))
        if "done" in hops and "encode" in hops:
            rtts.append(hops["done"] - hops["encode"])
            if "reply" in hops and "recv" in hops:
                server_side.append(hops["reply"] - hops["recv"])
    return {"rtt_s": _quantiles(rtts), "server_s": _quantiles(server_side)}


def compile_summary(events: List[dict]) -> dict:
    progs: Dict[str, dict] = {}
    for ev in events:
        if ev.get("event") != "compile":
            continue
        p = progs.setdefault(ev.get("program", "?"), {"compiles": 0, "total_s": 0.0, "flops": 0.0, "bytes": 0.0})
        p["compiles"] += 1
        p["total_s"] += float(ev.get("elapsed_s", 0.0))
        p["flops"] = max(p["flops"], float(ev.get("flops", 0.0)))
        p["bytes"] = max(p["bytes"], float(ev.get("bytes_accessed", 0.0)))
    return progs


def build_report(paths: List[str]) -> dict:
    events, skipped = load_events(paths)
    chunks = merge_chunks(events)
    complete = {tid: rec for tid, rec in chunks.items() if "dispatch" in rec["hops"]}
    _lat, e2e, hist_rows = e2e_histogram(chunks)
    return {
        "events": len(events),
        "lines_skipped": skipped,
        "chunks_seen": len([r for r in chunks.values() if "collect" in r["hops"] or "encode" in r["hops"]]),
        "chunks_complete": len(complete),
        "origin_pids": sorted({rec["origin_pid"] for rec in chunks.values() if rec.get("origin_pid") is not None}),
        "e2e_latency_s": e2e,
        "e2e_histogram": hist_rows,
        "critical_path": critical_path(chunks),
        "staleness": staleness_attribution(chunks, events),
        "serve": serve_rtts(events),
        "compiles": compile_summary(events),
    }


def _fmt_ms(v: float) -> str:
    return f"{v * 1e3:9.2f}"


def print_report(report: dict) -> None:
    print(f"trace report: {report['events']} events, {report['chunks_seen']} traced chunks "
          f"({report['chunks_complete']} complete), origins {report['origin_pids']}, "
          f"{report['lines_skipped']} line(s) skipped")
    e2e = report["e2e_latency_s"]
    if e2e["n"]:
        print(f"\nend-to-end chunk latency (collect→dispatch, n={e2e['n']}): mean {_fmt_ms(e2e['mean'])} ms  "
              f"p50 {_fmt_ms(e2e['p50'])} ms  p95 {_fmt_ms(e2e['p95'])} ms")
        width = max((n for _, n in report["e2e_histogram"]), default=1)
        for label, n in report["e2e_histogram"]:
            print(f"  {label:>12} | {n:6d} {'#' * max(1, int(40 * n / width))}")
    cp = report["critical_path"]
    if cp:
        total_mean = sum(seg["mean"] for seg in cp.values()) or 1.0
        print("\ncritical path (adjacent hop deltas):")
        print(f"  {'segment':<16} {'mean ms':>9} {'p50 ms':>9} {'p95 ms':>9} {'share':>7} {'n':>6}")
        for label, seg in cp.items():
            print(f"  {label:<16} {_fmt_ms(seg['mean'])} {_fmt_ms(seg['p50'])} {_fmt_ms(seg['p95'])} "
                  f"{seg['mean'] / total_mean:6.1%} {seg['n']:6d}")
    st = report["staleness"]
    age = st["weights_age_at_dispatch_s"]
    if any(v["n"] for v in st["components"].values()) or age["n"]:
        print(f"\nweight-staleness attribution (publishes seen: {st['publishes_seen']}, applies seen: "
              f"{st['applies_seen']}):")
        print(f"  {'component':<28} {'mean ms':>9} {'p95 ms':>9} {'n':>6}")
        for label, q in st["components"].items():
            print(f"  {label:<28} {_fmt_ms(q['mean'])} {_fmt_ms(q['p95'])} {q['n']:6d}")
        if age["n"]:
            print(f"  weights age at dispatch: mean {_fmt_ms(age['mean'])} ms, p95 {_fmt_ms(age['p95'])} ms "
                  f"(n={age['n']})")
        if st["dominant"]:
            print(f"  dominant aging hop: {st['dominant']}")
    serve = report["serve"]
    if serve["rtt_s"]["n"]:
        r, s = serve["rtt_s"], serve["server_s"]
        print(f"\nserve round trips (n={r['n']}): mean {_fmt_ms(r['mean'])} ms p95 {_fmt_ms(r['p95'])} ms; "
              f"server-side recv→reply mean {_fmt_ms(s['mean'])} ms")
    if report["compiles"]:
        print("\ncompiles:")
        for prog, p in sorted(report["compiles"].items()):
            print(f"  {prog:<20} x{p['compiles']} {p['total_s']:8.2f}s total, {p['flops']:.3e} flops, "
                  f"{p['bytes']:.3e} bytes")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("paths", nargs="+", help="trace JSONL files or directories (every *.jsonl inside)")
    p.add_argument("--json", action="store_true", help="print only the TRACE_REPORT summary line")
    args = p.parse_args(argv)
    report = build_report(args.paths)
    if not args.json:
        print_report(report)
    print("TRACE_REPORT " + json.dumps(report, sort_keys=True), flush=True)
    return 0 if report["events"] else 1


if __name__ == "__main__":
    sys.exit(main())

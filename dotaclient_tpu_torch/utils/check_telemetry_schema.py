"""CI guard: a run record (``--metrics-jsonl``) matches the documented schema.

The counterpart of the JAX package's ``scripts/check_telemetry_schema.py``
over the port: the tiers are ``utils/schema.py``'s (equal to the script's,
key for key), the record a port learner's, serve CLI's or router's. It runs
the port learner's ``--smoke --steps 2`` with a JSONL sink attached (or
validates an existing file via ``--path``) and checks:

* every line parses as JSON and has the envelope
  ``{"ts": float, "step": int >= 0, "scalars": {str: number|null}}``
  (the structured event lines, ``ALERT``, are skipped);
* the union of scalar keys across lines covers the base tier (the
  pipeline's per-stage spans, gauges and counters) and every tier a
  ``--require-*`` flag names;
* every span timer carries its full set of stat leaves.

Exit status 0 on success; 1 with a diagnostic on any violation. The smoke
run takes the card unless ``--device cpu`` is given (as the tests do). The
tier lists are themselves machine-checked: the ``telemetry-drift`` pass of
``python -m dotaclient_tpu_torch.lint`` fails when a tier requires a key
no port code emits.

Usage:
    python -m dotaclient_tpu_torch.utils.check_telemetry_schema [--device cpu]  # smoke + validate
    python -m dotaclient_tpu_torch.utils.check_telemetry_schema --path x.jsonl --require-snapshot ...
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

from dotaclient_tpu_torch.utils.schema import (
    ADVANTAGE_KEYS,
    FAULT_KEYS,
    FLEET_KEYS,
    HEALTH_KEYS,
    MULTICHIP_KEYS,
    OUTCOME_KEYS,
    ROUTER_KEYS,
    SERVE_KEYS,
    SHM_TRANSPORT_KEYS,
    SNAPSHOT_KEYS,
    SOCKET_TRANSPORT_KEYS,
    TRACE_KEYS,
    UTILIZATION_KEYS,
    WIRE_KEYS,
    validate_lines,
)
from dotaclient_tpu_torch.utils.telemetry import load_jsonl

# flag → (tier, help), in the reference's order of the extra tiers
TIERS = (
    ("--require-transport", SOCKET_TRANSPORT_KEYS,
     "also require the socket-transport fanout metrics (a --transport socket learner's record)"),
    ("--require-shm", SHM_TRANSPORT_KEYS,
     "also require the shared-memory lane metrics (a --transport shm learner's record)"),
    ("--require-faults", FAULT_KEYS,
     "also require the fault-tolerance counters (a --transport socket + --checkpoint-dir learner's record, "
     "e.g. utils/chaos_run.py's learners)"),
    ("--require-snapshot", SNAPSHOT_KEYS,
     "also require the snapshot engine's keys; valid against ANY learner record (made in async and "
     "synchronous snapshot modes alike)"),
    ("--require-wire", WIRE_KEYS,
     "also require the wire's byte accounting (a --transport socket or shm learner's record)"),
    ("--require-health", HEALTH_KEYS,
     "also require the health guardian's keys (a learner with health.enabled, the default)"),
    ("--require-serve", SERVE_KEYS,
     "also require the serving plane's keys (a serve CLI's --serve-metrics-jsonl record; the learner's base "
     "tier is not asked for)"),
    ("--require-router", ROUTER_KEYS,
     "also require the serve fleet router's keys (a router's --metrics-jsonl record; the learner's base tier "
     "is not asked for)"),
    ("--require-advantage", ADVANTAGE_KEYS,
     "also require the one-pass advantage plane's keys; valid against ANY learner record"),
    ("--require-multichip", MULTICHIP_KEYS,
     "also require the mesh's keys; valid against ANY learner record at any world size"),
    ("--require-trace", TRACE_KEYS,
     "also require the trace, compile and memory keys; valid against ANY learner record"),
    ("--require-fleet", FLEET_KEYS,
     "also require the fleet plane's rollups and alert keys; valid against ANY learner record"),
    ("--require-outcome", OUTCOME_KEYS,
     "also require the outcome plane's keys; valid against ANY learner record"),
    ("--require-utilization", UTILIZATION_KEYS,
     "also require the utilization plane's keys; valid against ANY learner record"),
)


def run_smoke(path: str, device: Optional[str]) -> None:
    """One tiny port learner run with the JSONL sink attached."""
    from dotaclient_tpu_torch.train.learner import main as learner_main

    argv = ["--smoke", "--steps", "2", "--metrics-jsonl", path]
    if device is not None:
        argv += ["--device", device]
    rc = learner_main(argv)
    if rc:
        raise SystemExit(f"the smoke learner exited {rc}")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path", type=str, default=None,
                   help="validate an existing JSONL file instead of running the smoke")
    p.add_argument("--device", type=str, default=None,
                   help="the smoke learner's torch device (default: the card; 'cpu' must be asked for)")
    for flag, _keys, text in TIERS:
        p.add_argument(flag, action="store_true", help=text)
    args = p.parse_args(argv)
    extra: tuple = ()
    for flag, keys, _text in TIERS:
        if getattr(args, flag[2:].replace("-", "_")):
            extra += keys

    path = args.path
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".jsonl", prefix="telemetry_schema_")
        os.close(fd)
        try:
            run_smoke(path, args.device)
            lines = load_jsonl(path)
        finally:
            os.unlink(path)
    else:
        lines = load_jsonl(path)

    # serve and router runs are other process classes: their records carry
    # their own plane's keys, not the learner's actor/buffer spans
    base = () if args.require_serve or args.require_router else None
    errors = validate_lines(lines, extra_required=extra, base_required=base)
    if errors:
        print("telemetry schema check FAILED:", file=sys.stderr)
        for e in errors:
            print(f"  - {e}", file=sys.stderr)
        return 1
    print(f"telemetry schema OK: {len(lines)} lines validated")
    return 0


if __name__ == "__main__":
    sys.exit(main())

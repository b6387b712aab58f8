"""Run one cell of the benchmark once::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the program's build caches in ``benchmark/.cache/``, weights drawn
on the card from ``--seed``, this cell's shapes warmed), a measured window of
``--seconds``, with ``--trace 1`` a profiled sub-window after it, then the
check against the plain reference. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, ``breakdown`` (traced runs) and ``checks``, each number compared
beside its limit; the same numbers close standard error.

Exits non-zero with no result line when there is no CUDA card (or fewer
than the cell asks for), when the program does not match the cell, or when
JAX or the JAX package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dotaclient_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``dotaclient_tpu_torch`` is not ``dotaclient_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def use_caches(root: str) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so only a checkout's first run builds."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    from dotaclient_tpu_torch.native import build as native_build
    from dotaclient_tpu_torch.ops import build as ops_build

    ops_build.set_build_dir(os.path.join(cache, "lstm_seq"))
    native_build.set_build_dir(os.path.join(cache, "rollout_codec"))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, root: Optional[str] = None,
             plant=None, t_start: Optional[float] = None) -> Dict[str, Any]:
    """Run the cell and return the result object (without the JAX check or
    the card check, which the command line adds)."""
    import importlib

    from benchmark import cells

    cell = cells.load(name, root)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    out = driver.run(cell, seed, seconds, trace, device, T_START if t_start is None else t_start, plant=plant)
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    metrics: Dict[str, Any] = {}
    if not trace:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(out.ctx, profile=out.profile)
        for m in cell.per_layer():
            value = cells.metric_reader(cell, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    # a reading without a limit is reported on standard error, not compared
    checks = {k: {"value": out.compared[k], "limit": lim} for k, lim in cell.limits.items()}
    for k in sorted(set(out.compared) - set(cell.limits)):
        print(f"bench: reading {k} = {out.compared[k]!r} (not compared)", file=sys.stderr)
    correct = out.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda" else device.type,
                           "kind": _device_name(device), "count": int(cell.workload["chips"]),
                           "memory_peak_bytes": out.memory_peak_bytes}
    result: Dict[str, Any] = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
                              "metrics": metrics, "device": dev}
    if trace and out.profile is not None:
        dev["busy_s"] = out.profile.busy_s()
        dev["window_s"] = out.profile.window_s
        result["breakdown"] = {"device_ops": out.profile.top_device_ops(), "idle_gaps": out.profile.idle_gaps()}
    result["checks"] = checks
    return result


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import cells

    root = cells.ROOT
    cell = cells.load(args.workload, root)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell asks for {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    use_caches(root)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, root)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was imported: {found}", file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = power_limit_w()
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

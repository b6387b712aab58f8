"""The readings a cell's correctness limits are set from, on the card::

    python3 -m benchmark.calibrate --workload <cell> --seeds a,b,... --control-seeds c,d,e \\
        [--out readings.jsonl]

For every seed in ``--seeds``, the program's reading of each number the
training cell compares (the lower readings). For every seed in
``--control-seeds``, the control's: the plain reference put in the
program's place in float8 products, judged by the float32 reference; and
the faults planted in the float32 reference put in the program's place
(half the batch left out of the update, one sampled action altered), judged
the same way. A state left unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition and needs no run. Beside each reading,
the gradient and change gaps of every leaf over its own reference norm
alone (``own``), the leaf that sets each worst case, and its norm against
the median leaf's. One JSON line a reading. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List


def _emit(out, record: Dict[str, Any]) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def leaf_readings(grad1, params, judge, params0) -> Dict[str, Any]:
    """The gradient and change gaps leaf by leaf: over the leaf's own
    reference norm (``*_own``) and by the rule compared (the larger of the
    leaf's and the median leaf's), with the worst leaf of each and its
    reference norm as a share of the median leaf's."""
    import numpy as np

    from benchmark.reference import train as ref

    out: Dict[str, Any] = {}
    keep = ref.moved_leaves(judge.grad1)
    pairs = {"grad": (grad1, judge.grad1, list(judge.grad1)),
             "change": ({k: params[k].float() - params0[k].float() for k in keep},
                        {k: judge.params[k] - params0[k].float() for k in keep}, keep)}
    for name, (prog, refv, names) in pairs.items():
        norms = {k: float(refv[k].norm()) for k in names}
        med = float(np.median(list(norms.values())))
        own = {k: abs(float(prog[k].norm()) - norms[k]) / norms[k] if norms[k] > 0 else 0.0 for k in names}
        rule = ref.norm_gaps(prog, refv, names)
        for tag, gaps in (("own", own), ("rule", rule)):
            worst = max(gaps, key=gaps.get)
            out[f"{name}_gap_{tag}"] = gaps[worst]
            out[f"{name}_worst_{tag}"] = worst
            out[f"{name}_worst_{tag}_norm_over_median"] = norms[worst] / med if med > 0 else None
        out[f"{name}_gaps_own"] = own
    return out


def train_readings(cell, seeds: List[int], control: List[int], device, out) -> None:
    import dataclasses

    from benchmark.cells import run_config
    from benchmark.drivers import train as drv
    from benchmark.drivers.common import free, sync
    from benchmark.reference import train as ref
    from benchmark.reference.precision import Arith, strict_float32
    from benchmark.weights import make_weights, param_shapes

    n = int(cell.traffic["checked_iterations"])
    for seed in seeds:
        t0 = time.perf_counter()
        learner, cfg, setup, w0 = drv.build(cell, seed, device)
        losses, grad1, params, actions = drv.first_iterations(learner, n)
        sync(device)
        learner.close()
        del learner
        free(device)
        strict_float32()
        judge = ref.follow(setup, w0, seed, n, actions=actions)
        _emit(out, {"side": "program", "seed": seed, **ref.compare(losses, grad1, params, judge, w0),
                    **leaf_readings(grad1, params, judge, w0), "seconds": time.perf_counter() - t0})
        torch_backends_default()
    for seed in control:
        cfg = run_config(cell, seed)
        setup = drv.reference_setup(cfg)
        shapes = param_shapes(cell.config, dataclasses.asdict(cfg.obs), dataclasses.asdict(cfg.actions))
        w0 = make_weights(shapes, seed, device)
        strict_float32()
        for side, arith, fault in (("control_float8", Arith("float8"), None),
                                   ("fault_half_batch", Arith("float32"), "half_batch"),
                                   ("fault_altered_action", Arith("float32"), "altered_action")):
            t0 = time.perf_counter()
            played = ref.follow(setup, w0, seed, n, arith=arith, fault=fault)
            judge = ref.follow(setup, w0, seed, n, actions=played.actions)
            _emit(out, {"side": side, "seed": seed,
                        **ref.compare(played.losses, played.grad1, played.params, judge, w0),
                        **leaf_readings(played.grad1, played.params, judge, w0),
                        "seconds": time.perf_counter() - t0})


def torch_backends_default() -> None:
    """TF32 back to PyTorch's defaults before the next program run."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    import torch

    from benchmark import cells
    from benchmark.run import use_caches

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    use_caches(cells.ROOT)
    cell = cells.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    out = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        out = open(args.out, "a")
    try:
        train_readings(cell, seeds, control, device, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Trained frames/s of the five BASELINE configs on the card.

Counterpart of the reference's ``scripts/bench_configs.py``. The five
configs (``BASELINE.md`` "Benchmark configs"): 1v1 against a scripted bot on
one device actor, 1v1 self-play at 8 x 32 lanes, 1v1 self-play over the hero
pool {1,2,3}, 2v2 self-play, and 5v5 at 256 games against league opponents.
Each is trained end to end (rollouts on the card, the ring, the update) and
one JSON row a config is printed, then a table::

    python -m dotaclient_tpu_torch.train.bench_configs                 # all five
    python -m dotaclient_tpu_torch.train.bench_configs --configs 3,4 --mode fused
    python -m dotaclient_tpu_torch.train.bench_configs --configs 1 --steps 2 --device cpu

The measurement is the reference's: ``train(20)`` to warm up, then the best
of 3 ``train(steps)`` blocks in ``frames_trained`` over the host clock.
``measure_config`` takes the warm-up, the blocks and the game length, so a
caller can run it shallower. Self-play makes every hero a learner lane, so
config 2 steps 512 learner lanes and configs 3-4 step 256.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

# the reference's measurement: warm-up steps, timed blocks, steps a block
WARMUP, REPEATS, STEPS = 20, 3, 100


def build_config(n: int, base):
    """BASELINE config ``n`` -> (RunConfig, description), field for field
    the reference's."""
    env = base.env
    buf = base.buffer
    league = base.league
    if n == 1:
        # 1v1 mid against the easy bot; the "single worker" is one device
        # actor multiplexing enough lanes to feed the learner's batch
        env = dataclasses.replace(env, n_envs=128, team_size=1, hero_pool=(1,), opponent="scripted_easy",
                                  max_dota_time=120.0)
        desc = "1v1-mid, single device-actor, scripted opponent"
    elif n == 2:
        # 1v1 mid self-play, 8 workers into one optimizer: 8 lane groups,
        # both sides learner lanes
        env = dataclasses.replace(env, n_envs=8 * 32, team_size=1, hero_pool=(1,), opponent="selfplay",
                                  max_dota_time=120.0)
        desc = "1v1-mid self-play, 8x32 lanes"
    elif n == 3:
        # the hero pool with its embedding (Nevermore, Lina, Sniper)
        env = dataclasses.replace(env, n_envs=128, team_size=1, hero_pool=(1, 2, 3), opponent="selfplay",
                                  max_dota_time=120.0)
        desc = "1v1-mid multi-hero pool {1,2,3}, self-play"
    elif n == 4:
        # 2v2 lane self-play (the ally and enemy unit attention heads)
        env = dataclasses.replace(env, n_envs=64, team_size=2, hero_pool=(1, 2, 3), opponent="selfplay",
                                  max_dota_time=120.0)
        desc = "2v2 self-play, 64 games (256 lanes)"
    elif n == 5:
        # 5v5, 256 games against league opponents
        env = dataclasses.replace(env, n_envs=256, team_size=5, hero_pool=(1, 2, 3), opponent="league",
                                  max_dota_time=120.0)
        league = dataclasses.replace(league, enabled=True, snapshot_every=100, pool_size=4)
        desc = "5v5 league, 256 games (1280 learner lanes)"
    else:
        raise ValueError(f"unknown config {n}")
    buf = dataclasses.replace(buf, capacity_rollouts=512, min_fill=128)
    cfg = dataclasses.replace(base, env=env, buffer=buf, league=league, log_every=10_000)
    return cfg, desc


def measure_config(n: int, base, mode: str = "device", steps_per_dispatch: int = 1,
                   seed: int = 0, device=None, steps: int = STEPS, warmup: int = WARMUP, repeats: int = REPEATS,
                   max_dota_time: Optional[float] = None,
                   observe: Optional[Callable] = None) -> Tuple[Dict, List[Dict[str, float]]]:
    """Train config ``n`` in ``mode`` for ``warmup`` steps, then the best of
    ``repeats`` blocks of ``steps``, in trained frames over the host clock.
    ``max_dota_time`` overrides the config's game length. ``observe(learner,
    outs)`` is called once the learner is built (``outs`` None) and again
    after the last block, before the learner is closed. Returns (the row,
    each block's ``train`` result)."""
    from dotaclient_tpu_torch.train.learner import Learner

    cfg, desc = build_config(n, base)
    cfg = dataclasses.replace(cfg, steps_per_dispatch=steps_per_dispatch)
    if max_dota_time is not None:
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, max_dota_time=max_dota_time))
    learner = Learner(cfg, actor=mode, seed=seed, device=device)
    try:
        if observe is not None:
            observe(learner, None)
        learner.train(warmup)
        fps, outs = 0.0, []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = learner.train(steps)
            # frames_trained, not steps x frames a step: epochs and
            # minibatches re-use each chunk, and dispatch batching overshoots
            # the request in strides
            fps = max(fps, out["frames_trained"] / (time.perf_counter() - t0))
            outs.append(out)
        if observe is not None:
            observe(learner, outs)
        row = {
            "config": n,
            "desc": desc,
            "mode": mode,
            "core": cfg.model.core,
            "steps_per_dispatch": steps_per_dispatch,
            "end_to_end_frames_per_sec": round(fps, 1),
            "n_envs": cfg.env.n_envs,
            "team_size": cfg.env.team_size,
            "learner_lanes": learner.device_actor.n_lanes,
        }
    finally:
        learner.close()
    return row, outs


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", type=str, default="1,2,3,4,5")
    p.add_argument("--steps", type=int, default=STEPS, help="timed optimizer steps per config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", type=str, default="device", choices=("device", "fused"),
                   help="device: buffered loop; fused: one program per step (batch = lane set, so frames/step "
                   "scales with lanes)")
    p.add_argument("--core", type=str, default="lstm", choices=("lstm", "transformer"),
                   help="policy core used across all configs")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="with --mode fused: iterations per fused call (RunConfig.steps_per_dispatch)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA card; 'cpu' must be asked for)")
    args = p.parse_args(argv)
    if args.steps_per_dispatch > 1 and args.mode != "fused":
        p.error("--steps-per-dispatch needs --mode fused")

    from dotaclient_tpu_torch.config import default_config
    from dotaclient_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    base = default_config()
    if args.core != "lstm":
        base = dataclasses.replace(base, model=dataclasses.replace(base.model, core=args.core))
    results = []
    for n in (int(s) for s in args.configs.split(",")):
        row, _ = measure_config(n, base, mode=args.mode, steps_per_dispatch=args.steps_per_dispatch,
                                seed=args.seed, device=device, steps=args.steps)
        results.append(row)
        print(json.dumps(row), flush=True)

    print("\nconfig | description | e2e frames/sec")
    for r in results:
        print(f"{r['config']:>6} | {r['desc']:<46} | {r['end_to_end_frames_per_sec']:>10,.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

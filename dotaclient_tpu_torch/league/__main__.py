"""Win-rate evaluation of a checkpoint the port's learner wrote.

Counterpart of the JAX package's ``league/__main__.py``::

    python -m dotaclient_tpu_torch.league --checkpoint runs/ckpt
    python -m dotaclient_tpu_torch.league --checkpoint runs/ckpt --opponent scripted_easy --games 128
    python -m dotaclient_tpu_torch.league --checkpoint runs/A --vs runs/B [--device cpu]

``--vs`` plays checkpoint against checkpoint (league mode): A plays the
learner side, B is the frozen opponent. Both must share one model,
observation and action config (the sim hosts one of each per match), else
the command exits 2. The first checkpoint's env config (team size, hero
pool) hosts the match. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

import torch

from dotaclient_tpu_torch.config import RunConfig


def _load(directory: str) -> Tuple[RunConfig, Dict[str, torch.Tensor], int]:
    """A checkpoint directory -> (its config, its params, its step)."""
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory, registry=telemetry.Registry())
    config = mgr.restore_config()
    params, step = mgr.restore_weights()
    return config, params, step


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", type=str, required=True, help="checkpoint directory of the port's learner")
    p.add_argument("--vs", type=str, default=None,
                   help="second checkpoint directory: play league mode against its frozen policy instead of a bot")
    p.add_argument("--opponent", type=str, default="scripted_hard",
                   help="scripted opponent mode when --vs is absent")
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA card; 'cpu' must be asked for)")
    args = p.parse_args(argv)

    from dotaclient_tpu_torch.device import resolve_device
    from dotaclient_tpu_torch.league import evaluate
    from dotaclient_tpu_torch.serve.policy_path import make_inference_policy

    device = resolve_device(args.device)
    config, params, step = _load(args.checkpoint)
    policy = make_inference_policy(config, device=device)
    if args.vs is not None:
        opp_config, opp_params, opp_step = _load(args.vs)
        if (config.model, config.obs, config.actions) != (opp_config.model, opp_config.obs, opp_config.actions):
            print("league eval: the --vs checkpoint has another model, obs or action config; both sides must "
                  "share one policy architecture (the sim hosts one observation and action space per match)",
                  file=sys.stderr, flush=True)
            return 2
        result = evaluate(config, policy, params, "league", opponent_params=opp_params,
                          n_games=args.games, seed=args.seed, device=device)
        opponent = f"checkpoint:{args.vs}@step{opp_step}"
    else:
        result = evaluate(config, policy, params, args.opponent, n_games=args.games, seed=args.seed,
                          device=device)
        opponent = args.opponent
    print(json.dumps({
        "checkpoint": args.checkpoint,
        "step": step,
        "opponent": opponent,
        "games": int(result["episodes"]),
        "win_rate": round(float(result["win_rate"]), 4),
        "episode_reward_mean": round(float(result["episode_reward_mean"]), 4),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

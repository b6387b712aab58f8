"""The 5v5 curriculum in one command: 1v1 on the hero pool, then 5v5 from its weights.

Counterpart of the reference's ``scripts/curriculum_5v5.py``, with the same
two stages and flags (``BASELINE.md`` "5v5 curriculum transfer"):

  stage 1: 1v1 on the hero pool against ``scripted_easy`` (dense credit a
           hero);
  stage 2: the stage-1 weights alone carried to 5v5 (``--init-from``), a
           critic-only warm-up, then a low-lr PPO fine-tune (1e-5 with plain
           Adam; ``--kl-target`` lets the KL-adaptive controller pick the
           step size instead; ``--anchor-kl`` penalises the KL from the
           transferred policy).

Each stage is a ``python -m dotaclient_tpu_torch.train.demo`` child, so each
stays reproducible alone; ``--device`` and the demo's size flags
(``--n-envs``, ``--eval-games``, ``--max-dota-time``) pass through to both::

    python -m dotaclient_tpu_torch.train.curriculum                   # the full recipe
    python -m dotaclient_tpu_torch.train.curriculum --stage1-steps 2000 --stage2-steps 1000
    python -m dotaclient_tpu_torch.train.curriculum --kl-target 1e-3  # self-tuned step size
    python -m dotaclient_tpu_torch.train.curriculum --stage1-steps 2 --stage2-steps 2 --n-envs 4 \\
        --eval-games 4 --max-dota-time 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional

DEMO = ("-m", "dotaclient_tpu_torch.train.demo")


def stage_commands(args) -> List[List[str]]:
    """The demo's argv of each stage to run: stage 2 alone with
    ``--skip-stage1``."""
    stage1_dir = os.path.join(args.ckpt_root, "curriculum_stage1")
    stage2_dir = os.path.join(args.ckpt_root, "curriculum_stage2")
    passed = []
    for flag, value in (("--device", args.device), ("--n-envs", args.n_envs), ("--eval-games", args.eval_games),
                        ("--max-dota-time", args.max_dota_time)):
        if value is not None:
            passed += [flag, str(value)]
    cmds = []
    if not args.skip_stage1:
        cmds.append([sys.executable, *DEMO, "--team-size", "1", "--hero-pool", args.hero_pool,
                     "--steps", str(args.stage1_steps), "--seed", str(args.seed), "--checkpoint-dir", stage1_dir,
                     *passed])
    if args.kl_target > 0:
        ppo = f"value_warmup_steps=500,entropy_coef=0.001,kl_target={args.kl_target}"
    else:
        ppo = f"value_warmup_steps=500,entropy_coef=0.001,learning_rate={args.lr}"
    if args.anchor_kl > 0:
        ppo += f",anchor_kl_coef={args.anchor_kl}"
    cmds.append([sys.executable, *DEMO, "--team-size", "5", "--init-from", stage1_dir,
                 "--steps", str(args.stage2_steps), "--seed", str(args.seed), "--ppo", ppo,
                 "--checkpoint-dir", stage2_dir, *passed])
    return cmds


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage1-steps", type=int, default=8000)
    p.add_argument("--stage2-steps", type=int, default=10000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--ckpt-root", type=str, default="checkpoints")
    p.add_argument("--hero-pool", type=str, default="1,2,3")
    p.add_argument("--lr", type=float, default=1e-5,
                   help="stage-2 fine-tune learning rate (ignored when --kl-target is set)")
    p.add_argument("--kl-target", type=float, default=0.0,
                   help="enable the KL-adaptive lr controller for stage 2 instead of a fixed low lr")
    p.add_argument("--anchor-kl", type=float, default=0.0,
                   help="stage-2 anchor-KL coefficient (PPOConfig.anchor_kl_coef): penalise the KL from the "
                   "transferred policy itself")
    p.add_argument("--skip-stage1", action="store_true", help="reuse an existing stage-1 checkpoint")
    p.add_argument("--device", type=str, default=None,
                   help="both stages' torch device (default: the current CUDA card; 'cpu' must be asked for)")
    p.add_argument("--n-envs", type=int, default=None, help="both stages' games (default: the demo's)")
    p.add_argument("--eval-games", type=int, default=None, help="both stages' evaluation games (default: the demo's)")
    p.add_argument("--max-dota-time", type=float, default=None,
                   help="both stages' game length in game seconds (default: the demo's)")
    args = p.parse_args(argv)
    if args.skip_stage1 and not os.path.isdir(os.path.join(args.ckpt_root, "curriculum_stage1")):
        p.error(f"--skip-stage1 but no checkpoint at {os.path.join(args.ckpt_root, 'curriculum_stage1')}")
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.device is None:
        from dotaclient_tpu_torch.device import resolve_device

        resolve_device(None)   # no card: raise here, before a child starts
    for cmd in stage_commands(args):
        print("== curriculum:", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

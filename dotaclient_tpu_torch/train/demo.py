"""Seeded learning demonstration: evaluate, train, evaluate again.

Counterpart of ``scripts/train_demo.py``, run on the card as::

    python -m dotaclient_tpu_torch.train.demo                      # 20,000 steps, 1v1 vs scripted_easy
    python -m dotaclient_tpu_torch.train.demo --steps 2000 --team-size 5 --opponent league \\
        --league anchor_prob=0.25,anchor_opponent=mixed
    python -m dotaclient_tpu_torch.train.demo --steps 4 --n-envs 8 --eval-games 4 --device cpu

Protocol:

1. evaluate the initial policy against ``scripted_easy`` and
   ``scripted_hard``;
2. train in blocks of 1,000 optimizer steps against ``--opponent``,
   printing each block's windowed win rate and episode reward;
3. evaluate the trained policy against both bots and against its own
   initial self (league mode against the step-0 params);
4. print ``DEMO_SUMMARY {json}``, with the ``lstm_seq`` kernel's launches
   in the run (0 on the CPU) and each evaluation's chunks
   (``eval_collects``: easy, hard, then easy, hard and the initial self),
   from which the launches follow.

``--metrics-jsonl PATH`` writes the learner's run record (pair it with
``--log-every`` for dense outcome curves), ``--logdir`` its tensorboardX
scalars. With neither, no log boundary falls inside a block: a boundary
drains the windowed stats each block prints (the reference's default
``--log-every``: 10,000 with ``--logdir``, else never). ``--core
transformer`` trains the windowed-attention core and ``--moe-experts N``
gives its FFNs N routed experts (``--core transformer --moe-experts 4
--steps 3 --n-envs 4 --eval-games 4 --device cpu`` runs it on the CPU).
``--actor`` picks the learner's mode as the
reference's does: ``fused`` (the default) or ``device``, the buffered
learner (``--actor device --n-envs 8 --eval-games 4 --device cpu`` runs it
on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20_000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--n-envs", type=int, default=128)
    p.add_argument("--eval-games", type=int, default=64)
    p.add_argument("--team-size", type=int, default=1,
                   help="heroes a side: 1 (the 1v1 demo), 2, or 5 (the 5v5 game shape)")
    p.add_argument("--max-dota-time", type=float, default=300.0,
                   help="episode horizon in game seconds (a timeout adjudicates unfinished games)")
    p.add_argument("--hero-pool", type=str, default=None,
                   help="comma-separated hero ids (default: one hero at team size 1, {1,2,3} otherwise)")
    p.add_argument("--opponent", type=str, default="scripted_easy",
                   choices=("scripted_easy", "scripted_hard", "selfplay", "league"),
                   help="training opponent (the evals always play both scripted bots); 'league' trains "
                   "against frozen snapshots of past selves (tune with --league)")
    p.add_argument("--league", type=str, default=None, metavar="K=V,...",
                   help="comma-separated LeagueConfig overrides with --opponent league, e.g. "
                   "'anchor_prob=0.25,snapshot_every=200,pool_size=8'")
    p.add_argument("--ppo", type=str, default=None, metavar="K=V,...",
                   help="comma-separated PPOConfig overrides, e.g. 'entropy_coef=0.001,learning_rate=1e-4'")
    p.add_argument("--reward", type=str, default=None, metavar="K=V,...",
                   help="comma-separated RewardConfig overrides, e.g. 'win=25,tower_damage=20'")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--restore", action="store_true",
                   help="resume from the newest checkpoint in --checkpoint-dir instead of step 0")
    p.add_argument("--init-from", type=str, default=None, metavar="DIR",
                   help="seed a fresh run with the params of the newest checkpoint in DIR (never written to)")
    p.add_argument("--actor", type=str, default="fused", choices=("fused", "device"),
                   help="fused: rollout and update on the same chunk in one step; device: the buffered learner "
                   "(trajectory ring, one-pass advantages, epoch step)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="with --actor fused: rollout and update iterations in one fused call")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA card; 'cpu' must be asked for)")
    p.add_argument("--core", type=str, default="lstm", choices=("lstm", "transformer"),
                   help="policy core: the LSTM(128), or the windowed-attention transformer (rolling KV-cache "
                   "carry)")
    p.add_argument("--moe-experts", type=int, default=0, help="with --core transformer: experts per MoE FFN layer")
    p.add_argument("--logdir", type=str, default=None, help="tensorboardX scalars of the learner here")
    p.add_argument("--metrics-jsonl", type=str, default=None, metavar="PATH",
                   help="append the learner's log-boundary records as JSON lines to PATH (pair with --log-every "
                   "for dense outcome curves)")
    p.add_argument("--log-every", type=int, default=None,
                   help="log-boundary cadence in optimizer steps (default: 10,000 with --logdir, else none: a "
                   "boundary inside a block resets the windowed stats the demo prints)")
    args = p.parse_args(argv)
    if args.steps_per_dispatch > 1 and args.actor != "fused":
        p.error("--steps-per-dispatch needs --actor fused")
    if args.restore and not args.checkpoint_dir:
        p.error("--restore needs --checkpoint-dir")
    if args.init_from and args.restore:
        p.error("--init-from and --restore are mutually exclusive")

    from dotaclient_tpu_torch.config import PPOConfig, RewardConfig, default_config
    from dotaclient_tpu_torch.device import resolve_device
    from dotaclient_tpu_torch.league import evaluate
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner, apply_league_flags
    from dotaclient_tpu_torch.utils.overrides import parse_dataclass_overrides

    config = default_config()
    if args.hero_pool is not None:
        try:
            hero_pool = tuple(int(h) for h in args.hero_pool.split(","))
        except ValueError:
            p.error(f"--hero-pool: not a comma-separated id list: {args.hero_pool!r}")
        bad = [h for h in hero_pool if not 0 <= h < config.model.n_hero_ids]
        if bad:
            # an out-of-range id would alias another hero's embedding row
            p.error(f"--hero-pool: ids must be in [0, {config.model.n_hero_ids}): {bad}")
    else:
        hero_pool = (1,) if args.team_size == 1 else (1, 2, 3)
    try:
        ppo_over = parse_dataclass_overrides(PPOConfig, args.ppo, "--ppo") if args.ppo else {}
        reward_over = parse_dataclass_overrides(RewardConfig, args.reward, "--reward") if args.reward else {}
        config = apply_league_flags(config, args.opponent, args.league)
    except ValueError as e:
        p.error(str(e))
    config = dataclasses.replace(
        config,
        reward=dataclasses.replace(config.reward, **reward_over),
        ppo=dataclasses.replace(config.ppo, **ppo_over),
        model=dataclasses.replace(config.model, core=args.core, moe_experts=args.moe_experts),
        env=dataclasses.replace(config.env, n_envs=args.n_envs, opponent=args.opponent,
                                max_dota_time=args.max_dota_time, team_size=args.team_size,
                                hero_pool=hero_pool),
        # no log boundary by default: a drain mid-block would reset the
        # windowed stats each block prints
        log_every=args.log_every if args.log_every is not None else (10_000 if args.logdir else 1_000_000_000),
        steps_per_dispatch=args.steps_per_dispatch,
        seed=args.seed,
    )
    device = resolve_device(args.device)
    learner = Learner(config, actor=args.actor, seed=args.seed, device=device, checkpoint_dir=args.checkpoint_dir,
                      restore=args.restore, init_from=args.init_from, logdir=args.logdir,
                      metrics_jsonl=args.metrics_jsonl)
    policy = learner.policy
    # after --restore (or --init-from) the "initial" evals baseline the
    # restored policy; restored_step says so
    restored_step = learner.state.step if args.restore else learner.init_from_step
    init_params = {k: v.detach().clone() for k, v in policy.state_dict().items()}
    launches0, eval_collects = lstm.lstm_sequence_kernel.launches, []

    def run_eval(params, opponent, opponent_params=None):
        result = evaluate(config, policy, params, opponent, opponent_params=opponent_params,
                          n_games=args.eval_games, seed=7, device=device)
        eval_collects.append(result["collects"])
        return result

    print(f"== eval: INITIAL policy (step {restored_step}) ==", flush=True)
    init_easy = run_eval(init_params, "scripted_easy")
    init_hard = run_eval(init_params, "scripted_hard")
    print(f"init vs easy: {init_easy}", flush=True)
    print(f"init vs hard: {init_hard}", flush=True)

    print(f"== train: {args.steps} optimizer steps vs {args.opponent} ==", flush=True)
    t0 = time.time()
    block = 1000
    curve = []
    done_steps = 0
    while done_steps < args.steps:
        n = min(block, args.steps - done_steps)
        learner.train(n)
        done_steps += n
        # the block's window: the end of train drained it
        s = learner.device_actor.stats()
        curve.append({"step": done_steps, "win_rate_recent": round(s["win_rate_recent"], 3),
                      "ep_reward_recent": round(s["ep_reward_recent"], 3)})
        print(f"[{time.time() - t0:7.1f}s] step {done_steps}: win_rate_recent={s['win_rate_recent']:.3f} "
              f"ep_reward_recent={s['ep_reward_recent']:.2f} episodes={s['episodes_done']:.0f}", flush=True)

    trained = policy.state_dict()
    print("== eval: TRAINED policy ==", flush=True)
    final_easy = run_eval(trained, "scripted_easy")
    final_hard = run_eval(trained, "scripted_hard")
    vs_past = run_eval(trained, "league", opponent_params=init_params)
    summary = {
        "steps": args.steps,
        "team_size": args.team_size,
        "core": args.core,
        "actor": args.actor,
        "device": str(device),
        "restored_step": restored_step,
        "frames": args.steps * config.ppo.rollout_len * (
            learner.device_actor.n_lanes if args.actor == "fused" else config.ppo.batch_rollouts),
        "wall_sec": round(time.time() - t0, 1),
        "init_win_vs_easy": round(init_easy["win_rate"], 3),
        "init_win_vs_hard": round(init_hard["win_rate"], 3),
        "final_win_vs_easy": round(final_easy["win_rate"], 3),
        "final_win_vs_hard": round(final_hard["win_rate"], 3),
        "final_win_vs_initial_self": round(vs_past["win_rate"], 3),
        "reward_first_block": curve[0]["ep_reward_recent"] if curve else None,
        "reward_last_block": curve[-1]["ep_reward_recent"] if curve else None,
        "lstm_seq_launches": lstm.lstm_sequence_kernel.launches - launches0,
        "eval_collects": eval_collects,
    }
    learner.close()
    print("DEMO_SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

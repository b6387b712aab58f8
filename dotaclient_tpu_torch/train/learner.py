"""The learner, fused mode: self-play PPO on one card.

Counterpart of the fused branch of ``dotaclient_tpu/train/learner.py``
(``Learner(config, actor="fused")``, its training loop and ``train``'s
return dict) and of its ``--smoke`` entry point. Run on the card::

    python -m dotaclient_tpu_torch.train.learner --smoke [--steps N] [--n-envs N]
        [--opponent scripted_easy|scripted_hard|selfplay|league] [--league K=V,...]
        [--seed S] [--device cuda|cpu]
        [--checkpoint-dir DIR [--checkpoint-every N] [--restore]] [--init-from DIR]

Each loop iteration is one call of the fused step (``train/fused.py``):
``steps_per_dispatch`` rollouts and ``epochs_per_batch x minibatches``
updates each. The host reads the device only between iterations: at log
boundaries (every ``log_every`` optimizer steps) the metrics and the
drained episode stats, and with ``checkpoint_dir`` the whole train state at
``checkpoint_every`` boundaries and once more at the end of ``train``
(``utils/checkpoint.py``; ``restore`` resumes from the newest valid step).
``init_from`` seeds a fresh run with the weights of another run's newest
valid checkpoint: fresh Adam moments, step 0, the source left untouched.

League mode (``env.opponent="league"``) plays the Dire side against
frozen past selves (``league/pool.py``). The pool is seeded with the
initial params at step 0 (after ``init_from`` or ``restore``), snapshots
every ``snapshot_every`` steps, and its draw is held for ``opponent_hold``
steps. Each call's episode outcomes against a snapshot stay on the device
until the flush at a log boundary or at the end of ``train``, the one
read that PFSP's win rates cost.

Not ported yet, each with its ROADMAP item: the other actor modes
(``device``, ``vec``, ``scalar``, ``external``; queue 1, item 4), the
health guardian's rollback (item 4), async checkpoint saves and the CUDA
graph of the iteration (item 3) and the learner's transports (item 4).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
from dotaclient_tpu_torch.config import LeagueConfig, RunConfig, default_config
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.league.pool import LIVE, OpponentPool
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.train.fused import make_fused_step
from dotaclient_tpu_torch.train.ppo import init_train_state
from dotaclient_tpu_torch.utils import telemetry
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager, shape_mismatches
from dotaclient_tpu_torch.utils.overrides import parse_dataclass_overrides

# actor modes of the reference learner that the port does not have yet
_NOT_PORTED = {
    "device": "ROADMAP queue 1, item 4 (the buffered learner path)",
    "vec": "ROADMAP queue 1, item 4 (the buffered learner path)",
    "scalar": "ROADMAP queue 1, item 4 (the buffered learner path)",
    "external": "ROADMAP queue 1, items 1 and 4 (the socket lane and the buffered learner path)",
}


class Learner:
    """Fused-mode learner: params from ``init_params`` with ``seed`` (or,
    with ``restore``, from the newest valid checkpoint in
    ``checkpoint_dir``; or, with ``init_from``, the weights alone of the
    newest valid checkpoint in that other directory), one device actor over
    ``config.env.n_envs`` games, one fused step."""

    def __init__(
        self,
        config: RunConfig,
        actor: str = "fused",
        seed: int = 0,
        device: DeviceLike = None,
        registry: Optional[telemetry.Registry] = None,
        checkpoint_dir: Optional[str] = None,
        restore: bool = False,
        init_from: Optional[str] = None,
    ) -> None:
        if actor != "fused":
            where = _NOT_PORTED.get(actor)
            if where is None:
                raise ValueError(f"unknown actor mode {actor!r}")
            raise NotImplementedError(f"actor mode {actor!r} is not ported yet: {where}")
        if config.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {config.steps_per_dispatch}")
        league_on = config.league.enabled or config.env.opponent == "league"
        stride = config.steps_per_dispatch * config.ppo.steps_per_batch
        if league_on and stride > config.league.opponent_hold:
            # the opponent is redrawn only between calls, so a shorter hold
            # would silently stretch to the stride
            raise ValueError(
                f"league.opponent_hold ({config.league.opponent_hold}) is shorter than one dispatch stride "
                f"(steps_per_dispatch x steps_per_batch = {stride}): raise opponent_hold or lower "
                "steps_per_dispatch"
            )
        self.config = config
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else telemetry.get_registry()
        self.policy = make_policy(config.model, config.obs, config.actions, device=self.device)
        init_params(self.policy, torch.Generator().manual_seed(seed))
        self.init_from_step = 0  # the source's step when seeded by init_from
        if init_from:
            self.init_from_step = self._seed_from(init_from, checkpoint_dir, restore)
        self.state = init_train_state(self.policy, config.ppo)
        self.ckpt: Optional[CheckpointManager] = None
        if checkpoint_dir:
            self.ckpt = CheckpointManager(checkpoint_dir, registry=self.registry)
            if restore and self.ckpt.latest_step() is not None:
                self.state, _ = self.ckpt.restore(config, self.state)
        elif restore:
            raise ValueError("restore needs a checkpoint_dir")
        # the anchor of anchor_kl is the policy as constructed (after
        # init_from or restore), frozen
        self.anchor = None
        if config.ppo.anchor_kl_coef > 0:
            self.anchor = copy.deepcopy(self.policy).requires_grad_(False)
        # league: frozen opponents for the Dire lanes, seeded with the
        # initial params so those lanes never mirror the live policy unasked
        self.league: Optional[OpponentPool] = None
        self._league_pending: List[Tuple[int, Dict[str, Any]]] = []
        self._held_opponent: Optional[Tuple[Optional[Dict[str, torch.Tensor]], int]] = None
        self._held_until = -1
        if config.env.opponent == "league":
            self.league = OpponentPool(config.league, seed=seed)
            self.league.maybe_snapshot(self.policy.state_dict(), self.state.version, 0)
        self.device_actor = DeviceActor(config, self.policy, seed=seed, registry=self.registry,
                                        device=self.device)
        self.fused_step = make_fused_step(config, self.device_actor, anchor=self.anchor)
        self._last_metrics: Dict[str, float] = {}
        self.history: List[Dict[str, float]] = []

    def _seed_from(self, init_from: str, checkpoint_dir: Optional[str], restore: bool) -> int:
        """Load the weights of ``init_from``'s newest valid checkpoint into
        the policy; returns that checkpoint's step. The optimizer and the
        step counter stay fresh: Adam moments fitted to the source run's
        gradients could over-step the transferred policy."""
        if restore:
            raise ValueError(
                "init_from seeds a fresh run from a source checkpoint; restore resumes this run's own "
                "checkpoint_dir: they are mutually exclusive"
            )
        if checkpoint_dir and os.path.realpath(init_from) == os.path.realpath(checkpoint_dir):
            raise ValueError(
                "init_from must point at a separate source directory: the seeded run starts at step 0, so "
                "its saves into the source directory would overwrite the source's steps"
            )
        if not os.path.isdir(init_from):
            # CheckpointManager would create it: a mistyped path fails instead
            raise FileNotFoundError(f"init_from directory does not exist: {init_from!r}")
        params, step = CheckpointManager(init_from, registry=self.registry).restore_weights()
        bad = shape_mismatches(params, self.policy.state_dict())
        if bad:
            raise ValueError(
                f"init_from checkpoint is incompatible with this run's model config (param shape {bad[0]}, "
                f"+{len(bad) - 1} more mismatches): was it trained with another core or width?"
            )
        self.policy.load_state_dict(params)
        return step

    def _league_opponent(self) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        """Snapshot if due, and the opponent of the next call: (a
        snapshot's params, or None for the live policy; the snapshot's uid
        or ``LIVE``). A draw is held for ``opponent_hold`` optimizer steps,
        so most of an episode plays one opponent and the outcomes PFSP
        reads are not diluted toward the pool's mean; an episode across a
        redraw credits its last opponent."""
        if self.league is None:
            return None, LIVE
        self.league.maybe_snapshot(self.policy.state_dict(), self.state.version, self.state.step)
        if self._held_opponent is None or self.state.step >= self._held_until:
            params, _, uid = self.league.sample_indexed(None, self.state.version)
            self._held_opponent = (params, uid)
            self._held_until = self.state.step + self.config.league.opponent_hold
        return self._held_opponent

    def _report_league(self, uid: int, chunk_stats: Dict[str, Any]) -> None:
        """Queue one call's device-resident outcomes against the snapshot
        that played them; they are read in one batch at the next flush."""
        if self.league is None or uid == LIVE:
            return
        self._league_pending.append((uid, chunk_stats))
        if len(self._league_pending) >= 64:
            self._flush_league_reports()

    def _flush_league_reports(self) -> None:
        """Read the queued outcomes (one read of the device) into the pool's
        PFSP record. Anchor games are left out: the snapshot never played
        them (``league_episodes`` and ``league_wins``)."""
        if not self._league_pending:
            return
        pending, self._league_pending = self._league_pending, []
        stacked = torch.stack([torch.stack([st["league_wins"].sum(), st["league_episodes"].sum()])
                               for _, st in pending]).cpu().numpy()
        for (uid, _), (wins, games) in zip(pending, stacked):
            self.league.report(uid, float(wins), float(games))

    def _league_log(self) -> Dict[str, float]:
        """The pool's part of a log line, after a flush."""
        if self.league is None:
            return {}
        self._flush_league_reports()
        wrs = self.league.win_rates()
        out = {"league_snapshots": float(len(wrs))}
        if wrs:
            out["league_winrate_mean"] = float(np.mean(wrs))
        return out

    def train(self, num_steps: int) -> Dict[str, float]:
        """Run until ``num_steps`` optimizer steps have completed (rounded
        up to whole fused calls), then save a checkpoint (with
        ``checkpoint_dir``). Returns the last logged metrics, the
        actor's stats (``actor_*``), ``optimizer_steps``,
        ``frames_trained``, ``frames_per_sec`` and ``elapsed_sec``."""
        cfg = self.config
        da = self.device_actor
        k_iters = cfg.steps_per_dispatch
        stride = cfg.ppo.steps_per_batch * k_iters
        frames_per = da.n_lanes * cfg.ppo.rollout_len * k_iters
        t_start = time.time()
        frames_trained = 0
        steps_done = 0
        while steps_done < num_steps:
            opp_params, opp_uid = self._league_opponent()
            self.state, da.state, metrics, chunk_stats = self.fused_step(self.state, da.state, opp_params)
            self._report_league(opp_uid, chunk_stats)
            da.env_steps += frames_per
            da.rollouts_shipped += da.n_lanes * k_iters
            steps_done += stride
            frames_trained += frames_per
            if self.state.step % cfg.log_every < stride:
                # log boundary: the one read of the device
                self._last_metrics = {k: float(v) for k, v in metrics.items()}
                self._last_metrics.update(da.drain_stats())
                self._last_metrics.update(self._league_log())
                self.history.append({"step": float(self.state.step), **self._last_metrics})
            # `< stride`: the step counter advances in strides and may step
            # over exact multiples
            if self.ckpt is not None and self.state.step % cfg.checkpoint_every < stride:
                self.ckpt.save(self.state, cfg)
        self._flush_league_reports()
        if self.ckpt is not None:
            # the end-of-run save lands at the exact stop step and raises
            # on an I/O error
            self.ckpt.save(self.state, cfg, force=True)
        elapsed = time.time() - t_start
        actor_stats = da.stats()
        return {
            **self._last_metrics,
            **{f"actor_{k}": v for k, v in actor_stats.items()},
            "optimizer_steps": float(steps_done),
            "frames_trained": float(frames_trained),
            "frames_per_sec": frames_trained / max(elapsed, 1e-9),
            "elapsed_sec": elapsed,
        }


def smoke_config(config: RunConfig) -> RunConfig:
    """The reference learner's ``--smoke`` sizes: 4 games of 60 s, chunks of
    8 steps, a log line every step."""
    return dataclasses.replace(
        config,
        env=dataclasses.replace(config.env, n_envs=4, max_dota_time=60.0),
        ppo=dataclasses.replace(config.ppo, rollout_len=8, batch_rollouts=8),
        buffer=dataclasses.replace(config.buffer, capacity_rollouts=32, min_fill=8),
        log_every=1,
    )


def apply_league_flags(config: RunConfig, opponent: Optional[str], league: Optional[str]) -> RunConfig:
    """``--league K=V,...`` into ``config.league``. ``--opponent league``
    defaults ``enabled=True`` (an explicit ``enabled=false`` stands), so
    the checkpointed config says what ran; ``--league`` without it is an
    error (``ValueError``)."""
    if league and opponent != "league":
        raise ValueError("--league overrides need --opponent league")
    over = parse_dataclass_overrides(LeagueConfig, league, "--league") if league else {}
    if opponent == "league":
        over.setdefault("enabled", True)
    return dataclasses.replace(config, league=dataclasses.replace(config.league, **over))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Fused self-play PPO learner on one CUDA card.")
    p.add_argument("--smoke", action="store_true", help="tiny sizes, at most 5 steps")
    p.add_argument("--steps", type=int, default=1000, help="optimizer steps")
    p.add_argument("--n-envs", type=int, default=None, help="games (default: the config's)")
    p.add_argument("--opponent", type=str, default=None,
                   choices=("scripted_easy", "scripted_hard", "selfplay", "league"),
                   help="'league' plays the Dire side against frozen past selves (tune with --league)")
    p.add_argument("--league", type=str, default=None, metavar="K=V,...",
                   help="comma-separated LeagueConfig overrides (with --opponent league), e.g. "
                   "'anchor_prob=0.25,snapshot_every=200'")
    p.add_argument("--actor", type=str, default="fused",
                   choices=("fused", "device", "vec", "scalar", "external"))
    p.add_argument("--steps-per-dispatch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="write checkpoints here (every --checkpoint-every steps and at the end)")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="optimizer steps between periodic checkpoints (default RunConfig.checkpoint_every)")
    p.add_argument("--restore", action="store_true",
                   help="resume from the newest valid checkpoint in --checkpoint-dir")
    p.add_argument("--init-from", type=str, default=None, metavar="DIR",
                   help="seed a fresh run with the params of the newest checkpoint in DIR (the source stays "
                   "untouched; not with --restore)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA card; 'cpu' must be asked for)")
    args = p.parse_args(argv)

    config = default_config()
    if args.smoke:
        config = smoke_config(config)
        args.steps = min(args.steps, 5)
    env_over = {}
    if args.n_envs is not None:
        env_over["n_envs"] = args.n_envs
    if args.opponent is not None:
        env_over["opponent"] = args.opponent
    if env_over:
        config = dataclasses.replace(config, env=dataclasses.replace(config.env, **env_over))
    if args.steps_per_dispatch is not None:
        config = dataclasses.replace(config, steps_per_dispatch=args.steps_per_dispatch)
    if args.checkpoint_every is not None:
        config = dataclasses.replace(config, checkpoint_every=args.checkpoint_every)
    if args.restore and not args.checkpoint_dir:
        p.error("--restore needs --checkpoint-dir")
    try:
        config = apply_league_flags(config, args.opponent, args.league)
    except ValueError as e:
        p.error(str(e))
    config = dataclasses.replace(config, seed=args.seed)

    learner = Learner(config, actor=args.actor, seed=args.seed, device=args.device,
                      checkpoint_dir=args.checkpoint_dir, restore=args.restore, init_from=args.init_from)
    out = learner.train(args.steps)
    for row in learner.history:
        print(json.dumps({k: round(v, 6) for k, v in row.items()}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The learner: self-play PPO on one card, buffered or fused.

Counterpart of ``dotaclient_tpu/train/learner.py`` (``Learner(config,
actor=...)``, its training loops, the health guardian, the snapshot
engine's boundaries, the run record, best-model rotation, ``train``'s
return dict) and of its CLI. Run on the card::

    python -m dotaclient_tpu_torch.train.learner [--smoke] [--steps N] [--actor device|fused]
        [--n-envs N] [--team-size N] [--opponent scripted_easy|scripted_hard|selfplay|league]
        [--league K=V,...] [--ppo K=V,...] [--reward K=V,...] [--serve K=V,...] [--buffer K=V,...]
        [--health K=V,...] [--learner K=V,...] [--sync-snapshots]
        [--seed S] [--device cuda|cpu] [--metrics-jsonl PATH] [--logdir DIR] [--profile DIR]
        [--checkpoint-dir DIR [--checkpoint-every N] [--restore] [--on-crash-checkpoint]]
        [--init-from DIR]

Two actor modes, ``device`` the default as in the reference:

* ``device``, the buffered learner: each iteration ``DeviceActor.collect``
  rolls out every game on the card, ``TrajectoryBuffer.add_device`` puts
  the chunks in the ring, and every ``batch_rollouts`` chunks taken from
  it (``_next_batch``, with the prefetch lane's hold and release) get the
  one-pass advantage pass (``train/advantage.py``) and ``epochs_per_batch
  x minibatches`` updates (``_optimize``: one epoch-step call), the
  minibatch permutations drawn on the host from ``default_rng(seed + 1)``;
* ``fused``: one call of ``train/fused.py`` a loop iteration, rollout and
  update on the same chunk.

Around both loops, as in the reference: the health guardian
(``train/health.py``; every batch's verdict tensors are queued with no
read, folded on the snapshot engine's thread at boundaries, and a
latched divergence blocks publishes and checkpoints and rolls the state
back to the ``last_good`` save, dropping the poisoned timeline's saves,
buffered experience and recurrent carries); the snapshot engine
(``train/snapshot.py``; at a log, checkpoint or publish boundary the train
thread only queues on-device clones); the end of ``train`` (the rollback
re-entry, the last stat drain, the final publish, the forced save with
the whole pipeline: the ring, the device actor's state and RNG, the
minibatch draw count, so ``restore`` resumes exactly); and
``request_stop`` (the CLI's first SIGTERM or SIGINT drains and saves; a
second one kills).

The run record, as the reference's: every log boundary goes through
``MetricsLogger`` (``utils/metrics.py``: the console line, tensorboardX
with ``logdir`` when it is installed, the ``metrics_jsonl`` file), each
line carrying the registry's snapshot, and the end of ``train`` closes the
file with one more line. At each boundary ``_publish_pipeline_gauges``
sets the actor's weight staleness (0: the device actor plays the live
params), the prefetch lane's hit rate and overlap fractions, the memory
peak, the outcome curves (``outcome/aggregator.py``) and the utilization
fold (``utils/utilization.py``: host wall-clock phases of the train
thread). A ``FleetAggregator`` (``utils/fleet.py``) is built on every run,
which creates the fleet and alert keys; its thread starts only in the
external modes. Best-model rotation keeps ``<checkpoint_dir>/best`` at the
best windowed win rate of ``checkpoint_best_min_episodes`` episodes or
more (``best_meta.json`` holds it), and the CLI's ``--on-crash-checkpoint``
saves the weights before an unexpected error is re-raised.

The host reads the device only at those boundaries and at the end of
``train``; between them the loops issue work and read host ints.
``init_from`` seeds a fresh run with the weights of another run's newest
valid checkpoint: fresh Adam moments, step 0, the source left untouched.

League mode (``env.opponent="league"``) plays the Dire side against frozen
past selves (``league/pool.py``): snapshots every ``snapshot_every`` steps,
draws held for ``opponent_hold`` steps, and PFSP outcomes read in one
batch at a log boundary or the end of ``train``.

Not ported yet, each with its ROADMAP item: the ``vec``, ``scalar`` and
``external`` actor modes and the learner's transports (queue 1, items 4b
and 4c; the in-process transport is here), the weights pushes to
in-process host pools (with the ``vec`` mode), the transformer and MoE
cores (item 6), the mesh (item 7), the trace plane and the fleet
fanout (item 8) and the JAX debug and cache flags (item 12). Their CLI
flags are accepted and raise ``NotImplementedError`` naming the item.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.actor.device_rollout import DeviceActor, flatten_state, unflatten_state
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.config import (
    BufferConfig, HealthConfig, LeagueConfig, LearnerConfig, PPOConfig, RewardConfig, RunConfig, ServeConfig,
    default_config,
)
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.league.pool import LIVE, OpponentPool
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.outcome import records as outcome_records
from dotaclient_tpu_torch.outcome.aggregator import OutcomeAggregator
from dotaclient_tpu_torch.train.advantage import make_advantage_pass, one_pass_enabled
from dotaclient_tpu_torch.train.fused import make_fused_step
from dotaclient_tpu_torch.train.health import VERDICT_KEYS, HealthMonitor
from dotaclient_tpu_torch.train.ppo import init_train_state, make_epoch_step, make_train_step
from dotaclient_tpu_torch.train.snapshot import SnapshotEngine, device_copy
from dotaclient_tpu_torch.transport.queues import InProcTransport
from dotaclient_tpu_torch.transport.serialize import encode_weights
from dotaclient_tpu_torch.utils import faults, telemetry, tracing, utilization
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager, shape_mismatches
from dotaclient_tpu_torch.utils.fleet import FleetAggregator
from dotaclient_tpu_torch.utils.metrics import MetricsLogger
from dotaclient_tpu_torch.utils.overrides import parse_dataclass_overrides
from dotaclient_tpu_torch.utils.profiling import trace

ACTOR_MODES = ("device", "fused", "vec", "scalar", "external")
# actor modes of the reference learner that the port does not have yet
_NOT_PORTED = {
    "vec": "ROADMAP queue 1, item 4b (external actors and the learner's transports)",
    "scalar": "ROADMAP queue 1, item 4c (the scalar path)",
    "external": "ROADMAP queue 1, item 4b (external actors and the learner's transports)",
}


class Learner:
    """Params from ``init_params`` with ``seed`` (or, with ``restore``, the
    newest valid checkpoint in ``checkpoint_dir``, pipeline included; or,
    with ``init_from``, the weights alone of the newest valid checkpoint in
    that other directory), one device actor over ``config.env.n_envs``
    games, and the ``actor`` mode's loop: ``device`` (the buffered learner)
    or ``fused``. ``logdir`` and ``metrics_jsonl`` add the tensorboardX and
    JSONL sinks to the run record; ``close`` lands the pending checkpoint
    writes and closes the record."""

    def __init__(
        self,
        config: RunConfig,
        actor: str = "device",
        seed: int = 0,
        device: DeviceLike = None,
        registry: Optional[telemetry.Registry] = None,
        checkpoint_dir: Optional[str] = None,
        restore: bool = False,
        init_from: Optional[str] = None,
        logdir: Optional[str] = None,
        metrics_jsonl: Optional[str] = None,
    ) -> None:
        if actor not in ACTOR_MODES:
            raise ValueError(f"unknown actor mode {actor!r}")
        if actor in _NOT_PORTED:
            raise NotImplementedError(f"actor mode {actor!r} is not ported yet: {_NOT_PORTED[actor]}")
        if config.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {config.steps_per_dispatch}")
        if config.steps_per_dispatch > 1 and actor != "fused":
            raise ValueError("steps_per_dispatch > 1 batches iterations inside the fused step; it has no meaning "
                             "for the buffered learner: use actor='fused' or leave it at 1")
        if actor == "device" and config.ppo.batch_rollouts % max(1, config.ppo.minibatches):
            raise ValueError(f"batch_rollouts {config.ppo.batch_rollouts} not divisible by minibatches "
                             f"{config.ppo.minibatches}")
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
        self.actor_mode = actor
        self.config = config
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else telemetry.get_registry()
        tracing.ensure_metrics(self.registry)
        self.policy = make_policy(config.model, config.obs, config.actions, device=self.device)
        init_params(self.policy, torch.Generator().manual_seed(seed))
        self.init_from_step = 0  # the source's step when seeded by init_from
        if init_from:
            self.init_from_step = self._seed_from(init_from, checkpoint_dir, restore)
        self.state = init_train_state(self.policy, config.ppo)
        self.ckpt: Optional[CheckpointManager] = None
        # best-model rotation: <checkpoint_dir>/best at the best windowed
        # win rate; its manager is made at the first qualifying save (a
        # run that never qualifies leaves no empty tree), but the best so
        # far loads now, so a resumed run cannot let its first window
        # displace the kept peak
        self.ckpt_best: Optional[CheckpointManager] = None
        self._best_dir: Optional[str] = None
        self._best_win = -1.0
        if checkpoint_dir:
            self.ckpt = CheckpointManager(checkpoint_dir, registry=self.registry)
            if restore and self.ckpt.latest_step() is not None:
                self.state, _ = self.ckpt.restore(config, self.state)
            if config.checkpoint_best_min_episodes > 0:
                self._best_dir = os.path.join(checkpoint_dir, "best")
                self._best_win = self._load_best_win()
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
        self.fused_step = None
        self.train_step = self.epoch_step = self.advantage_pass = None
        self.buffer: Optional[TrajectoryBuffer] = None
        if actor == "fused":
            self.fused_step = make_fused_step(config, self.device_actor, anchor=self.anchor)
        else:
            self.train_step = make_train_step(config, anchor=self.anchor)
            # ppo.fused_epoch picks nothing here: the reference's staged
            # loop and its scanned epoch are the same Python loop in torch
            if config.ppo.steps_per_batch > 1:
                self.epoch_step = make_epoch_step(config, anchor=self.anchor)
            if one_pass_enabled(config):
                self.advantage_pass = make_advantage_pass(self.policy, config)
            self.buffer = TrajectoryBuffer(config, device=self.device, registry=self.registry)
        reg = self.registry
        reg.gauge("advantage/one_pass").set(1.0 if self.advantage_pass is not None else 0.0)
        reg.gauge("advantage/pass_ms")
        reg.gauge("advantage/overlap_fraction")
        reg.counter("advantage/passes_total")
        self.transport = InProcTransport(registry=self.registry)
        self._health: Optional[HealthMonitor] = None
        if config.health.enabled:
            self._health = HealthMonitor(config.health, registry=self.registry)
        self._rollback_count = 0
        # the last batch's verdict tensors (the sync-snapshots gap-closer)
        self._last_verdict_m: Optional[Dict[str, torch.Tensor]] = None
        self._published_version = -1   # the sync path's publish floor
        # a best-model candidate the engine's metrics continuation leaves
        # for the train thread (which alone reads self.state), swapped
        # under the lock so a concurrent write is never lost
        self._pending_best: Optional[Dict[str, float]] = None
        self._pending_best_lock = threading.Lock()
        self._snap_engine: Optional[SnapshotEngine] = None
        if config.learner.async_snapshots:
            self._snap_engine = SnapshotEngine(transport=self.transport, wire_dtype=config.transport.wire_dtype,
                                               ckpt=self.ckpt, registry=self.registry, health=self._health)
        for key in ("learner/publish_stall_ms", "learner/stall_fraction", "snapshot/pending", "snapshot/d2h_ms"):
            reg.gauge(key)
        self._stall_s = 0.0   # train-thread seconds spent at boundaries
        # the run record and the planes it reads: the fleet aggregator
        # (built on every run for its keys; its thread starts only in the
        # external modes) and the outcome curves, ticked here at log
        # boundaries
        self.metrics = MetricsLogger(logdir, jsonl=metrics_jsonl, registry=self.registry)
        self.fleet = FleetAggregator(registry=self.registry, emit_event=self.metrics.emit_event)
        outcome_records.ensure_actor_metrics(self.registry)
        self.outcome = OutcomeAggregator(registry=self.registry)
        self.fleet.add_tick_hook(self.outcome.tick)
        self._fleet_started = False
        self._util = utilization.make_learner(self.registry)
        self._mb_rng = np.random.default_rng(config.seed + 1)
        self._mb_draws = 0     # permutations drawn (replayed on restore)
        # the prefetch lane: batch N+1, taken and staged behind batch N's
        # updates, its slots held in the ring until released or requeued;
        # hits, misses and the host seconds of staging behind an update in
        # flight or not feed learner/prefetch_hit_rate and
        # learner/overlap_fraction
        self._prefetched: Optional[Dict[str, Any]] = None
        self._prefetch_ticket: Optional[int] = None
        self._prefetch_hits = self._prefetch_misses = 0
        self._prefetch_overlapped_s = self._prefetch_serial_s = 0.0
        self._adv_overlap = config.learner.overlap_advantage
        self._adv_overlapped_s = self._adv_serial_s = 0.0
        self._adv_first = True   # the first pass's time is left out
        # True between an update's issue and the next read of the device:
        # host work then overlaps the card's
        self._dispatch_inflight = False
        self._stop_requested = False
        self._faults = faults.get()   # None unless fault injection is on
        self._last_metrics: Dict[str, float] = {}
        # each log boundary's scalars, as logged before the registry's
        # snapshot joins them (the in-process record)
        self.history: List[Dict[str, float]] = []
        self._t_start = time.time()
        self._frames_trained = 0
        self._steps_done = 0
        if restore and self.ckpt is not None and self.ckpt.latest_step() is not None:
            self._restore_pipeline()

    def _load_best_win(self) -> float:
        """The best win rate kept in ``best/best_meta.json``, -1 without
        one; +inf (rotation frozen, loudly) when it cannot be read, so a
        resumed run never replaces a kept peak it cannot compare with."""
        meta = os.path.join(self._best_dir, "best_meta.json")
        if not os.path.exists(meta):
            return -1.0
        try:
            with open(meta) as f:
                return float(json.load(f)["win_rate_recent"])
        except (OSError, ValueError, KeyError, TypeError):
            print(f"WARNING: {meta} unreadable: best-model rotation frozen to protect the existing best/ "
                  "checkpoint; delete the directory to reset it", flush=True)
            return float("inf")

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

    # -- stopping ------------------------------------------------------------

    def request_stop(self) -> None:
        """Make the running ``train`` leave its loop at the next step
        boundary; its end then saves the whole pipeline, so the run resumes
        at that exact step. One flag write: safe in a signal handler."""
        self._stop_requested = True

    def close(self) -> None:
        """Finish the snapshot engine's pending jobs and stop its thread,
        land the checkpoint writes, stop the fleet aggregator and close the
        run record."""
        if self._snap_engine is not None:
            self._snap_engine.stop()
        for mgr in (self.ckpt, self.ckpt_best):
            if mgr is not None:
                mgr.close()
        self.fleet.stop()
        self.metrics.close()

    # -- league ---------------------------------------------------------------

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

    # -- the buffered learner's batch path --------------------------------------

    def _optimize(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """``epochs_per_batch`` passes over one batch, each cut into
        ``minibatches`` shuffled slices, in one epoch-step call (one
        ``train_step`` when ``E x M`` is 1); the permutations come from
        ``_mb_rng``, one draw an epoch, counted in ``_mb_draws``. Reads
        nothing from the device. Returns the metrics (tensors): the epoch
        step's fold."""
        if self._faults is not None and self._faults.fire("learner.fail_train_step"):
            raise RuntimeError("injected fault: learner.fail_train_step")
        if self._faults is not None and self._faults.fire("learner.nan_grad"):
            # one NaN reward poisons the loss and the whole backward; a
            # one-pass batch gets it in its staged advantages too, or the
            # loss would never see it
            batch = dict(batch)
            for key in ("rewards", "advantages"):
                if key in batch:
                    poisoned = batch[key].clone()
                    poisoned[0, 0] = float("nan")
                    batch[key] = poisoned
        cfg = self.config.ppo
        E, M, B = cfg.epochs_per_batch, max(1, cfg.minibatches), cfg.batch_rollouts
        perms = None
        if self.epoch_step is not None:
            if M > 1:
                perms = np.stack([self._mb_rng.permutation(B) for _ in range(E)])
                self._mb_draws += E
            else:
                # an unsplit batch is never shuffled; the step ignores it
                perms = np.broadcast_to(np.arange(B), (E, B))
        t0 = time.perf_counter()
        with self.registry.span("learner/dispatch"):
            if self.epoch_step is None:
                self.state, m = self.train_step(self.state, batch)
            else:
                self.state, m = self.epoch_step(self.state, batch, perms)
        # the host's time issuing the updates (utils/utilization.py)
        self._util.phase("dispatch_inflight", time.perf_counter() - t0)
        self._dispatch_inflight = True
        self._submit_health(m)
        return m

    def _next_batch(self) -> Optional[Dict[str, Any]]:
        """The batch staged behind the previous update if there is one
        (its held slots released), else a take from the ring now; with its
        advantages attached. None when the ring cannot give a batch."""
        batch, self._prefetched = self._prefetched, None
        if batch is not None:
            self.buffer.release(self._prefetch_ticket)
            self._prefetch_ticket = None
            self._prefetch_hits += 1
            return self._attach_advantages(batch)
        t0 = time.perf_counter()
        batch = self.buffer.take(current_version=self.state.version)
        dt = time.perf_counter() - t0
        # a productive take is staging; an empty one, the ring below
        # its minimum
        self._util.phase("gather" if batch is not None else "ingest_wait", dt)
        if batch is None:
            return None
        self._prefetch_serial_s += dt
        self._prefetch_misses += 1
        return self._attach_advantages(batch)

    def _prefetch_next(self) -> None:
        """Take batch N+1 while batch N's updates run on the card: its
        slots are held (an ingest can neither evict nor overwrite them),
        and with ``learner.overlap_advantage`` its advantage pass is issued
        now, behind the updates, so it reads their output params, the
        params its first update trains from."""
        if self._prefetched is not None or self.buffer is None:
            return
        t0 = time.perf_counter()
        taken = self.buffer.take(current_version=self.state.version, hold=True)
        dt = time.perf_counter() - t0
        if taken is None:
            self._util.phase("ingest_wait", dt)
            return
        self._prefetched, self._prefetch_ticket = taken
        self._util.phase("gather", dt)
        # recorded only when a batch was staged
        self.registry.timer("span/learner/prefetch").observe(dt)
        if self._dispatch_inflight:
            self._prefetch_overlapped_s += dt
        else:
            self._prefetch_serial_s += dt
        if self._adv_overlap:
            self._prefetched = self._attach_advantages(self._prefetched, overlapped=self._dispatch_inflight)

    def _flush_prefetch(self) -> None:
        """Return an unconsumed prefetched batch to the front of the ring
        before anything that snapshots or ends the run. Staged advantages
        die with the batch: the next take reruns the pass with the params
        live then (the rollback relies on it)."""
        if self._prefetched is not None:
            self.buffer.requeue(self._prefetch_ticket)
            self._prefetched = None
            self._prefetch_ticket = None

    def _attach_advantages(self, batch: Dict[str, Any], overlapped: bool = False) -> Dict[str, Any]:
        """The one-pass advantage plane: the value forward and GAE once on
        a just-taken batch, ``advantages`` and ``returns`` attached at the
        staging dtype. Issues work, reads nothing. ``overlapped`` is the
        caller's word: only the prefetch lane issues the pass behind an
        update in flight (advantage/overlap_fraction)."""
        if self.advantage_pass is None or "advantages" in batch:
            return batch
        t0 = time.perf_counter()
        adv, ret = self.advantage_pass(batch)
        batch = {**batch, "advantages": adv, "returns": ret}
        dt = time.perf_counter() - t0
        self.registry.gauge("advantage/pass_ms").set(dt * 1e3)
        self.registry.counter("advantage/passes_total").inc()
        self._util.phase("advantage_pass", dt)
        if self._adv_first:
            # the first pass pays one-time costs (allocations, the kernel
            # library's load)
            self._adv_first = False
        elif overlapped:
            self._adv_overlapped_s += dt
        else:
            self._adv_serial_s += dt
        return batch

    # -- pipeline state (checkpoint and restore) ---------------------------------

    def _pipeline_state(self) -> Dict[str, Any]:
        """What a restore needs beyond the train state to resume the exact
        pipeline: the ring and its bookkeeping, the device actor's state
        (sim worlds, carries, episode accumulators) as flat leaves and its
        RNG, and the minibatch draw count. The prefetch lane is flushed
        first so the ring holds every unconsumed chunk."""
        self._flush_prefetch()
        out: Dict[str, Any] = {"buffer": self.buffer.state_dict()} if self.buffer is not None else {}
        out["actor_leaves"] = {f"{i:04d}": leaf for i, leaf in enumerate(flatten_state(self.device_actor.state))}
        out["actor_rng"] = self.device_actor.generator.get_state()
        out["mb_draws"] = torch.tensor(self._mb_draws, dtype=torch.int64)
        return out

    def _restore_pipeline(self) -> None:
        restored, reason = self.ckpt.restore_pipeline(self._pipeline_state())
        if restored is None:
            if reason:  # a mismatch is loud; a checkpoint without a pipeline is not
                print(f"WARNING: checkpoint pipeline state not restored ({reason}); resuming weights-only: "
                      "the ring's experience and the actor's games are lost", flush=True)
            return
        if self.buffer is not None and "buffer" in restored:
            self.buffer.load_state_dict(restored["buffer"])
        da = self.device_actor
        if "actor_leaves" in restored:
            leaves = [restored["actor_leaves"][k] for k in sorted(restored["actor_leaves"])]
            da.state = unflatten_state(da.state, [t.to(self.device) for t in leaves])
        if "actor_rng" in restored:
            da.generator.set_state(restored["actor_rng"])
        if "mb_draws" in restored:
            # replay the seeded shuffle stream to its saved position
            self._mb_draws = int(restored["mb_draws"])
            self._mb_rng = np.random.default_rng(self.config.seed + 1)
            for _ in range(self._mb_draws):
                self._mb_rng.permutation(self.config.ppo.batch_rollouts)

    # -- the health guardian -------------------------------------------------

    def _submit_health(self, m: Dict[str, torch.Tensor]) -> None:
        """Queue this batch's verdict tensors with the monitor (a host
        append); the boundary flush hands the backlog to the engine. The
        last batch's are kept for the sync-mode gap-closer."""
        if self._health is None:
            return
        self._last_verdict_m = {k: m[k] for k in VERDICT_KEYS if k in m}
        if self._snap_engine is not None:
            self._health.submit(self.state.step, self.state.version, m)

    def _sync_fold_latest(self) -> None:
        """Sync-snapshots mode: fold the last batch's verdict (a read of
        three scalars) before a checkpoint, publish or the end of the run
        marks a state, when the last log boundary may predate it."""
        if self._health is None or self._snap_engine is not None or self._last_verdict_m is None:
            return
        host = {k: float(v) for k, v in self._last_verdict_m.items()}
        self._health.fold_host(self.state.step, self.state.version, host)

    def _flush_health(self) -> None:
        """Hand every pending verdict to the engine's never-coalesced stats
        backlog, which it folds before the same cycle's publish and
        checkpoint jobs: the ordering that makes their gates sound."""
        if self._health is None or self._snap_engine is None:
            return
        pending = self._health.take_pending()
        if pending:
            self._snap_engine.submit_stats(device_copy(pending, clone=False), self._health.fold_batch)

    def _maybe_rollback(self) -> int:
        """Recover from a latched divergence: restore the ``last_good``
        save (else the newest valid one), keep the version counter moving
        forward past the poisoned range, drop the abandoned timeline's
        saves, buffered experience and recurrent carries, reseed the
        minibatch stream, and return the optimizer steps rewound (0 when
        healthy) so the caller's budget covers the retraining. Bounded by
        ``health.max_rollbacks``; without a checkpoint directory the
        publishes stay blocked and the run carries on."""
        if self._health is None or self._health.unhealthy is None:
            return 0
        ev = self._health.unhealthy
        if self.ckpt is None:
            if self._health.note_unrecoverable():
                print(f"WARNING: training health latched unhealthy ({ev.reason} at step {ev.step}) but no "
                      "checkpoint directory is configured: cannot roll back; weight publishes stay blocked",
                      flush=True)
            return 0
        if self._rollback_count >= self.config.health.max_rollbacks:
            raise RuntimeError(
                f"training health guardian: divergence persisted after {self.config.health.max_rollbacks} "
                f"rollback(s) ({ev.reason} at step {ev.step}, value {ev.value!r}): giving up; restart from "
                f"{os.path.join(self.ckpt.directory, 'last_good')}"
            )
        self._rollback_count += 1
        self.registry.counter("health/rollbacks_total").inc()
        # drain with the monitor still latched: a pending publish or
        # checkpoint of the poisoned timeline meets the gate and is refused
        self._drain_snapshots()
        published_floor = (self._snap_engine.last_published if self._snap_engine is not None
                           else self._published_version)
        from_step, from_version = self.state.step, self.state.version
        restored = self.ckpt.restore_last_good(self.config, self.state)
        if restored is None:
            # no verified slot yet: the newest valid main save (every main
            # save was itself health-gated)
            try:
                restored = self.ckpt.restore(self.config, self.state)
            except (FileNotFoundError, ValueError, RuntimeError) as e:
                raise RuntimeError(f"training health guardian: divergence at step {ev.step} ({ev.reason}) and no "
                                   f"checkpoint to roll back to ({type(e).__name__}: {e})") from e
        restored_version = self.state.version
        # the version counter skips the poisoned range: no version the
        # poisoned steps made is ever reused; the steps rewind
        self.state.version = from_version + 1
        rewound = from_step - self.state.step
        self.ckpt.discard_steps_above(self.state.step)
        if self.buffer is not None:
            self._flush_prefetch()
            self.buffer.drop_newer_than(restored_version)
        self.device_actor.reset_recurrent()
        # a distinct minibatch stream: the retry must not replay the one
        # that diverged
        self._mb_rng = np.random.default_rng(self.config.seed + 1 + 7919 * self._rollback_count)
        self._mb_draws = 0
        self._last_verdict_m = None
        self._health.clear()
        self.registry.gauge("health/last_good_step").set(float(self.state.step))
        print("HEALTH_ROLLBACK " + json.dumps({
            "reason": ev.reason, "detected_step": ev.step, "detected_version": ev.version,
            "from_step": from_step, "to_step": self.state.step, "restored_version": restored_version,
            "resumed_version": self.state.version, "published_floor": published_floor,
            "rollback": self._rollback_count,
        }, sort_keys=True), flush=True)
        return rewound

    # -- boundaries --------------------------------------------------------------

    def _train_state_tree(self) -> Dict[str, Any]:
        return {"step": self.state.step, "version": self.state.version, "params": self.policy.state_dict(),
                "opt_state": self.state.optimizer.state_dict()}

    def _publish_weights(self) -> None:
        """Hand the params to the transport's weights fanout behind the
        health gate. Async: an on-device clone, the engine does the rest;
        sync (``--sync-snapshots``): the read, the encode and the publish
        here."""
        t0 = time.perf_counter()
        if self._snap_engine is not None:
            # verdicts for every step <= this version reach the engine first
            self._flush_health()
            self._snap_engine.submit_publish(device_copy(self.policy.state_dict()), self.state.version)
        else:
            self._sync_fold_latest()
            if self._health is not None and self._health.unhealthy is not None:
                self.registry.counter("health/publish_blocked_total").inc()
            else:
                host = {k: v.detach().cpu() for k, v in self.policy.state_dict().items()}
                with self.registry.span("transport/publish_weights"):
                    self.transport.publish_weights(
                        encode_weights(host, self.state.version, wire_dtype=self.config.transport.wire_dtype))
                self._published_version = max(self._published_version, self.state.version)
        stall = time.perf_counter() - t0
        self._stall_s += stall
        self._util.phase("publish_stall", stall)
        self.registry.gauge("learner/publish_stall_ms").set(stall * 1e3)

    def _drain_snapshots(self) -> None:
        """Wait until the engine has landed every pending job, its
        checkpoint writes included, then apply a best-model save its
        metrics continuation left for this thread."""
        if self._snap_engine is None:
            return
        timeout = self.config.learner.snapshot_drain_timeout_s
        if not self._snap_engine.drain(timeout=timeout):
            print(f"WARNING: snapshot engine did not drain within {timeout:.0f}s; going on", flush=True)
        self._apply_pending_best()

    # -- best-model rotation -------------------------------------------------------

    def _apply_pending_best(self) -> None:
        with self._pending_best_lock:
            best, self._pending_best = self._pending_best, None
        if best is not None:
            self._maybe_save_best(best)

    def _maybe_save_best(self, scalars: Dict[str, float]) -> None:
        """Save the weights to ``<checkpoint_dir>/best`` when the windowed
        win rate beats the best so far over at least
        ``checkpoint_best_min_episodes`` episodes. Train thread only: the
        save reads ``self.state``."""
        if self._best_dir is None:
            return
        wr = scalars.get("win_rate_recent")
        eps = scalars.get("episodes_recent", 0.0)
        if wr is None or eps < self.config.checkpoint_best_min_episodes or wr <= self._best_win:
            return
        if self.ckpt_best is None:
            self.ckpt_best = CheckpointManager(self._best_dir, max_to_keep=1, registry=self.registry)
        # a declined save (a resumed run whose step sits below the kept
        # peak's) must not move the marker
        if self.ckpt_best.save(self.state, self.config):
            self._best_win = wr
            # temp file and rename: a kill mid-write must not reset the
            # marker on resume
            meta = os.path.join(self._best_dir, "best_meta.json")
            with open(meta + ".tmp", "w") as f:
                json.dump({"win_rate_recent": wr, "step": int(self.state.step)}, f)
            os.replace(meta + ".tmp", meta)

    def _log(self, step: int, scalars: Dict[str, float]) -> None:
        self.history.append({"step": float(step), **scalars})
        self._last_metrics = self.metrics.log(step, scalars)

    def _log_boundary(self, m: Dict[str, torch.Tensor], host_extra: Dict[str, float]) -> None:
        """One log line, in the reference's order: the actor's stat drain,
        the outcome tick (after the drain folded the window's episodes, so
        the line's curves match its counters), the host extras, the best
        win rate. Async, the drain joins the engine's stats backlog and the
        engine's thread finishes the line (a qualifying best-model save is
        left for this thread: the engine never touches ``self.state``);
        sync, everything is read here."""
        step, da = self.state.step, self.device_actor
        if self._snap_engine is not None:
            s_dev, s_fin = da.begin_drain()
            self._snap_engine.submit_stats(device_copy(s_dev, clone=False), s_fin)
            best_win = self._best_win   # read here: the train thread owns it

            def finish(host: Dict[str, Any]) -> None:
                scalars = {k: float(v) for k, v in host["m"].items()}
                # host-only: the drain submitted above folded first
                scalars.update(da.stats())
                if not self._fleet_started:
                    self.outcome.tick()
                scalars.update(host_extra)
                if self._best_dir is not None:
                    with self._pending_best_lock:
                        self._pending_best = dict(scalars)
                    scalars["best_win_rate"] = best_win
                self._log(step, scalars)

            self._snap_engine.submit_metrics(device_copy({"m": m}, clone=False), finish)
            return
        with self.registry.span("learner/metrics_fetch"):
            scalars = {k: float(v) for k, v in m.items()}
            scalars.update(da.drain_stats())
        # the read waited for the updates issued so far
        self._dispatch_inflight = False
        if self._health is not None:
            self._health.fold_host(step, self.state.version, scalars)
        scalars.update(host_extra)
        self._maybe_save_best(scalars)
        if self._best_dir is not None:
            scalars["best_win_rate"] = self._best_win
        if not self._fleet_started:
            self.outcome.tick()
        self._log(step, scalars)

    def _publish_pipeline_gauges(self) -> None:
        """The cross-stage gauges of a log boundary, host values only: the
        actor's weight staleness (0: the device actor plays the learner's
        live params), the transport's queue depth, the prefetch lane's hit
        rate and overlap fraction, the advantage pass's overlap fraction,
        the memory peak, the outcome tick and the utilization fold."""
        reg = self.registry
        reg.gauge("actor/weight_staleness").set(0.0)
        reg.gauge("transport/queue_depth").set(float(self.transport.pending_rollouts))
        served = self._prefetch_hits + self._prefetch_misses
        if served:
            reg.gauge("learner/prefetch_hit_rate").set(self._prefetch_hits / served)
        staged = self._prefetch_overlapped_s + self._prefetch_serial_s
        if staged > 0:
            reg.gauge("learner/overlap_fraction").set(self._prefetch_overlapped_s / staged)
        adv_staged = self._adv_overlapped_s + self._adv_serial_s
        if adv_staged > 0:
            reg.gauge("advantage/overlap_fraction").set(self._adv_overlapped_s / adv_staged)
        tracing.update_memory_gauges(reg, self.device)
        if not self._fleet_started:
            self.outcome.tick()
        self._util.fold(self.state.step)

    def _checkpoint_boundary(self) -> None:
        """A periodic save of the train state (the pipeline is saved only
        at the end of ``train``), behind the health gate."""
        t0 = time.perf_counter()
        if self._snap_engine is not None:
            self._snap_engine.submit_checkpoint(device_copy(self._train_state_tree()), self.config)
        else:
            self._sync_fold_latest()
            if self._health is not None and self._health.unhealthy is not None:
                self.registry.counter("health/checkpoints_blocked_total").inc()
            else:
                self.ckpt.save(self.state, self.config, mark_good=self._health is not None)
        self._util.phase("checkpoint_stall", time.perf_counter() - t0)

    def _after_step(self, m: Dict[str, torch.Tensor], frames: int, stride: int) -> int:
        """The boundary work of one loop iteration; returns the optimizer
        steps a rollback rewound (0 when healthy)."""
        cfg = self.config
        self._frames_trained += frames
        step = self.state.step
        log = step % cfg.log_every < stride
        save = self.ckpt is not None and step % cfg.checkpoint_every < stride
        t0 = time.perf_counter()
        if log or save:
            # verdicts ahead of this boundary's jobs
            self._flush_health()
        if log:
            # a best-model save the engine's continuation left here
            self._apply_pending_best()
            host_extra = self._league_log()
            if self.buffer is not None:
                host_extra.update(self.buffer.metrics())
            elapsed = time.time() - self._t_start
            host_extra["frames_per_sec"] = self._frames_trained / max(elapsed, 1e-9)
            self._publish_pipeline_gauges()
            self._log_boundary(m, host_extra)
        if save:
            self._checkpoint_boundary()
        if log or save:
            self._stall_s += time.perf_counter() - t0
            self.registry.gauge("learner/stall_fraction").set(
                self._stall_s / max(time.time() - self._t_start, 1e-9))
        return self._maybe_rollback()

    # -- the loops ---------------------------------------------------------------

    def _run_mode_loop(self, num_steps: int) -> None:
        """The mode's loop until ``num_steps`` optimizer steps are done or
        a stop is requested."""
        cfg = self.config
        da = self.device_actor
        if self.fused_step is not None:
            k_iters = cfg.steps_per_dispatch
            stride = cfg.ppo.steps_per_batch * k_iters
            frames_per = da.n_lanes * cfg.ppo.rollout_len * k_iters
            while self._steps_done < num_steps and not self._stop_requested:
                opp_params, opp_uid = self._league_opponent()
                t0 = time.perf_counter()
                self.state, da.state, m, chunk_stats = self.fused_step(self.state, da.state, opp_params)
                self._util.phase("dispatch_inflight", time.perf_counter() - t0)
                self._dispatch_inflight = True
                self._report_league(opp_uid, chunk_stats)
                da.env_steps += frames_per
                da.rollouts_shipped += da.n_lanes * k_iters
                self._submit_health(m)
                self._steps_done += stride
                self._steps_done -= self._after_step(m, frames_per, stride)
            return
        epochs = cfg.ppo.steps_per_batch
        frames_per = cfg.ppo.batch_rollouts * cfg.ppo.rollout_len
        while self._steps_done < num_steps and not self._stop_requested:
            opp_params, opp_uid = self._league_opponent()
            chunk, chunk_stats = da.collect(self.policy, opp_params if opp_params is not None else self.policy)
            self._report_league(opp_uid, chunk_stats)
            self.buffer.add_device(chunk, self.state.version)
            while (batch := self._next_batch()) is not None:
                m = self._optimize(batch)
                if self._steps_done + epochs < num_steps:
                    # a batch staged behind the final update could never be
                    # trained on
                    self._prefetch_next()
                self._steps_done += epochs
                self._steps_done -= self._after_step(m, frames_per, epochs)
                if self._steps_done >= num_steps or self._stop_requested:
                    break

    def _settle(self) -> int:
        """After a loop: requeue the prefetched batch, land the engine's
        jobs (pending verdicts first), and roll back if a verdict that
        folded only now latched. Returns the steps rewound."""
        if self.buffer is not None:
            self._flush_prefetch()
        self._dispatch_inflight = False
        self._flush_health()
        self._drain_snapshots()
        return self._maybe_rollback()

    def _seal(self) -> None:
        """The end of ``train``: the actor's last stat drain (the call's
        window, the second best-model hook, so a peak is kept even when no
        log boundary fell in the call), the league's last outcomes, the
        final publish, and with a checkpoint directory the forced save at
        the exact stop step with the whole pipeline, waited for: a failed
        write raises here. The forced save is never health-blocked, but
        only a verdict-clean state is marked good."""
        self._maybe_save_best(self.device_actor.drain_stats())
        self._flush_league_reports()
        self._publish_weights()
        self._drain_snapshots()
        if self.ckpt is not None:
            self._sync_fold_latest()
            self.ckpt.save(self.state, self.config, force=True, pipeline=self._pipeline_state(),
                           mark_good=self._health is not None and self._health.unhealthy is None)
            self.ckpt.wait()

    def train(self, num_steps: int) -> Dict[str, float]:
        """Run until ``num_steps`` optimizer steps have completed (rounded
        up to whole batches or fused calls; a rollback's rewound steps are
        trained again), or until ``request_stop``. Returns the last logged
        metrics, the actor's stats (``actor_*``), ``optimizer_steps``,
        ``frames_trained``, ``frames_per_sec`` and ``elapsed_sec``.
        Weights are published once, at the end: the in-process transport
        has no reader in this process before then. The run record gets its
        closing line."""
        self._t_start = time.time()
        self._frames_trained = self._steps_done = 0
        self._stall_s = 0.0
        self._run_mode_loop(num_steps)
        while True:
            rewound = self._settle()
            if not rewound or self._stop_requested:
                break
            self._steps_done -= rewound
            self._run_mode_loop(num_steps)
        self._seal()
        elapsed = time.time() - self._t_start
        actor_stats = self.device_actor.stats()
        out = {
            **self._last_metrics,
            **{f"actor_{k}": v for k, v in actor_stats.items()},
            "optimizer_steps": float(self._steps_done),
            "frames_trained": float(self._frames_trained),
            "frames_per_sec": self._frames_trained / max(elapsed, 1e-9),
            "elapsed_sec": elapsed,
        }
        self._publish_pipeline_gauges()
        # the record's closing line (the end's publish and save included),
        # spared the console
        self.metrics.log_files_only(self.state.step, out)
        return out


def smoke_config(config: RunConfig) -> RunConfig:
    """The reference learner's ``--smoke`` sizes: 4 games of 60 s, chunks of
    8 steps, batches of 8, a ring of 32, a log line every step."""
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


_ITEM_4B = "ROADMAP queue 1, item 4b (external actors and the learner's transports)"
_ITEM_6 = "ROADMAP queue 1, item 6 (transformer and MoE cores)"
_ITEM_7 = "ROADMAP queue 1, item 7 (multi-GPU)"
_ITEM_8 = "ROADMAP queue 1, item 8 (the trace plane and the fleet fanout)"
_ITEM_12 = "ROADMAP queue 1, item 12 (the JAX debug and cache flags)"
# flags of the reference learner whose features the port does not have
# yet: (flag, argparse keyword arguments, ROADMAP item); each raises when
# given
_NOT_PORTED_FLAGS = (
    ("--core", {"type": str}, _ITEM_6),
    ("--moe-experts", {"type": int}, _ITEM_6),
    ("--mesh", {"type": str}, _ITEM_7),
    ("--multihost", {"action": "store_true"}, _ITEM_7),
    ("--dcn-slices", {"type": int}, _ITEM_7),
    ("--model-parallel", {"type": int}, _ITEM_7),
    ("--listen", {"type": str}, _ITEM_4B),
    ("--shm-name", {"type": str}, _ITEM_4B),
    ("--amqp-host", {"type": str}, _ITEM_4B),
    ("--wire-dtype", {"type": str}, _ITEM_4B),
    ("--rollout-wire-dtype", {"type": str}, _ITEM_4B),
    ("--refresh-every", {"type": int}, _ITEM_4B),
    ("--overlap", {"action": "store_true"}, _ITEM_4B),
    ("--no-vec", {"action": "store_true"}, "ROADMAP queue 1, item 4c (the scalar path)"),
    ("--trace-jsonl", {"type": str}, _ITEM_8),
    ("--trace-sample", {"type": int}, _ITEM_8),
    ("--fleet-interval", {"type": float}, _ITEM_8),
    ("--checkify", {"action": "store_true"}, _ITEM_12),
    ("--compile-cache", {"type": str}, _ITEM_12),
)


def crash_checkpoint(learner: Learner) -> None:
    """``--on-crash-checkpoint``: land the engine's jobs, then a forced
    weights-only save, waited for, and its line. Whatever fails here is
    printed, never raised: the caller re-raises the original error."""
    try:
        learner._drain_snapshots()
    except Exception:  # noqa: BLE001 - the rescue goes on
        pass
    try:
        # forced: a failure raises instead of being counted, so success is
        # never claimed when the disk is what broke
        saved = learner.ckpt.save(learner.state, learner.config, force=True)
        learner.ckpt.wait()
        where = "saved to " + learner.ckpt.directory if saved else "declined (step already checkpointed)"
        print(f"learner: crash checkpoint {where} before re-raising", flush=True)
    except Exception as save_err:  # noqa: BLE001 - reported, never masks the original
        print(f"learner: crash checkpoint failed too ({type(save_err).__name__}: {save_err})", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Self-play PPO learner on one CUDA card.")
    p.add_argument("--smoke", action="store_true", help="tiny sizes, at most 5 steps")
    p.add_argument("--steps", type=int, default=1000, help="optimizer steps")
    p.add_argument("--logdir", type=str, default=None,
                   help="tensorboardX scalars here (one warning and the other sinks when tensorboardX is missing)")
    p.add_argument("--metrics-jsonl", type=str, default=None, metavar="PATH",
                   help="append every log boundary's scalars and the telemetry registry as JSON lines to PATH, "
                   "closed by an end-of-run line; check it with scripts/check_telemetry_schema.py --path PATH")
    p.add_argument("--n-envs", type=int, default=None, help="games (default: the config's)")
    p.add_argument("--team-size", type=int, default=None, help="heroes a side (default: the config's)")
    p.add_argument("--opponent", type=str, default=None,
                   choices=("scripted_easy", "scripted_hard", "selfplay", "league"),
                   help="'league' plays the Dire side against frozen past selves (tune with --league)")
    for flag, cls, example in (("--ppo", "PPOConfig", "'learning_rate=1e-4,entropy_coef=0.001'"),
                               ("--reward", "RewardConfig", "'win=25,tower_damage=20'"),
                               ("--league", "LeagueConfig", "'anchor_prob=0.25,snapshot_every=200' (with "
                                "--opponent league)"),
                               ("--buffer", "BufferConfig", "'capacity_rollouts=64,min_fill=8'"),
                               ("--health", "HealthConfig", "'explosion_band=50,max_rollbacks=2' or "
                                "'enabled=false'"),
                               ("--learner", "LearnerConfig", "'snapshot_drain_timeout_s=120' or "
                                "'async_snapshots=false'"),
                               ("--serve", "ServeConfig", "'batch_window_ms=4,max_batch=128' (saved with the "
                                "checkpoints, so a serve CLI on them starts with them)")):
        p.add_argument(flag, type=str, default=None, metavar="K=V,...",
                       help=f"comma-separated {cls} overrides, e.g. {example}")
    p.add_argument("--sync-snapshots", action="store_true",
                   help="run the weights publish, periodic checkpoints and log-boundary reads on the train "
                   "thread instead of the snapshot engine's (learner async_snapshots=false)")
    p.add_argument("--actor", type=str, default="device", choices=ACTOR_MODES,
                   help="device: the buffered learner over the on-device rollout (default); fused: rollout "
                   "and update on the same chunk in one step")
    p.add_argument("--transport", type=str, default="inproc", choices=("inproc", "socket", "shm", "amqp"),
                   help="the weights and experience transport: inproc only (socket, shm and amqp: " + _ITEM_4B
                   + ")")
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
    p.add_argument("--on-crash-checkpoint", action="store_true",
                   help="on an unexpected error, save the weights (forced, waited for) before re-raising "
                   "(needs --checkpoint-dir); SIGTERM and SIGINT drain and save the whole pipeline without it")
    p.add_argument("--profile", "--profile-dir", dest="profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run (CPU and CUDA activity) into DIR")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA card; 'cpu' must be asked for)")
    for flag, kw, item in _NOT_PORTED_FLAGS:
        p.add_argument(flag, **{"default": None, **kw}, help="not ported yet: " + item)
    args = p.parse_args(argv)
    for flag, _, item in _NOT_PORTED_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise NotImplementedError(f"{flag} is not ported yet: {item}")
    if args.transport != "inproc":
        raise NotImplementedError(f"--transport {args.transport} is not ported yet: {_ITEM_4B}")

    config = default_config()
    if args.smoke:
        config = smoke_config(config)
        args.steps = min(args.steps, 5)
    if args.steps_per_dispatch is not None:
        config = dataclasses.replace(config, steps_per_dispatch=args.steps_per_dispatch)
    if args.checkpoint_every is not None:
        config = dataclasses.replace(config, checkpoint_every=args.checkpoint_every)
    if args.restore and not args.checkpoint_dir:
        p.error("--restore needs --checkpoint-dir")
    try:
        config = apply_league_flags(config, args.opponent, args.league)
        for flag, text, sub, cls in (("--ppo", args.ppo, "ppo", PPOConfig),
                                     ("--reward", args.reward, "reward", RewardConfig),
                                     ("--buffer", args.buffer, "buffer", BufferConfig),
                                     ("--health", args.health, "health", HealthConfig),
                                     ("--learner", args.learner, "learner", LearnerConfig),
                                     ("--serve", args.serve, "serve", ServeConfig)):
            if text:
                over = parse_dataclass_overrides(cls, text, flag)
                config = dataclasses.replace(config, **{sub: dataclasses.replace(getattr(config, sub), **over)})
    except ValueError as e:
        p.error(str(e))
    env_over = {k: v for k, v in (("n_envs", args.n_envs), ("opponent", args.opponent),
                                  ("team_size", args.team_size)) if v is not None}
    if env_over:
        config = dataclasses.replace(config, env=dataclasses.replace(config.env, **env_over))
    if args.sync_snapshots:
        config = dataclasses.replace(config, learner=dataclasses.replace(config.learner, async_snapshots=False))
    config = dataclasses.replace(config, seed=args.seed)

    learner = Learner(config, actor=args.actor, seed=args.seed, device=args.device,
                      checkpoint_dir=args.checkpoint_dir, restore=args.restore, init_from=args.init_from,
                      logdir=args.logdir, metrics_jsonl=args.metrics_jsonl)

    # the first SIGTERM or SIGINT drains: the loop stops at its next step
    # boundary and the end of train saves the whole pipeline; the handler
    # then restores the default, so a second one kills
    def graceful(signum, frame):
        learner.request_stop()
        name = signal.Signals(signum).name
        print(f"learner: {name} received: draining (checkpoint and clean exit); send {name} again to force "
              "exit", flush=True)
        signal.signal(signum, signal.SIG_DFL)

    previous = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, graceful)
    except ValueError:
        pass  # not the main thread: signals stay with the embedding program
    try:
        with trace(args.profile):
            out = learner.train(args.steps)
    except BaseException as e:
        if args.on_crash_checkpoint and not isinstance(e, (KeyboardInterrupt, SystemExit)) \
                and learner.ckpt is not None:
            crash_checkpoint(learner)
        raise
    finally:
        learner.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    print(f"done: {out['optimizer_steps']:.0f} steps, {out['frames_trained']:.0f} frames, "
          f"{out['frames_per_sec']:.0f} frames/sec", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

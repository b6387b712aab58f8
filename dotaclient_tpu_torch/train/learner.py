"""The learner: self-play PPO on one card, buffered or fused.

Counterpart of ``dotaclient_tpu/train/learner.py`` (``Learner(config,
actor=...)``, its training loops, the health guardian, the snapshot
engine's boundaries, the run record, best-model rotation, ``train``'s
return dict) and of its CLI. Run on the card::

    python -m dotaclient_tpu_torch.train.learner [--smoke] [--steps N] [--actor device|fused|vec|scalar|external]
        [--no-vec] [--transport inproc|socket|shm|amqp] [--listen HOST:PORT] [--shm-name NAME]
        [--amqp-host HOST[:PORT]] [--wire-dtype float32|bfloat16] [--rollout-wire-dtype float32|bfloat16]
        [--refresh-every N]
        [--overlap] [--n-envs N] [--team-size N] [--opponent scripted_easy|scripted_hard|selfplay|league]
        [--league K=V,...] [--ppo K=V,...] [--reward K=V,...] [--serve K=V,...] [--buffer K=V,...]
        [--health K=V,...] [--learner K=V,...] [--sync-snapshots]
        [--seed S] [--device cuda|cpu] [--metrics-jsonl PATH] [--logdir DIR] [--profile DIR]
        [--checkpoint-dir DIR [--checkpoint-every N] [--restore] [--on-crash-checkpoint]]
        [--init-from DIR] [--multihost] [--mesh K=V,...] [--dcn-slices N] [--checkify] [--compile-cache DIR]

Five actor modes, ``device`` the default as in the reference:

* ``device``, the buffered learner: each iteration ``DeviceActor.collect``
  rolls out every game on the card, ``TrajectoryBuffer.add_device`` puts
  the chunks in the ring, and every ``batch_rollouts`` chunks taken from
  it (``_next_batch``, with the prefetch lane's hold and release) get the
  one-pass advantage pass (``train/advantage.py``) and ``epochs_per_batch
  x minibatches`` updates (``_optimize``: one epoch-step call), the
  minibatch permutations drawn on the host from ``default_rng(seed + 1)``;
* ``fused``: one call of ``train/fused.py`` a loop iteration, rollout and
  update on the same chunk;
* ``vec``: an in-process host pool (``actor/vec_runtime.py``: the numpy
  simulator, the policy step on the card) whose decoded chunks go through a
  bounded deque (``4 x capacity_rollouts``, drop-oldest) into the ring's
  host-row ``add``; the loop alternates a pool phase of ``rollout_len``
  steps with the updates, or with ``overlap`` runs the pool on its own
  thread (the staleness filter and version tags then do real work). The
  pool plays the learner's params, pushed behind the health gate
  (``_push_pool_params``) every ``refresh_every`` batches;
* ``scalar`` (``--no-vec``), the proto path of BASELINE config 1: the
  scalar ``ActorPool`` (``actor/runtime.py``: ``LocalDotaEnv`` games over
  the proto ``LaneSim``, one batched policy step on the card) in the
  ``vec`` mode's loops, sequential or ``overlap``; its chunks are
  ``Rollout`` protos published to ``transport`` (the ``InProcTransport``),
  which ``_ingest_impl``'s drain decodes into the ring. It has no opponent
  lanes, so league mode refuses it;
* ``external``: no actors in process. ``python -m
  dotaclient_tpu_torch.actor`` processes feed a ``TransportServer``
  (``--transport socket --listen HOST:PORT``) or, on the same host, a
  ``ShmTransportServer`` (``--transport shm --shm-name NAME``: one
  shared-memory ring a slot, drained on the train thread, and a seqlocked
  weights slab) or, through a RabbitMQ broker, an ``AmqpTransport``
  (``--transport amqp --amqp-host HOST[:PORT]``); ``_ingest_impl`` drains it
  decoded (``consume_decoded``, with the wire byte accounting; the AMQP
  queue's protos through ``decode_rollout``) into the ring, and the weights
  go out every ``refresh_every`` batches in the Flax layout
  (``encode_weights(to_flax(...))``), so a JAX actor reads them too.
  Fleet snapshot frames go to the ``FleetAggregator``, whose thread starts
  in this mode.

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

The CLI's ``--core transformer`` trains the GTrXL-gated windowed-attention
core (``models/transformer.py``) in every actor mode but ``scalar``, and
``--moe-experts N`` routes its FFNs through N Switch experts
(``models/moe.py``). ``--fleet-interval S`` sets the aggregator's cadence
(``telemetry.fleet_interval_s``; 0 keeps its thread off).

Tracing (``utils/tracing.py``): ``--trace-jsonl PATH`` installs the
process tracer before the learner is built (``--trace-sample N``, default
``telemetry.trace_sample_n``). The learner stamps ``dispatch`` on the
records of the batch an update consumes and emits them, with a sampled
``dispatch`` event; a publish carries a ``weights_record``. Join a run's
logs with ``utils/trace_report.py``.

The narrow wires: ``--wire-dtype bfloat16`` publishes bf16 weights frames
(``transport.wire_dtype``; actors widen them on apply), and
``--rollout-wire-dtype bfloat16`` (``transport.rollout_wire_dtype``, the
actors' value too) makes the ring store the wire dtypes and the device
actor collect them. The CLI's closing line is ``done: N steps, F frames, R
frames/sec, D native decodes, E native encodes, P proto fallbacks, L
lstm_seq launches``: the rollout codec's calls by path
(``serialize.CODEC_CALLS``) and the kernel's launches in the run.

Data parallelism (``parallel/``): one process a card, each a rank of the
job's process group. ``Learner(..., mesh=None)`` builds the mesh from the
group (a world of 1 without one), broadcasts the initial or restored train
state from rank 0, sets the ``mesh/*``, ``fused/lanes_per_shard``,
``buffer/shard_bytes`` and ``learner/psum_ms`` gauges, and runs the
reference's minibatch divisibility preflight. The device actor is
lane-sharded, the ring sharded, and every update sums its statistics and
gradients over the batch group, so the params stay equal on every rank;
the stat drains and the league's outcomes are summed over the ranks
before rank 0 logs them. Rank 0 alone publishes, writes checkpoints (of
the whole-batch layout, which any world size restores), the run record and
the trace; every rank reads the checkpoint directory, which must be shared.
The ranks agree on stopping and on a health rollback with one host
all-reduce of two flags a loop iteration (gloo), so they always leave the
loop and roll back at the same step; no branch taken on one rank alone
calls a collective. A job::

    python -m torch.distributed.run --nproc-per-node K -m dotaclient_tpu_torch.train.learner --multihost \
        [--mesh data_parallel=-1] [--dcn-slices D] ...

The host-fed modes (``external``, ``vec``, ``scalar``) on a world above 1
have one door, as the reference's single controller: rank 0 holds the
transport (the CLI binds it there alone) or runs the host pool, and the
ring's single door (``buffer/trajectory_buffer.py``) admits every row on
rank 0, keeps the whole ring's bookkeeping there, sends each row to the
ranks of the batch shard that will train it, and broadcasts each take's
decision, so a world of n trains the same batches, drops included, as a
world of 1. Every rank reaches the ring's ``add`` and ``take`` at the same
points of the loop, on the train thread (the ``--overlap`` pool's thread
issues no collective); rank 0's pool plays the params it holds, equal on
every rank, and its stats and league draws are the job's. An MoE core
routes over the batch group in the rollout, the update and the advantage
pass (``parallel/expert.py``). ``--model-parallel N`` (the ``model`` axis)
is the tensor-parallel layout of ``parallel/sharding.py``: each rank's
``TrainState`` keeps 1/N of every cut master param and its Adam moments,
the model group gathers them into whole params after each optimizer step,
and the model ranks of one data shard compute the same rollout and
update; checkpoints save the whole layout (a gather every rank joins), so
any ``model_parallel`` restores them. A crash checkpoint of that layout is
skipped (its gather would need every rank).

The debug and cache flags: ``--checkify`` (``Learner(...,
debug_checkify=True)``) runs every update of the buffered modes under
``train/checkify.py``'s per-op NaN and division checks, each update of the
epoch step checked on its own, as the reference's staged checkify loop
does; it refuses ``--actor fused``. ``--compile-cache DIR`` builds the kernel library and the
native codec into ``DIR`` (``use_compile_cache``), the port's only compiled
programs, so processes that share ``DIR`` build them once.
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
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
from dotaclient_tpu_torch.actor.runtime import ActorPool
from dotaclient_tpu_torch.actor.vec_runtime import VecActorPool
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.config import (
    BufferConfig, HealthConfig, LeagueConfig, LearnerConfig, MeshConfig, PPOConfig, RewardConfig, RunConfig,
    ServeConfig, default_config,
)
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.league.pool import LIVE, OpponentPool
from dotaclient_tpu_torch.models.convert import to_flax
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.outcome import records as outcome_records
from dotaclient_tpu_torch.outcome.aggregator import OutcomeAggregator
from dotaclient_tpu_torch.parallel import distributed as pdist
from dotaclient_tpu_torch.parallel.collectives import psum
from dotaclient_tpu_torch.parallel.mesh import Mesh, batch_index, batch_shard_count, collective_probe_ms, make_mesh
from dotaclient_tpu_torch.train.advantage import make_advantage_pass, one_pass_enabled
from dotaclient_tpu_torch.train.fused import make_fused_step
from dotaclient_tpu_torch.train.health import VERDICT_KEYS, HealthMonitor
from dotaclient_tpu_torch.train.ppo import init_train_state, make_epoch_step, make_train_step
from dotaclient_tpu_torch.train.snapshot import SnapshotEngine, device_copy
from dotaclient_tpu_torch.transport import serialize
from dotaclient_tpu_torch.transport.queues import AmqpTransport, InProcTransport
from dotaclient_tpu_torch.transport.socket_transport import TransportServer
from dotaclient_tpu_torch.transport.serialize import decode_rollout, encode_weights
from dotaclient_tpu_torch.utils import faults, telemetry, tracing, utilization
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager, shape_mismatches
from dotaclient_tpu_torch.utils.fleet import FleetAggregator
from dotaclient_tpu_torch.utils.metrics import MetricsLogger
from dotaclient_tpu_torch.utils.overrides import parse_dataclass_overrides
from dotaclient_tpu_torch.utils.profiling import trace
from dotaclient_tpu_torch.utils.tree import tree_map

ACTOR_MODES = ("device", "fused", "vec", "scalar", "external")


class Learner:
    """Params from ``init_params`` with ``seed`` (or, with ``restore``, the
    newest valid checkpoint in ``checkpoint_dir``, pipeline included; or,
    with ``init_from``, the weights alone of the newest valid checkpoint in
    that other directory), the ``actor`` mode's actors (a device actor over
    ``config.env.n_envs`` games for ``device`` and ``fused``, a host pool
    for ``vec`` and ``scalar``, none for ``external``) and its loop.
    ``transport`` carries the experience and the weights (an
    ``InProcTransport`` when None; ``external`` needs one, such as a
    ``TransportServer`` or a ``ShmTransportServer``). ``logdir`` and
    ``metrics_jsonl`` add the tensorboardX and JSONL sinks to the run
    record; ``close`` lands the pending checkpoint writes and closes the
    record (the caller closes the transport it gave)."""

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
        transport: Any = None,
        mesh: Optional[Mesh] = None,
        debug_checkify: bool = False,
    ) -> None:
        if actor not in ACTOR_MODES:
            raise ValueError(f"unknown actor mode {actor!r}")
        if actor == "fused" and debug_checkify:
            raise ValueError("checkify instruments the buffered train step, which fused mode never calls — use "
                             "actor='device' to hunt NaNs")
        mesh = mesh if mesh is not None else make_mesh(config.mesh)
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.shape}: launch as many ranks as the mesh "
                             "holds, or give data_parallel=-1")
        n_shards = batch_shard_count(mesh, config.mesh)
        self.mesh = mesh
        self.n_shards = n_shards
        self.is_chief = mesh.rank == 0
        # more than one rank: the loops agree, and the host-fed modes go
        # through rank 0's door
        self._multi = mesh.size > 1
        # the gloo group of the ranks' host agreements (None on a world of 1)
        self._host_group = mesh.all_host_group if self._multi else None
        # the tensor-parallel layout's group (None without a model axis)
        self._model_group = mesh.group(config.mesh.model_axis)
        if not self.is_chief:
            # rank 0 alone writes the record
            logdir = metrics_jsonl = None
        if actor == "scalar" and config.env.opponent == "league":
            raise NotImplementedError("league mode needs frozen-opponent lanes; the scalar pool has none: use "
                                      "actor='device' or 'vec'")
        if config.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {config.steps_per_dispatch}")
        if config.steps_per_dispatch > 1 and actor != "fused":
            raise ValueError("steps_per_dispatch > 1 batches iterations inside the fused step; it has no meaning "
                             "for the buffered learner: use actor='fused' or leave it at 1")
        if actor == "external" and transport is None and self.is_chief:
            raise ValueError("the external actor mode needs a transport (a TransportServer) for the actor "
                             "processes to reach")
        if actor != "fused" and config.ppo.batch_rollouts % max(1, config.ppo.minibatches):
            raise ValueError(f"batch_rollouts {config.ppo.batch_rollouts} not divisible by minibatches "
                             f"{config.ppo.minibatches}")
        if config.ppo.minibatches > 1:
            # each minibatch is itself a batch cut over the ranks: in fused
            # mode the chunk is the lane set, split along lanes; the
            # buffered modes split batch_rollouts
            if actor == "fused":
                from dotaclient_tpu_torch.actor.device_rollout import lane_split

                total = config.env.n_envs * len(lane_split(config)[0])
                what = f"lane count {total}"
            else:
                total = config.ppo.batch_rollouts
                what = f"batch_rollouts {total}"
            mb = total // config.ppo.minibatches
            if total % config.ppo.minibatches or mb % n_shards:
                raise ValueError(
                    f"{what} must split into minibatches ({config.ppo.minibatches}) of a size divisible by the "
                    f"batch shard count {n_shards} (minibatches are data-sharded batches); got minibatch size {mb}")
        league_on = config.league.enabled or config.env.opponent == "league"
        stride = config.steps_per_dispatch * config.ppo.steps_per_batch
        if league_on and actor in ("device", "fused") and stride > config.league.opponent_hold:
            # the opponent is redrawn only between calls, so a shorter hold
            # would silently stretch to the stride
            raise ValueError(
                f"league.opponent_hold ({config.league.opponent_hold}) is shorter than one dispatch stride "
                f"(steps_per_dispatch x steps_per_batch = {stride}): raise opponent_hold or lower "
                "steps_per_dispatch"
            )
        self.actor_mode = actor
        self.config = config
        self.device = resolve_device(device) if device is not None or mesh.world_size == 1 else pdist.rank_device()
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.registry = registry if registry is not None else telemetry.get_registry()
        tracing.ensure_metrics(self.registry)
        # captured once (configure before building the learner): tracing
        # off costs one pointer test a dispatch and a publish
        self._tracer = tracing.get()
        self.policy = make_policy(config.model, config.obs, config.actions, device=self.device)
        init_params(self.policy, torch.Generator().manual_seed(seed))
        self.init_from_step = 0  # the source's step when seeded by init_from
        if init_from:
            self.init_from_step = self._seed_from(init_from, checkpoint_dir, restore)
        self.state = init_train_state(self.policy, config.ppo, model_group=self._model_group)
        self.ckpt: Optional[CheckpointManager] = None
        self._ckpt_dir = checkpoint_dir
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
            if config.checkpoint_best_min_episodes > 0 and self.is_chief:
                self._best_dir = os.path.join(checkpoint_dir, "best")
                self._best_win = self._load_best_win()
        elif restore:
            raise ValueError("restore needs a checkpoint_dir")
        # a best-model save of the tensor-parallel layout gathers the
        # optimizer state: every rank joins rank 0's decision
        self._best_agreed = (self._model_group is not None and bool(checkpoint_dir)
                             and config.checkpoint_best_min_episodes > 0)
        # every rank starts from rank 0's state (the seed's or the restore's)
        self._broadcast_train_state()
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
        self.transport = transport if transport is not None else InProcTransport(registry=self.registry)
        # the vec pool's chunks reach the ring through a bounded deque
        # (drop-oldest: with overlap the pool free-runs past the learner)
        self._sink: Optional[deque] = deque(maxlen=4 * config.buffer.capacity_rollouts) if actor == "vec" else None
        self.device_actor: Optional[DeviceActor] = None
        # the host pool of the vec and scalar modes, rank 0's alone: it
        # plays every game of the job and its rows go through the ring's
        # single door
        self.host_pool: Optional[Any] = None
        if actor in ("device", "fused"):
            self.device_actor = DeviceActor(config, self.policy, seed=seed, registry=self.registry,
                                            device=self.device, mesh=mesh)
        elif not self.is_chief:
            pass
        elif actor == "scalar":
            self.host_pool = ActorPool(config, self.policy, self._actor_params_copy(), transport=self.transport,
                                       seed=seed, version=self.state.version, device=self.device,
                                       registry=self.registry)
        elif actor == "vec":
            self.host_pool = VecActorPool(config, self.policy, self._actor_params_copy(), seed=seed,
                                          version=self.state.version, rollout_sink=self._sink.extend,
                                          device=self.device, registry=self.registry)
            if self.league is not None:
                self.host_pool.set_opponent(*self.league.sample_indexed(self._actor_params_copy(), 0)[:2])
                if config.league.matchmaking == "pfsp":
                    print("WARNING: PFSP matchmaking needs per-draw outcomes, which only the device and fused "
                          "loops attribute; host-pool league draws keep the 0.5 prior and behave as uniform",
                          flush=True)
        # the actors' shared surface (stats, drain_stats): None in external
        self.pool = self.device_actor if self.device_actor is not None else self.host_pool
        self.fused_step = None
        self.train_step = self.epoch_step = self.advantage_pass = None
        self.buffer: Optional[TrajectoryBuffer] = None
        # a buffered rank whose actor runs every game keeps its share of
        # the chunk's lanes (the ring is sharded whatever the actor's layout)
        self._lane_keep: Optional[slice] = None
        if actor == "fused":
            self.fused_step = make_fused_step(config, self.device_actor, anchor=self.anchor)
        else:
            group = mesh.batch_group if n_shards > 1 else None
            self.train_step = make_train_step(config, anchor=self.anchor, group=group, debug_checkify=debug_checkify)
            # ppo.fused_epoch picks nothing here: the reference's staged
            # loop and its scanned epoch are the same Python loop in torch
            if config.ppo.steps_per_batch > 1:
                self.epoch_step = make_epoch_step(config, anchor=self.anchor, group=group,
                                                  debug_checkify=debug_checkify)
            if one_pass_enabled(config):
                self.advantage_pass = make_advantage_pass(self.policy, config, group)
            self.buffer = TrajectoryBuffer(config, device=self.device, registry=self.registry, mesh=mesh,
                                           host_fed=actor in ("vec", "scalar", "external"))
            da = self.device_actor
            if da is not None and n_shards > 1 and da.lane_shards == 1:
                if da.n_lanes % n_shards:
                    raise ValueError(f"the buffered learner's chunk of {da.n_lanes} lanes must split over the "
                                     f"{n_shards} batch shards")
                per = da.n_lanes // n_shards
                i = batch_index(mesh, config.mesh)
                self._lane_keep = slice(i * per, (i + 1) * per)
        reg = self.registry
        # the mesh's gauges, eager so any record meets the multichip tier;
        # the psum probe is one blocking all-reduce at construction
        reg.gauge("mesh/n_devices").set(float(mesh.size))
        reg.gauge("mesh/data_shards").set(float(n_shards))
        reg.gauge("buffer/shard_bytes")
        reg.gauge("mesh/lane_shards").set(float(self.device_actor.lane_shards) if self.device_actor else 0.0)
        reg.gauge("fused/lanes_per_shard").set(
            float(self.device_actor.lanes_per_shard) if self.device_actor else 0.0)
        reg.gauge("learner/psum_ms").set(collective_probe_ms(mesh, config.mesh, self.device))
        reg.gauge("advantage/one_pass").set(1.0 if self.advantage_pass is not None else 0.0)
        reg.gauge("advantage/pass_ms")
        reg.gauge("advantage/overlap_fraction")
        reg.counter("advantage/passes_total")
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
        self.metrics = MetricsLogger(logdir, jsonl=metrics_jsonl, registry=self.registry, console=self.is_chief)
        self.fleet = FleetAggregator(registry=self.registry, emit_event=self.metrics.emit_event)
        outcome_records.ensure_actor_metrics(self.registry)
        self.outcome = OutcomeAggregator(registry=self.registry)
        self.fleet.add_tick_hook(self.outcome.tick)
        if hasattr(self.transport, "metrics_handler"):
            self.transport.metrics_handler = self.fleet.ingest
        self._fleet_started = False
        if actor == "external" and telemetry.fleet_interval_s > 0 and self.is_chief:
            self.fleet.start()
            self._fleet_started = True
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
        # the loop's stop flag; on a world above 1 a signal sets
        # _stop_signal and the ranks agree on the stop (_agree)
        self._stop_requested = False
        self._stop_signal = False
        self._poll_timeout = config.buffer.consume_poll_timeout_s
        # the loop options of the running train call
        self._refresh_every, self._overlap, self._actor_steps, self._midrun_every = 1, False, 0, 0
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
        boundary (on a world above 1, the step at which the ranks next
        agree); its end then saves the whole pipeline, so the run resumes
        at that exact step. One flag write: safe in a signal handler."""
        self._stop_signal = True
        if not self._multi:
            self._stop_requested = True

    # -- the ranks ------------------------------------------------------------

    def _broadcast_train_state(self) -> None:
        """Rank 0's params and counters to every rank, and each Adam moment
        from the first rank of its batch group (a moment of the
        tensor-parallel layout is the slice of this rank's model
        coordinate): device tensors over the device groups, host ones over
        their gloo twins."""
        if not self._multi:
            return
        import torch.distributed as dist

        mesh = self.mesh

        def bcast(t: torch.Tensor, device_group, host_group) -> None:
            group = host_group if t.device.type == "cpu" else device_group
            if group is not None:
                dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)

        with torch.no_grad():
            for t in self.policy.state_dict().values():
                bcast(t, mesh.all_group, mesh.all_host_group)
            if self.state.shards is not None:
                self.state.shards.recut()
            opt = self.state.optimizer
            for group in opt.param_groups:
                for p in group["params"]:
                    for k in sorted(opt.state.get(p, {})):
                        if isinstance(opt.state[p][k], torch.Tensor):
                            bcast(opt.state[p][k], mesh.batch_group, mesh.batch_host_group)
        counters = torch.tensor([self.state.step, self.state.version], dtype=torch.int64)
        bcast(counters, None, self._host_group)
        # host-sync-ok: counters is a host tensor, broadcast over the gloo host group
        self.state.step, self.state.version = int(counters[0]), int(counters[1])

    def _barrier(self) -> None:
        if self._multi:
            import torch.distributed as dist

            dist.barrier(group=self._host_group)

    def _agree(self) -> bool:
        """On a world above 1: one host all-reduce (MAX) of this rank's stop
        signal and health latch, at the same point of every rank's loop;
        sets the agreed stop and returns whether any rank latched. On a
        world of 1, the local latch."""
        latched = self._health is not None and self._health.unhealthy is not None
        if not self._multi:
            return latched
        import torch.distributed as dist

        # host-sync-ok: host flags, all-reduced over the gloo host group
        flags = torch.tensor([float(self._stop_signal), float(latched)])
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self._host_group)
        # host-sync-ok: host flags, all-reduced over the gloo host group
        self._stop_requested = self._stop_requested or bool(flags[0])
        # host-sync-ok: host flags, all-reduced over the gloo host group
        return bool(flags[1])

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
                               for _, st in pending])
        # every rank's games (the same draws on every rank)
        group = self.device_actor.batch_group if self.device_actor is not None else None
        stacked = psum(stacked, group).cpu().numpy()
        for (uid, _), (wins, games) in zip(pending, stacked):
            self.league.report(uid, float(wins), float(games))

    def _league_log(self) -> Dict[str, float]:
        """The pool's part of a log line, after a flush."""
        if self.league is None:
            return {}
        self._flush_league_reports()
        wrs = self.league.win_rates()
        # host-sync-ok: the league pool's host win rates
        out = {"league_snapshots": float(len(wrs))}
        if wrs:
            # host-sync-ok: the league pool's host win rates
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
                    # host-sync-ok: a literal NaN for the injected fault
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
        if self._tracer is not None:
            self._emit_dispatch_traces()
        return m

    def _emit_dispatch_traces(self) -> None:
        """The chunk timeline's last hop: the records the batch's ``take``
        parked in the ring get ``dispatch`` and are emitted, beside a
        sampled ``dispatch`` event. Host dict appends only; the caller
        tests ``self._tracer``."""
        tracer = self._tracer
        ts = tracing.now()
        if self.buffer is not None:
            for rec in self.buffer.drain_traces():
                rec["hops"].append(["dispatch", ts])
                tracer.emit_chunk(rec)
        if tracer.should_sample():
            tracer.emit("dispatch", step=self.state.step)

    def _ingest(self) -> int:
        with self.registry.span("learner/consume"):
            return self._ingest_impl()

    def _ingest_impl(self) -> int:
        """Move the ready chunks into the ring: the vec pool's deque, else a
        drain of the transport (the scalar pool's protos, the actor
        processes' frames; decoded by ``consume_decoded`` where the
        transport has it, with the wire byte accounting), waiting at most
        ``buffer.consume_poll_timeout_s`` on an empty one. Returns the
        chunks kept. Through the ring's single door (a world above 1) every
        rank calls the ring's ``add``, rank 0 with the rows."""
        cap = self.config.buffer.capacity_rollouts
        rollouts: List[Any] = []
        if not self.is_chief:
            pass   # the rows reach rank 0 alone
        elif self._sink is not None:
            while self._sink and len(rollouts) < cap:
                rollouts.append(self._sink.popleft())
        elif hasattr(self.transport, "consume_decoded"):
            rollouts = self.transport.consume_decoded(cap, timeout=self._poll_timeout)
        else:
            protos = self.transport.consume_rollouts(cap, timeout=self._poll_timeout)
            rollouts = [decode_rollout(r) for r in protos]
        if rollouts or self._multi:
            return self.buffer.add(rollouts, self.state.version)
        return 0

    def _next_batch(self, drain_transport: bool = True) -> Optional[Dict[str, Any]]:
        """The batch staged behind the previous update if there is one
        (its held slots released), else an ingest (with
        ``drain_transport``) and a take from the ring now; with its
        advantages attached. None when the ring cannot give a batch."""
        batch, self._prefetched = self._prefetched, None
        if batch is not None:
            self.buffer.release(self._prefetch_ticket)
            self._prefetch_ticket = None
            self._prefetch_hits += 1
            return self._attach_advantages(batch)
        t0 = time.perf_counter()
        if drain_transport:
            self._ingest()
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

    def _prefetch_next(self, drain_transport: bool = True) -> None:
        """Ingest (with ``drain_transport``) and take batch N+1 while batch
        N's updates run on the card: its slots are held (an ingest can
        neither evict nor overwrite them), and with
        ``learner.overlap_advantage`` its advantage pass is issued now,
        behind the updates, so it reads their output params, the params its
        first update trains from."""
        if self._prefetched is not None or self.buffer is None:
            return
        t0 = time.perf_counter()
        if drain_transport:
            self._ingest()
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
        RNG, and the minibatch draw count, each in the whole batch's layout
        (gathered over the ranks: every rank calls this). The prefetch lane
        is flushed first so the ring holds every unconsumed chunk."""
        self._flush_prefetch()
        out: Dict[str, Any] = {"buffer": self.buffer.state_dict()} if self.buffer is not None else {}
        if self.device_actor is not None:
            leaves = self.device_actor.host_state()
            out["actor_leaves"] = {f"{i:04d}": leaf for i, leaf in enumerate(leaves)}
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
        if da is not None and "actor_leaves" in restored:
            da.load_host_state([restored["actor_leaves"][k] for k in sorted(restored["actor_leaves"])])
        if da is not None and "actor_rng" in restored:
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
        # host-sync-ok: synchronous snapshots only: the last verdict's three scalars, read at a checkpoint, publish or the run's end (boundary cadence)
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
        publishes stay blocked and the run carries on. On a world above 1
        the ranks first agree (``_agree``): a rank whose engine has not yet
        folded the (global, so equal) verdict folds it now, and all of them
        roll back together, every rank reading the shared directory after
        rank 0's writes have landed."""
        if not self._agree():
            return 0
        if self._health.unhealthy is None:
            # another rank latched first: fold this rank's backlog (a best
            # save left waiting is applied below, where every rank drains)
            self._flush_health()
            self._drain_snapshots(apply_best=False)
            if self._health.unhealthy is None:
                raise RuntimeError("training health guardian: another rank latched a divergence this rank's "
                                   "verdicts do not show: the ranks' updates have diverged")
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
        self._barrier()   # rank 0's writes have landed
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
        self._broadcast_train_state()
        restored_version = self.state.version
        # the version counter skips the poisoned range: no version the
        # poisoned steps made is ever reused; the steps rewind
        self.state.version = from_version + 1
        rewound = from_step - self.state.step
        self._barrier()   # every rank has read before rank 0 deletes
        if self.is_chief:
            self.ckpt.discard_steps_above(self.state.step)
        if self.buffer is not None:
            self._flush_prefetch()
            self.buffer.drop_newer_than(restored_version)
        # carries computed by the poisoned params must not leak into the
        # restored run
        if self.device_actor is not None:
            self.device_actor.reset_recurrent()
        elif self.host_pool is not None:
            self.host_pool.set_params(self._actor_params_copy(), self.state.version)
        # a distinct minibatch stream: the retry must not replay the one
        # that diverged
        self._mb_rng = np.random.default_rng(self.config.seed + 1 + 7919 * self._rollback_count)
        self._mb_draws = 0
        self._last_verdict_m = None
        self._health.clear()
        # host-sync-ok: a host int
        self.registry.gauge("health/last_good_step").set(float(self.state.step))
        if not self.is_chief:
            return rewound
        print("HEALTH_ROLLBACK " + json.dumps({
            "reason": ev.reason, "detected_step": ev.step, "detected_version": ev.version,
            "from_step": from_step, "to_step": self.state.step, "restored_version": restored_version,
            "resumed_version": self.state.version, "published_floor": published_floor,
            "rollback": self._rollback_count,
        }, sort_keys=True), flush=True)
        return rewound

    # -- boundaries --------------------------------------------------------------

    def _train_state_tree(self, opt_state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The train state in the whole layout, with ``opt_state`` when it
        was gathered already (``_whole_opt_state``)."""
        return {"step": self.state.step, "version": self.state.version, "params": self.policy.state_dict(),
                "opt_state": opt_state if opt_state is not None else self.state.optimizer.state_dict()}

    def _whole_opt_state(self) -> Optional[Dict[str, Any]]:
        """The tensor-parallel layout's optimizer state gathered whole, on
        every rank (a collective); None without the layout (a save reads
        the optimizer itself)."""
        return self.state.optimizer_state_dict() if self.state.shards is not None else None

    def _actor_params_copy(self) -> Dict[str, torch.Tensor]:
        """A device-to-device copy of the params for an in-process pool:
        the optimizer updates the live tensors in place."""
        return {k: v.detach().clone() for k, v in self.policy.state_dict().items()}

    def _push_pool_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Give the host pool ``params`` behind the publishes' health gate:
        a latched-unhealthy monitor blocks the push
        (``health/publish_blocked_total``), so in-process actors keep the
        last good params too."""
        if self.host_pool is None:
            return   # not rank 0: no pool
        if self._health is not None:
            if self._snap_engine is None:
                self._sync_fold_latest()
            if self._health.unhealthy is not None:
                self.registry.counter("health/publish_blocked_total").inc()
                return
        self.host_pool.set_params(params, self.state.version)

    def _refresh_league_opponent(self) -> None:
        """Snapshot if due and redraw the vec pool's frozen opponent (the
        device actor draws at every collect instead)."""
        if self.league is None or self.host_pool is None:
            return
        self.league.maybe_snapshot(self.policy.state_dict(), self.state.version, self.state.step)
        params, version, _ = self.league.sample_indexed(self._actor_params_copy(), self.state.version)
        self.host_pool.set_opponent(params, version)

    def _publish_weights(self) -> None:
        """Hand the params to the transport's weights fanout behind the
        health gate, in the Flax layout (``to_flax``). Async: an on-device
        clone, the engine does the rest; sync (``--sync-snapshots``): the
        read, the encode and the publish here. Rank 0 alone publishes."""
        if not self.is_chief:
            return
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
                host = to_flax(self.policy.state_dict())
                trace_blob = None
                if self._tracer is not None:
                    trace_blob = tracing.record_to_blob(tracing.weights_record(self.state.version), pad=False)
                    self._tracer.emit("publish", version=self.state.version)
                with self.registry.span("transport/publish_weights"):
                    self.transport.publish_weights(
                        encode_weights(host, self.state.version, wire_dtype=self.config.transport.wire_dtype,
                                       trace=trace_blob))
                self._published_version = max(self._published_version, self.state.version)
        stall = time.perf_counter() - t0
        self._stall_s += stall
        self._util.phase("publish_stall", stall)
        self.registry.gauge("learner/publish_stall_ms").set(stall * 1e3)

    def _drain_snapshots(self, apply_best: bool = True) -> None:
        """Wait until the engine has landed every pending job, its
        checkpoint writes included, then (with ``apply_best``) apply a
        best-model save its metrics continuation left for this thread."""
        if self._snap_engine is None:
            return
        timeout = self.config.learner.snapshot_drain_timeout_s
        if not self._snap_engine.drain(timeout=timeout):
            print(f"WARNING: snapshot engine did not drain within {timeout:.0f}s; going on", flush=True)
        if apply_best:
            self._apply_pending_best()

    # -- best-model rotation -------------------------------------------------------

    def _apply_pending_best(self) -> None:
        with self._pending_best_lock:
            best, self._pending_best = self._pending_best, None
        if best is not None or self._best_agreed:
            self._maybe_save_best(best or {})

    def _maybe_save_best(self, scalars: Dict[str, float]) -> None:
        """Save the weights to ``<checkpoint_dir>/best`` when the windowed
        win rate beats the best so far over at least
        ``checkpoint_best_min_episodes`` episodes. Train thread only: the
        save reads ``self.state``. Of the tensor-parallel layout, every rank
        calls it at the same point: rank 0's decision is all-reduced and the
        optimizer state gathered."""
        wr = scalars.get("win_rate_recent")
        eps = scalars.get("episodes_recent", 0.0)
        due = (self._best_dir is not None and wr is not None
               and eps >= self.config.checkpoint_best_min_episodes and wr > self._best_win)
        opt_state = None
        if self._best_agreed:
            import torch.distributed as dist

            flag = torch.tensor([float(due)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._host_group)
            if not bool(flag[0]):
                return
            opt_state = self._whole_opt_state()
        if not due:
            return
        if self.ckpt_best is None:
            self.ckpt_best = CheckpointManager(self._best_dir, max_to_keep=1, registry=self.registry)
        # a declined save (a resumed run whose step sits below the kept
        # peak's) must not move the marker
        if self.ckpt_best.save(self.state, self.config, opt_state=opt_state):
            self._best_win = wr
            # temp file and rename: a kill mid-write must not reset the
            # marker on resume
            meta = os.path.join(self._best_dir, "best_meta.json")
            with open(meta + ".tmp", "w") as f:
                json.dump({"win_rate_recent": wr, "step": int(self.state.step)}, f)
            os.replace(meta + ".tmp", meta)

    def _log(self, step: int, scalars: Dict[str, float]) -> None:
        # host-sync-ok: a host int
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
            if da is not None:
                s_dev, s_fin = da.begin_drain()
                self._snap_engine.submit_stats(device_copy(s_dev, clone=False), s_fin)
            elif self.host_pool is not None:
                # a host pool's window is host floats already
                host_extra = {**host_extra, **self.host_pool.drain_stats()}
            best_win = self._best_win   # read here: the train thread owns it

            def finish(host: Dict[str, Any]) -> None:
                # host-sync-ok: runs on the snapshot engine's thread on values it already fetched in one batched transfer
                scalars = {k: float(v) for k, v in host["m"].items()}
                if da is not None:
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
            # host-sync-ok: synchronous snapshots only: the log boundary's one batched read (span learner/metrics_fetch), at log_every cadence
            scalars = {k: float(v) for k, v in m.items()}
            if self.pool is not None:
                scalars.update(self.pool.drain_stats())
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
        actor's weight staleness (the host pool's versions behind; 0 for the
        device actor, which plays the live params, and in external mode),
        the transport's queue depth, the prefetch lane's hit
        rate and overlap fraction, the advantage pass's overlap fraction,
        the memory peak, the outcome tick and the utilization fold."""
        reg = self.registry
        reg.gauge("actor/weight_staleness").set(
            float(self.state.version - self.host_pool.version) if self.host_pool is not None else 0.0)
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
        at the end of ``train``), behind the health gate; rank 0's (every
        rank joins the tensor-parallel layout's gather first)."""
        opt_state = self._whole_opt_state()
        if not self.is_chief:
            return
        t0 = time.perf_counter()
        if self._snap_engine is not None:
            self._snap_engine.submit_checkpoint(device_copy(self._train_state_tree(opt_state)), self.config)
        else:
            self._sync_fold_latest()
            if self._health is not None and self._health.unhealthy is not None:
                self.registry.counter("health/checkpoints_blocked_total").inc()
            else:
                self.ckpt.save(self.state, self.config, mark_good=self._health is not None, opt_state=opt_state)
        self._util.phase("checkpoint_stall", time.perf_counter() - t0)

    def _after_step(self, m: Dict[str, torch.Tensor], frames: int, stride: int) -> int:
        """The boundary work of one loop iteration; returns the optimizer
        steps a rollback rewound (0 when healthy). With ``_midrun_every``
        > 0 (the device and fused loops on a transport other than the
        in-process one, whose readers are out of process) the weights are
        published every that many strides."""
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
        if self._midrun_every and step % (self._midrun_every * stride) < stride:
            self._publish_weights()
        return self._maybe_rollback()

    # -- the loops ---------------------------------------------------------------

    def _run_mode_loop(self, num_steps: int) -> None:
        """The mode's loop until ``num_steps`` optimizer steps are done or
        a stop is requested, with the options ``train`` set
        (``_refresh_every``, ``_overlap``, ``_actor_steps``)."""
        cfg = self.config
        da = self.device_actor
        epochs = cfg.ppo.steps_per_batch
        refresh_every = self._refresh_every
        if self.fused_step is not None:
            k_iters = cfg.steps_per_dispatch
            stride = epochs * k_iters
            frames_per = da.n_lanes * da.lane_shards * cfg.ppo.rollout_len * k_iters
            while self._steps_done < num_steps and not self._stop_requested:
                opp_params, opp_uid = self._league_opponent()
                t0 = time.perf_counter()
                self.state, da.state, m, chunk_stats = self.fused_step(self.state, da.state, opp_params)
                self._util.phase("dispatch_inflight", time.perf_counter() - t0)
                self._dispatch_inflight = True
                self._report_league(opp_uid, chunk_stats)
                da.env_steps += frames_per
                da.rollouts_shipped += da.n_lanes * da.lane_shards * k_iters
                self._submit_health(m)
                if self._tracer is not None:
                    self._emit_dispatch_traces()
                self._steps_done += stride
                self._steps_done -= self._after_step(m, frames_per, stride)
            return
        frames_per = cfg.ppo.batch_rollouts * cfg.ppo.rollout_len
        if da is not None:
            while self._steps_done < num_steps and not self._stop_requested:
                opp_params, opp_uid = self._league_opponent()
                chunk, chunk_stats = da.collect(self.policy, opp_params if opp_params is not None else self.policy)
                self._report_league(opp_uid, chunk_stats)
                if self._lane_keep is not None:
                    chunk = tree_map(lambda t: t[self._lane_keep], chunk)
                self.buffer.add_device(chunk, self.state.version)
                while (batch := self._next_batch(drain_transport=False)) is not None:
                    m = self._optimize(batch)
                    if self._steps_done + epochs < num_steps:
                        # a batch staged behind the final update could never be
                        # trained on
                        self._prefetch_next(drain_transport=False)
                    self._steps_done += epochs
                    self._steps_done -= self._after_step(m, frames_per, epochs)
                    if self._steps_done >= num_steps or self._stop_requested:
                        break
            return

        def train_one(batch: Dict[str, Any]) -> None:
            m = self._optimize(batch)
            if self._steps_done + epochs < num_steps:
                self._prefetch_next()
            self._steps_done += epochs
            self._steps_done -= self._after_step(m, frames_per, epochs)

        def refresh_due() -> bool:
            # host-sync-ok: a host int
            return bool(refresh_every) and (self._steps_done // epochs) % refresh_every == 0

        if self.actor_mode == "external":
            # external: the actors are other processes; this loop trains and
            # publishes, the transport drain riding the prefetch lane
            self._publish_weights()
            while self._steps_done < num_steps and not self._stop_requested:
                batch = self._next_batch()
                if batch is None:
                    time.sleep(0.005)
                    self._util.phase("ingest_wait", 0.005)
                    continue
                train_one(batch)
                if refresh_due():
                    self._publish_weights()
            return
        # the host pool is rank 0's (None on the other ranks, which take
        # their shares of its rows at the same points of the loop)
        pool = self.host_pool
        if self._overlap:
            stop = threading.Event()
            actor_error: List[BaseException] = []

            def actor_loop() -> None:
                try:
                    while not stop.is_set():
                        pool.step()
                except BaseException as e:  # noqa: BLE001 - surfaced on the train thread
                    actor_error.append(e)

            thread = None
            if pool is not None:
                pool.set_params(self._actor_params_copy(), self.state.version)
                thread = threading.Thread(target=actor_loop, name="actor", daemon=True)
                thread.start()
            try:
                while self._steps_done < num_steps and not self._stop_requested:
                    if actor_error:
                        raise RuntimeError("the actor thread died; the learner cannot make progress") \
                            from actor_error[0]
                    batch = self._next_batch()
                    if batch is None:
                        time.sleep(0.002)
                        self._util.phase("ingest_wait", 0.002)
                        continue
                    train_one(batch)
                    if refresh_due():
                        self._push_pool_params(self._actor_params_copy())
                        self._refresh_league_opponent()
            finally:
                stop.set()
                if thread is not None:
                    thread.join(timeout=30.0)
            return
        while self._steps_done < num_steps and not self._stop_requested:
            # the actor phase plays the live params: it runs to its end on
            # this thread before the next update changes them
            self._push_pool_params(self.policy.state_dict())
            self._refresh_league_opponent()
            if pool is not None:
                pool.run(self._actor_steps, refresh_every=0)
            self._ingest()
            while (batch := self._next_batch()) is not None:
                train_one(batch)
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
        if self.pool is not None or self._best_agreed:
            self._maybe_save_best(self.pool.drain_stats() if self.pool is not None else {})
        self._flush_league_reports()
        self._publish_weights()
        self._drain_snapshots()
        if self.ckpt is not None:
            # every rank gathers its part; rank 0 writes
            pipeline = self._pipeline_state()
            opt_state = self._whole_opt_state()
            if self.is_chief:
                self._sync_fold_latest()
                self.ckpt.save(self.state, self.config, force=True, pipeline=pipeline,
                               mark_good=self._health is not None and self._health.unhealthy is None,
                               opt_state=opt_state)
                self.ckpt.wait()

    def train(self, num_steps: int, actor_steps_per_iter: Optional[int] = None, overlap: bool = False,
              refresh_every: int = 1) -> Dict[str, float]:
        """Run until ``num_steps`` optimizer steps have completed (rounded
        up to whole batches or fused calls; a rollback's rewound steps are
        trained again), or until ``request_stop``. Returns the last logged
        metrics, the actors' stats (``actor_*``), ``optimizer_steps``,
        ``frames_trained``, ``frames_per_sec`` and ``elapsed_sec``.

        ``refresh_every``: batches between weights publishes (``external``;
        and the device and fused loops on a transport other than the
        in-process one) or pushes to the host pool (``vec`` and ``scalar``
        with ``overlap``). ``overlap`` runs the host pool on its own thread;
        without it a pool phase of ``actor_steps_per_iter`` steps
        (``rollout_len`` by default) alternates with the updates. The final
        weights are published at the end. The run record gets its closing
        line."""
        self._t_start = time.time()
        self._frames_trained = self._steps_done = 0
        self._stall_s = 0.0
        self._refresh_every, self._overlap = refresh_every, overlap
        self._actor_steps = actor_steps_per_iter or self.config.ppo.rollout_len
        # the device and fused loops publish mid-run only to readers out of
        # process: the in-process transport has none (the other loops
        # publish on their own refresh cadence)
        self._midrun_every = (refresh_every if self.device_actor is not None
                              and not isinstance(self.transport, InProcTransport) else 0)
        self._run_mode_loop(num_steps)
        while True:
            rewound = self._settle()
            if not rewound or self._stop_requested:
                break
            self._steps_done -= rewound
            self._run_mode_loop(num_steps)
        self._seal()
        elapsed = time.time() - self._t_start
        actor_stats = self.pool.stats() if self.pool is not None else {}
        out = {
            **self._last_metrics,
            **{f"actor_{k}": v for k, v in actor_stats.items()},
            # host-sync-ok: host counters
            "optimizer_steps": float(self._steps_done),
            # host-sync-ok: host counters
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


def use_compile_cache(directory: str, kernels: bool) -> Dict[str, Any]:
    """``--compile-cache DIR``: build the kernel library into ``DIR/kernels``
    and the native rollout codec into ``DIR/native`` instead of the
    package's ``_build`` directories, then load both now (the kernels only
    when ``kernels``, i.e. on a card: the CPU has no ``nvcc``), so a process
    that finds them in ``DIR`` builds nothing. Prints one line with each
    library's seconds and whether it was built or loaded; returns them."""
    from dotaclient_tpu_torch.native import build as native_build
    from dotaclient_tpu_torch.ops import build as ops_build

    ops_build.set_build_dir(os.path.join(directory, "kernels"))
    native_build.set_build_dir(os.path.join(directory, "native"))
    out: Dict[str, Any] = {}
    libs = [("codec", native_build.library_path, native_build.load_library)]
    if kernels:
        libs.append(("kernels", ops_build.library_file, ops_build.kernel_library))
    for name, path_of, load in libs:
        path = path_of()
        before = os.path.getmtime(path) if os.path.exists(path) else None
        t0 = time.perf_counter()
        ok = load() is not None
        seconds = time.perf_counter() - t0
        after = os.path.getmtime(path) if os.path.exists(path) else None
        how = "unavailable" if not ok else "loaded" if before is not None and before == after else "built"
        out[name] = {"how": how, "seconds": seconds, "path": path}
    print("learner: compile cache " + directory + ": "
          + ", ".join(f"{k} {v['how']} in {v['seconds']:.2f} s ({v['path']})" for k, v in out.items()), flush=True)
    return out


def crash_checkpoint(learner: Learner) -> None:
    """``--on-crash-checkpoint``: land the engine's jobs, then a forced
    weights-only save, waited for, and its line. Whatever fails here is
    printed, never raised: the caller re-raises the original error."""
    if learner.state.shards is not None:
        # the gather would need every rank of the model group, whose state
        # after a crash on one is unknown
        print("learner: crash checkpoint skipped: the optimizer state is cut over the model axis, and its "
              "gather is a collective; resume from the last periodic checkpoint", flush=True)
        return
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
    p.add_argument("--actor", type=str, default=None, choices=ACTOR_MODES,
                   help="device: the buffered learner over the on-device rollout (default); fused: rollout "
                   "and update on the same chunk in one step; vec: an in-process host actor pool over the numpy "
                   "sim; scalar: the proto actor pool over the scalar sim; external: actor processes (python -m "
                   "dotaclient_tpu_torch.actor) over --transport socket or shm")
    p.add_argument("--no-vec", action="store_true",
                   help="use the scalar (proto) actor pool instead of the vectorized sim (--actor scalar)")
    p.add_argument("--transport", type=str, default="inproc", choices=("inproc", "socket", "shm", "amqp"),
                   help="the weights and experience transport: socket listens for actor processes on "
                   "--listen, shm serves actors on this host over shared memory (--shm-name), amqp goes through "
                   "the RabbitMQ broker at --amqp-host (needs pika); each implies --actor external")
    p.add_argument("--listen", type=str, default="127.0.0.1:7777", help="HOST:PORT for --transport socket")
    p.add_argument("--shm-name", type=str, default=None,
                   help="the shared-memory lane's name for --transport shm (default tpu-dota-<pid>; actors "
                   "connect with --connect shm://NAME)")
    p.add_argument("--amqp-host", type=str, default="localhost", help="HOST[:PORT] of the broker for --transport amqp")
    p.add_argument("--wire-dtype", type=str, default=None, choices=("float32", "bfloat16"),
                   help="the weights frames' dtype (transport.wire_dtype): bfloat16 halves the fanout's bytes, "
                   "actors widen on apply")
    p.add_argument("--rollout-wire-dtype", type=str, default=None, choices=("float32", "bfloat16"),
                   help="the rollouts' wire dtype (transport.rollout_wire_dtype; give the actors the same): "
                   "bfloat16 about halves the wire's and the ring's bytes, the ring widening on the card at take; "
                   "behavior_logp, rewards, dones, values and the carries stay f32")
    p.add_argument("--refresh-every", type=int, default=10,
                   help="publish the weights to the actors every N batches")
    p.add_argument("--overlap", action="store_true",
                   help="with --actor vec: run the actor pool on its own thread")
    p.add_argument("--steps-per-dispatch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--core", type=str, default=None, choices=("lstm", "transformer"),
                   help="policy core: the LSTM(128) (default) or the GTrXL-gated windowed-attention transformer")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="with --core transformer: experts per MoE FFN layer (0 = dense FFN)")
    p.add_argument("--trace-jsonl", type=str, default=None, metavar="PATH",
                   help="append sampled trace events (chunk hop timelines, publishes, dispatches) as JSON lines "
                   "to PATH; join a run's logs with python -m dotaclient_tpu_torch.utils.trace_report")
    p.add_argument("--trace-sample", type=int, default=None, metavar="N",
                   help="with --trace-jsonl: trace every Nth sampling decision (default "
                   "telemetry.trace_sample_n = 16; 1 traces every chunk)")
    p.add_argument("--fleet-interval", type=float, default=None, metavar="S",
                   help="merge the actors' and servers' fleet snapshots and evaluate the alert rules every S "
                   "seconds in the external modes (default telemetry.fleet_interval_s = 5; 0 disables)")
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
                   help="torch device (default: the current CUDA card, cuda:LOCAL_RANK under --multihost; 'cpu' "
                   "must be asked for)")
    p.add_argument("--mesh", type=str, default=None, metavar="K=V,...",
                   help="comma-separated MeshConfig overrides, e.g. 'data_parallel=2' or 'dcn_slices=2'; "
                   "data_parallel=-1 (default) takes every rank of the job; --dcn-slices and --model-parallel are "
                   "shorthands for the same fields (explicit --mesh keys win)")
    p.add_argument("--multihost", action="store_true",
                   help="join the job's process group before anything else (env:// as torch.distributed.run "
                   "sets it: NCCL on cards, gloo on the CPU); run every rank with it")
    p.add_argument("--dcn-slices", type=int, default=None, help="slices (hosts) of the job: the mesh's dcn axis")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="tensor-parallel width (the model axis, innermost): each rank keeps 1/N of the cut master "
                   "params and Adam moments, and the model ranks of a data shard compute on the gathered params")
    p.add_argument("--checkify", action="store_true",
                   help="debug numerics: every op of the buffered train step (forward, backward and the optimizer's "
                   "step) checked, raising on the first that produces a NaN or divides by zero, named (syncs the host "
                   "on every op: slow; never for production runs, never under a sync guard; not with --actor fused)")
    p.add_argument("--compile-cache", type=str, default=None, metavar="DIR",
                   help="build the CUDA kernel library and the native rollout codec into DIR (DIR/kernels, "
                   "DIR/native) instead of the package's _build directories and load them at start: processes that "
                   "share DIR build once (a read-only checkout can still cache its builds)")
    args = p.parse_args(argv)
    if args.actor is None:
        args.actor = "scalar" if args.no_vec else "external" if args.transport != "inproc" else "device"
    if args.checkify and args.actor == "fused":
        p.error("--checkify instruments the buffered train step, which --actor fused never calls")
    if args.compile_cache:
        use_compile_cache(args.compile_cache, kernels=not str(args.device or "cuda").startswith("cpu"))

    if args.multihost:
        # before any other collective or device work of this process
        pdist.initialize_runtime()
        import torch.distributed as dist

        backend = dist.get_backend() if pdist.is_initialized() else "no process group"
        print(f"learner: distributed runtime up: {pdist.process_info()} over {backend}", flush=True)
    config = default_config()
    mesh_over = {k: v for k, v in (("dcn_slices", args.dcn_slices), ("model_parallel", args.model_parallel))
                 if v is not None}
    if args.mesh:
        try:
            mesh_over.update(parse_dataclass_overrides(MeshConfig, args.mesh, "--mesh"))
        except ValueError as e:
            p.error(str(e))
    if mesh_over:
        config = dataclasses.replace(config, mesh=dataclasses.replace(config.mesh, **mesh_over))
    model_over = {k: v for k, v in (("core", args.core), ("moe_experts", args.moe_experts)) if v is not None}
    if model_over:
        config = dataclasses.replace(config, model=dataclasses.replace(config.model, **model_over))
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
    wire_over = {k: v for k, v in (("wire_dtype", args.wire_dtype),
                                   ("rollout_wire_dtype", args.rollout_wire_dtype)) if v is not None}
    if wire_over:
        config = dataclasses.replace(config, transport=dataclasses.replace(config.transport, **wire_over))
    if args.sync_snapshots:
        config = dataclasses.replace(config, learner=dataclasses.replace(config.learner, async_snapshots=False))
    config = dataclasses.replace(config, seed=args.seed)
    fleet_interval0 = telemetry.fleet_interval_s
    if args.fleet_interval is not None:
        # before the Learner: its FleetAggregator reads the knob at
        # construction (restored at the end, for embedding programs)
        telemetry.fleet_interval_s = args.fleet_interval
    # rank 0 alone writes the trace, the profile and the last line
    traced = bool(args.trace_jsonl) and pdist.process_info()["process_index"] == 0
    if traced:
        # before the Learner: the learner, its ring and its snapshot engine
        # capture tracing.get() at construction
        tracing.configure(args.trace_jsonl, sample_n=args.trace_sample)
    try:
        return _run_cli(args, config)
    finally:
        telemetry.fleet_interval_s = fleet_interval0
        if traced:
            # drain and fsync the trace log (a SIGKILL leaves at most a
            # torn last line, which the report skips)
            tracing.shutdown()
        if args.multihost and pdist.is_initialized():
            import torch.distributed as dist

            dist.destroy_process_group()


def _run_cli(args: argparse.Namespace, config: RunConfig) -> int:
    """The CLI's transport, learner, signal handlers, run and last line. On
    a world above 1 rank 0 alone binds the transport: the actors reach the
    job through it, and the other ranks never see them."""
    transport = None
    if pdist.process_info()["process_index"] != 0:
        pass
    elif args.transport == "socket":
        host, port = args.listen.rsplit(":", 1)
        t = config.transport
        transport = TransportServer(host, int(port), fanout_max_lag=t.fanout_max_lag,
                                    poison_frame_limit=t.poison_frame_limit,
                                    heartbeat_interval_s=t.heartbeat_interval_s, idle_timeout_s=t.idle_timeout_s)
        print(f"learner: listening for actors on {transport.address}", flush=True)
    elif args.transport == "shm":
        from dotaclient_tpu_torch.transport.shm_transport import ShmTransportServer

        t = config.transport
        transport = ShmTransportServer(name=args.shm_name, slots=t.shm_slots, ring_bytes=t.shm_ring_bytes,
                                       weights_bytes=t.shm_weights_bytes, poison_frame_limit=t.poison_frame_limit)
        print(f"learner: shm lane {transport.address!r} ({transport.slots} actor slots; actors: --connect "
              f"shm://{transport.address})", flush=True)
    elif args.transport == "amqp":
        host, _, port = args.amqp_host.partition(":")
        transport = AmqpTransport(host, int(port or 5672))
        print(f"learner: AMQP broker {host}:{port or 5672} (actors: --amqp {args.amqp_host})", flush=True)
    try:
        learner = Learner(config, actor=args.actor, seed=args.seed, device=args.device,
                          checkpoint_dir=args.checkpoint_dir, restore=args.restore, init_from=args.init_from,
                          logdir=args.logdir, metrics_jsonl=args.metrics_jsonl, transport=transport,
                          debug_checkify=args.checkify)
    except BaseException:
        if transport is not None:
            transport.close()
        raise

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
    from dotaclient_tpu_torch.ops import lstm

    launches0 = lstm.lstm_sequence_kernel.launches
    calls0 = serialize.codec_calls()
    try:
        with trace(args.profile if learner.is_chief else None):
            out = learner.train(args.steps, overlap=args.overlap, refresh_every=args.refresh_every)
    except BaseException as e:
        if args.on_crash_checkpoint and not isinstance(e, (KeyboardInterrupt, SystemExit)) \
                and learner.ckpt is not None and learner.is_chief:
            crash_checkpoint(learner)
        raise
    finally:
        learner.close()
        if transport is not None:
            transport.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    # the rollout codec's calls by path and the kernel's launches in this
    # run (0 on the CPU, where the plain version runs), read by
    # chip_smoke.py
    calls = {k: v - calls0[k] for k, v in serialize.codec_calls().items()}
    if not learner.is_chief:
        return 0
    print(f"done: {out['optimizer_steps']:.0f} steps, {out['frames_trained']:.0f} frames, "
          f"{out['frames_per_sec']:.0f} frames/sec, {calls['native_decodes']} native decodes, "
          f"{calls['native_encodes']} native encodes, {calls['proto_fallbacks']} proto fallbacks, "
          f"{lstm.lstm_sequence_kernel.launches - launches0} lstm_seq launches", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

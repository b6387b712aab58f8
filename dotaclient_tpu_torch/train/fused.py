"""The fused self-play iteration: rollout, then the PPO update on the chunk
it just produced, on the device with no host round trip.

Counterpart of ``dotaclient_tpu/train/fused.py`` (``lane_minibatches``,
``make_fused_step``). One call runs ``steps_per_dispatch`` iterations; each
rolls out T steps of every lane under ``torch.no_grad()`` with the live
params, then runs ``epochs_per_batch`` x ``minibatches`` updates on that
chunk. The train batch is the lane set, strictly on-policy: the chunk is
trained on by the params that made it (``ppo.batch_rollouts`` does not
apply). In league mode the opponent lanes play ``opp_params``, fixed for
the whole call; ``None`` means the live policy itself (self-play and the
scripted modes, where no opponent lane steps: one signature for all
modes). Nothing inside a call reads the device from the host, so the host
issues the whole iteration ahead of the card; ``chip_smoke.py`` runs it
under ``torch.cuda.set_sync_debug_mode("error")`` to hold it to that.

Minibatches (``minibatches`` > 1) are a fresh shard-local permutation of
the lanes for every epoch, drawn on the device from a generator seeded by
the run seed and the optimizer step at the epoch's start: each lane shard
(rank) permutes its own lanes and minibatch m is every shard's m-th group,
the reference's rule, so no lane crosses a rank. The JAX package draws its
permutations from its own key stream; ``lane_minibatches`` takes them as an
input, and parity across shard counts is held at ``minibatches=1``, as the
reference's is.

Data parallelism: with a lane-sharded actor (``DeviceActor.lane_shards`` >
1) each rank rolls out and trains on its own games' lanes, and the update's
reductions run over the actor's batch group (``train/ppo.py``). An actor
whose games do not split over the ranks runs every game on every rank on
the same stream, and each rank then trains the whole chunk with no group:
the reference's replicated layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from dotaclient_tpu_torch.actor.device_rollout import DeviceActor, DeviceActorState, PolicyParams
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.train.ppo import Batch, TrainState, _train_step, fold_scan_metrics, take_rows
from dotaclient_tpu_torch.utils.tree import tree_map


def lane_minibatches(chunk: Batch, step: int, seed: int, n_lanes: int, n_mb: int, n_shards: int = 1,
                     shard: int = 0, perm: Optional[torch.Tensor] = None) -> List[Batch]:
    """This shard's ``n_lanes`` lanes in a fresh order, cut into ``n_mb``
    minibatches of ``n_lanes // n_mb`` lanes each: minibatch m is the
    shard's m-th group. ``perm`` ``[n_shards, n_lanes]`` (one permutation a
    shard, row ``shard`` used) is drawn on the chunk's device from a
    generator seeded by (seed, step) when not given; every shard draws all
    of them, so the stream is the same on every rank."""
    device = chunk["rewards"].device
    if perm is None:
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * 1_000_003 + step) % (2 ** 63))
        perm = torch.stack([torch.randperm(n_lanes, generator=gen, device=device) for _ in range(n_shards)])
    mine = torch.as_tensor(perm[shard], device=device)
    size = n_lanes // n_mb
    return [take_rows(chunk, mine[m * size:(m + 1) * size]) for m in range(n_mb)]


def make_fused_step(config: RunConfig, actor: DeviceActor, anchor: Optional[Policy] = None):
    """``fused(state, actor_state, opp_params=None, noise=None,
    jitter=None) -> (state, actor_state, metrics, stats)``:
    ``steps_per_dispatch`` iterations of rollout and update, the opponent
    lanes (if any) under ``opp_params``; ``noise`` and ``jitter`` (the
    whole batch's, as ``DeviceActor._rollout_impl`` takes them) replace the
    generator's draws of a one-iteration call. ``metrics`` fold by
    ``fold_scan_metrics`` (the last update's, ``health_ok`` the minimum of
    all), ``stats`` sum over the iterations (this rank's games)."""
    if (config.ppo.anchor_kl_coef > 0) != (anchor is not None):
        raise ValueError("anchor must be passed exactly when ppo.anchor_kl_coef > 0")
    n_epochs = config.ppo.epochs_per_batch
    n_mb = max(1, config.ppo.minibatches)
    n_iters = config.steps_per_dispatch
    L = actor.n_lanes                      # this rank's lanes
    S = actor.lane_shards
    if L % n_mb:
        raise ValueError(
            f"fused minibatching splits the {L * S}-lane chunk along lanes WITHIN each of the {S} lane "
            f"shard(s): n_lanes must be divisible by data_parallel x minibatches ({S} x {n_mb} = {S * n_mb}) so "
            f"every shard contributes equal lane groups to each of the {n_mb} minibatch(es)"
        )
    probe = config.health.enabled
    cfg = config.ppo
    group = actor.batch_group

    def update(state: TrainState, batch: Batch):
        return _train_step(cfg, state, batch, anchor=anchor, probe=probe, group=group)

    def update_on_chunk(state: TrainState, chunk: Batch):
        epochs = []
        for _ in range(n_epochs):
            if n_mb == 1:
                state, m = update(state, chunk)
                epochs.append(m)
                continue
            per_mb = []
            for mb in lane_minibatches(chunk, state.step, config.seed, L, n_mb, S, actor.lane_shard):
                state, m = update(state, mb)
                per_mb.append(m)
            epochs.append(fold_scan_metrics(per_mb))
        return state, fold_scan_metrics(epochs)

    def fused(state: TrainState, actor_state: DeviceActorState, opp_params: Optional[PolicyParams] = None,
              noise: Optional[Dict[str, torch.Tensor]] = None, jitter: Optional[Dict[str, torch.Tensor]] = None):
        if (noise is not None or jitter is not None) and n_iters > 1:
            raise ValueError("injected noise and jitter are one iteration's: use steps_per_dispatch=1")
        metric_seq: List[Dict[str, torch.Tensor]] = []
        stat_seq = []
        for _ in range(n_iters):
            opp = state.policy if opp_params is None else opp_params
            with torch.no_grad():
                actor_state, chunk, stats = actor._rollout_impl(state.policy, actor_state, opp, noise=noise,
                                                                jitter=jitter)
            state, metrics = update_on_chunk(state, chunk)
            metric_seq.append(metrics)
            stat_seq.append(stats)
        stats = stat_seq[0] if n_iters == 1 else tree_map(lambda *s: torch.stack(s).sum(dim=0), *stat_seq)
        return state, actor_state, fold_scan_metrics(metric_seq), stats

    return fused

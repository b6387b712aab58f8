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

Minibatches (``minibatches`` > 1) are a fresh permutation of the lanes for
every epoch, drawn on the device from a generator seeded by the run seed
and the optimizer step at the epoch's start. The JAX package draws its
permutation from its own key stream; the two streams are not matched, and
parity between the packages is held at ``minibatches=1``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from dotaclient_tpu_torch.actor.device_rollout import DeviceActor, DeviceActorState, PolicyParams
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.train.ppo import Batch, TrainState, _train_step, fold_scan_metrics, take_rows
from dotaclient_tpu_torch.utils.tree import tree_map


def lane_minibatches(chunk: Batch, step: int, seed: int, n_lanes: int, n_mb: int) -> List[Batch]:
    """The chunk's lanes in a fresh order, cut into ``n_mb`` minibatches of
    ``n_lanes // n_mb`` lanes each. The permutation is drawn on the chunk's
    device from a generator seeded by (seed, step)."""
    device = chunk["rewards"].device
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + step) % (2 ** 63))
    perm = torch.randperm(n_lanes, generator=gen, device=device)
    size = n_lanes // n_mb
    return [take_rows(chunk, perm[m * size:(m + 1) * size]) for m in range(n_mb)]


def make_fused_step(config: RunConfig, actor: DeviceActor, anchor: Optional[Policy] = None):
    """``fused(state, actor_state, opp_params=None) -> (state,
    actor_state, metrics, stats)``: ``steps_per_dispatch`` iterations of
    rollout and update, the opponent lanes (if any) under ``opp_params``.
    ``metrics`` fold by ``fold_scan_metrics`` (the last update's,
    ``health_ok`` the minimum of all), ``stats`` sum over the iterations."""
    if (config.ppo.anchor_kl_coef > 0) != (anchor is not None):
        raise ValueError("anchor must be passed exactly when ppo.anchor_kl_coef > 0")
    n_epochs = config.ppo.epochs_per_batch
    n_mb = max(1, config.ppo.minibatches)
    n_iters = config.steps_per_dispatch
    L = actor.n_lanes
    if L % n_mb:
        raise ValueError(
            f"fused minibatching splits the {L}-lane chunk along lanes: n_lanes must be "
            f"divisible by minibatches ({n_mb})"
        )
    probe = config.health.enabled
    cfg = config.ppo

    def update(state: TrainState, batch: Batch):
        return _train_step(cfg, state, batch, anchor=anchor, probe=probe)

    def update_on_chunk(state: TrainState, chunk: Batch):
        epochs = []
        for _ in range(n_epochs):
            if n_mb == 1:
                state, m = update(state, chunk)
                epochs.append(m)
                continue
            per_mb = []
            for mb in lane_minibatches(chunk, state.step, config.seed, L, n_mb):
                state, m = update(state, mb)
                per_mb.append(m)
            epochs.append(fold_scan_metrics(per_mb))
        return state, fold_scan_metrics(epochs)

    def fused(state: TrainState, actor_state: DeviceActorState, opp_params: Optional[PolicyParams] = None):
        metric_seq: List[Dict[str, torch.Tensor]] = []
        stat_seq = []
        for _ in range(n_iters):
            opp = state.policy if opp_params is None else opp_params
            with torch.no_grad():
                actor_state, chunk, stats = actor._rollout_impl(state.policy, actor_state, opp)
            state, metrics = update_on_chunk(state, chunk)
            metric_seq.append(metrics)
            stat_seq.append(stats)
        stats = stat_seq[0] if n_iters == 1 else tree_map(lambda *s: torch.stack(s).sum(dim=0), *stat_seq)
        return state, actor_state, fold_scan_metrics(metric_seq), stats

    return fused

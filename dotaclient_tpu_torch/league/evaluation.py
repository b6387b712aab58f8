"""Win-rate evaluation: play full games on the device rollout, no training.

Counterpart of ``dotaclient_tpu/league/evaluation.py``. The system's
headline metric is the win rate against the hard scripted bot; league-side
it also says whether the policy beats its own frozen past.
``evaluate`` runs the inference-only policy (``make_inference_policy``, the
value head sliced out of both param sets, ``serve/policy_path.py``): eval
discards values, and sampling is untouched, so results equal the
training-shaped policy's.

``evaluate_served`` (the same games through a live serve server, on the
host scalar sim) needs ``envs/env_api.py`` and is not ported yet: ROADMAP
queue 1, item 4c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.serve.policy_path import make_inference_policy, slice_train_params
from dotaclient_tpu_torch.utils import telemetry


def evaluate(
    config: RunConfig,
    policy: Policy,
    params: Mapping[str, torch.Tensor],
    opponent: str = "scripted_hard",
    opponent_params: Optional[Mapping[str, torch.Tensor]] = None,
    n_games: int = 64,
    seed: int = 0,
    max_chunks: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Play ``n_games`` full games of ``params`` (a state dict) against
    ``opponent``, any ``EnvConfig`` opponent mode; ``"league"`` plays
    against ``opponent_params``, a frozen policy's state dict. Returns
    ``win_rate``, ``episodes`` and ``episode_reward_mean``. The games run
    on ``device`` (default: the current CUDA card; with no card it raises);
    the drains every 8 chunks are the only reads of the device.

    ``policy`` gives the architecture (training-shaped or inference-only);
    the eval actor always runs the inference-only module over sliced
    params."""
    dev = resolve_device(device)
    tel = telemetry.get_registry()
    eval_cfg = dataclasses.replace(
        config,
        model=policy.model, obs=policy.obs_spec, actions=policy.action_spec,
        env=dataclasses.replace(config.env, n_envs=n_games, opponent=opponent),
        # an eval measures one opponent: anchor games would swap some of
        # them to a scripted bot
        league=dataclasses.replace(config.league, anchor_prob=0.0),
        # eval chunks are read for stats and dropped, never shipped
        transport=dataclasses.replace(config.transport, rollout_wire_dtype="float32"),
    )
    # a private registry: the eval actor's counters must not mix with the
    # training pipeline's
    actor = DeviceActor(eval_cfg, make_inference_policy(eval_cfg, device=dev), seed=seed,
                        registry=telemetry.Registry(), device=dev)
    params = {k: v.to(dev) for k, v in slice_train_params(dict(params)).items()}
    if opponent_params is not None:
        opponent_params = {k: v.to(dev) for k, v in slice_train_params(dict(opponent_params)).items()}
    steps_per_episode = eval_cfg.env.max_dota_time / (eval_cfg.env.ticks_per_observation / 30.0)
    # enough chunks for every game to finish at least once, plus slack
    max_chunks = max_chunks or int(2 * steps_per_episode / config.ppo.rollout_len + 2)
    with tel.span("league/evaluate"):
        for i in range(max_chunks):
            actor.collect(params, opp_params=opponent_params)
            if i % 8 == 7 and actor.drain_stats()["episodes_done"] >= n_games:
                break
        stats = actor.drain_stats()
    # the outcome rides the shared registry beside the pipeline's telemetry
    tel.gauge("league/eval_win_rate").set(stats["win_rate"])
    tel.gauge("league/eval_episodes").set(stats["episodes_done"])
    tel.gauge("league/eval_reward_mean").set(stats["episode_reward_mean"])
    return {
        "win_rate": stats["win_rate"],
        "episodes": stats["episodes_done"],
        "episode_reward_mean": stats["episode_reward_mean"],
    }


def evaluate_served(
    config: RunConfig,
    address: Tuple[str, int],
    opponent: str = "scripted_hard",
    n_games: int = 8,
    seed: int = 0,
    max_steps: Optional[int] = None,
) -> Dict[str, Any]:
    """Games through a live serve server on the host scalar sim: not ported
    yet."""
    raise NotImplementedError(
        "evaluate_served plays on the host scalar sim (envs/env_api.py), which is not ported yet: "
        "ROADMAP queue 1, item 4c (the scalar path)"
    )

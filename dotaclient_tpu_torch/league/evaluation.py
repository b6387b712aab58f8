"""Win-rate evaluation: play full games on the device rollout, no training.

Counterpart of ``dotaclient_tpu/league/evaluation.py``. The system's
headline metric is the win rate against the hard scripted bot; league-side
it also says whether the policy beats its own frozen past.
``evaluate`` runs the inference-only policy (``make_inference_policy``, the
value head sliced out of both param sets, ``serve/policy_path.py``): eval
discards values, and sampling is untouched, so results equal the
training-shaped policy's.

``evaluate_served`` plays full games through a live serve server: the
serving plane's first real client and its end-to-end probe. The games run
on the host scalar game (``envs/env_api.py``) and every action comes back
over the request and reply wire, one ``ServeClient`` (one carry slot) for
each agent hero, ``reset=True`` on each episode's first step. Up to 16 games run
at once, their requests issued together from a thread pool, so the
server's batch window has real work to coalesce.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
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
) -> Dict[str, float]:
    """Play ``n_games`` full games through the serve server at ``address``
    (a ``PolicyServer``, e.g. ``python -m dotaclient_tpu_torch.serve``)
    against ``opponent``, any ``EnvConfig`` opponent mode. Returns
    ``win_rate``, ``episodes`` and ``episode_reward_mean``, as
    ``evaluate``; at most ``max_steps`` rounds (default: twice the games'
    length in steps, times the games, plus 16). This process needs no
    card: the server runs the policy."""
    from dotaclient_tpu_torch.actor.runtime import build_game_config
    from dotaclient_tpu_torch.envs.env_api import LocalDotaEnv
    from dotaclient_tpu_torch.features import decode_action, featurize, observation_to_dict, shaped_reward
    from dotaclient_tpu_torch.protos import dota_pb2 as pb
    from dotaclient_tpu_torch.serve.client import ServeClient

    host, port = address
    eval_cfg = dataclasses.replace(config, env=dataclasses.replace(config.env, opponent=opponent))
    tel = telemetry.get_registry()
    steps_per_episode = eval_cfg.env.max_dota_time / (eval_cfg.env.ticks_per_observation / 30.0)
    max_steps = max_steps or int(2 * steps_per_episode * n_games + 16)
    next_seed = seed

    class _Game:
        def __init__(self) -> None:
            nonlocal next_seed
            self.env = LocalDotaEnv()
            self.game_cfg = build_game_config(eval_cfg, next_seed)
            next_seed += 1
            self.lanes: List[Dict[str, Any]] = []   # one for each agent hero, with its client
            self.pending_actions: Dict[int, list] = {}
            self.reset()

        def reset(self) -> None:
            nonlocal next_seed
            init = self.env.reset(self.game_cfg)
            ws_by_team = {ws.team_id: ws for ws in init.world_states}
            agent_players = [(pid, pick.team_id) for pid, pick in enumerate(self.game_cfg.hero_picks)
                             if pick.control_mode == pb.CONTROL_AGENT]
            if not self.lanes:
                self.lanes = [{"client": ServeClient(host, port, config)} for _ in agent_players]
            for lane, (player_id, team_id) in zip(self.lanes, agent_players):
                lane.update(player_id=player_id, team_id=team_id, ws=ws_by_team[team_id], reset=True)
            self.episode_reward = 0.0
            # the next episode on this env gets a fresh draw
            self.game_cfg = build_game_config(eval_cfg, next_seed)
            next_seed += 1

        def close(self) -> None:
            for lane in self.lanes:
                lane["client"].close()

    games: List[_Game] = []
    episodes = wins = 0
    episode_rewards: List[float] = []

    def request_action(pair):
        """One lane's featurize and round trip, on the pool's threads, so
        every game's request is in flight at once."""
        game, lane = pair
        obs = featurize(lane["ws"], lane["player_id"], eval_cfg.obs, eval_cfg.actions)
        idx = lane["client"].step(observation_to_dict(obs), reset=lane["reset"])
        lane["reset"] = False
        lane["obs"] = obs
        return idx

    try:
        for _ in range(max(1, min(n_games, 16))):
            games.append(_Game())
        all_lanes = [(game, lane) for game in games for lane in game.lanes]
        with tel.span("league/evaluate"), ThreadPoolExecutor(max_workers=len(all_lanes)) as pool:
            for _ in range(max_steps):
                if episodes >= n_games:
                    break
                actions = list(pool.map(request_action, all_lanes))
                for (game, lane), idx in zip(all_lanes, actions):
                    game.pending_actions.setdefault(lane["team_id"], []).append(
                        decode_action(idx, lane["obs"], lane["player_id"], move_bins=eval_cfg.actions.move_bins))
                for game in games:
                    for team_id, protos in game.pending_actions.items():
                        game.env.act(pb.Actions(team_id=team_id, actions=protos))
                    game.pending_actions = {}
                    owner = game.lanes[0]
                    done = False
                    for lane in game.lanes:
                        ws = game.env.observe(lane["team_id"]).world_state
                        if lane is owner:
                            r, _ = shaped_reward(lane["ws"], ws, lane["player_id"],
                                                 weights=eval_cfg.reward.as_dict())
                            game.episode_reward += r
                        lane["ws"] = ws
                        done = done or game.env.done
                    if done:
                        episodes += 1
                        if owner["ws"].winning_team == owner["team_id"]:
                            wins += 1
                        episode_rewards.append(game.episode_reward)
                        game.reset()
    finally:
        for game in games:
            game.close()
    win_rate = wins / episodes if episodes else 0.0
    reward_mean = float(np.mean(episode_rewards)) if episode_rewards else 0.0
    tel.gauge("league/eval_win_rate").set(win_rate)
    tel.gauge("league/eval_episodes").set(float(episodes))
    tel.gauge("league/eval_reward_mean").set(reward_mean)
    return {"win_rate": win_rate, "episodes": float(episodes), "episode_reward_mean": reward_mean}

"""The scalar actor pool: many proto games, one batched policy step on the card.

Counterpart of ``dotaclient_tpu/actor/runtime.py``. The games are
``LocalDotaEnv`` (the dotaservice surface over the scalar ``LaneSim``); a
lane is one agent-controlled player in one game. Every step featurizes
each lane's ``WorldState`` (``features/featurizer.py``), stacks them, and
advances all lanes with one device step: the vec pool's
``make_device_step`` (carry rows of the lanes that reset zeroed,
``Policy.step`` with the ``lstm_seq`` kernel at T=1 on CUDA, every head
sampled, the actions, log-probs and f32 carry packed into one tensor) and
one copy back to the host. The actions go back to the games as ``Action``
protos, one ``Actions`` message a (game, team), and the shaped reward of
each lane comes from consecutive world states (``features/reward.py``).
Sampling takes injected Gumbel noise (``noise=``), so a test can feed it
the noise the JAX pool's key stream drew.

Chunks are the reference's: at most ``ppo.rollout_len`` steps and never
across episodes (an ended game ships its lanes' chunks early, padded with
``dones`` 1 and ``valid`` 0); ``carry0`` is the carry at the chunk's start,
the T+1 observations repeat the bootstrap one over the pad, and a chunk is
tagged with the oldest weights version that contributed to it. A chunk
goes to ``rollout_sink`` as a full-width ``Rollout`` proto, else to
``transport.publish_rollout`` (the learner's ``scalar`` mode hands it an
``InProcTransport``) at ``transport.rollout_wire_dtype``: a bf16 wire's
proto carries the narrow leaves and the ``__wire_cast__`` marker, as the
reference's does. ``refresh_weights`` applies the transport's newest
weights frame (the Flax layout, converted, moved to the card);
``set_params`` swaps the params and version as one tuple.

The pool steps its own copy of the policy module with ``functional_call``,
so a learner training the module it was given on another thread is never
touched. It runs the LSTM core only, as the reference's. Its utilization
plane (``utils/utilization.py`` ``make_actor``) is the vec pool's:
``env_step`` (the actions' protos, the games' act and observe, the reward),
``featurize`` (the per-lane featurize), ``encode`` (a chunk's assembly),
``ship_wait`` (its encode and publish) and the residual ``other``, folded at
the weights refreshes of ``run``. The reference's scalar pool stamps no
trace and ships no fleet snapshot, and neither does this one.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.actor.vec_runtime import _unpack, make_device_step, obs_to_device
from dotaclient_tpu_torch.actor.window_stats import WindowedStatsMixin
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.envs import lane_sim
from dotaclient_tpu_torch.envs.env_api import LocalDotaEnv
from dotaclient_tpu_torch.features import (
    Observation,
    decode_action,
    featurize,
    observation_to_dict,
    shaped_reward,
    stack_observations,
)
from dotaclient_tpu_torch.models import distributions as D
from dotaclient_tpu_torch.models.convert import convert
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.outcome import records as outcome_records
from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.transport.serialize import decode_weights, encode_rollout, rollout_wire_kwargs
from dotaclient_tpu_torch.utils import telemetry, utilization

Params = Dict[str, torch.Tensor]


def build_game_config(config: RunConfig, seed: int) -> pb.GameConfig:
    """``EnvConfig`` -> ``GameConfig`` proto: ``team_size`` agent heroes on
    Radiant, as many on Dire under the opponent's control mode, each hero
    drawn from ``hero_pool`` by ``default_rng(seed)``."""
    env = config.env
    picks = []
    pool = env.hero_pool or (1,)
    rng = np.random.default_rng(seed)
    opp_mode = {
        "scripted_easy": pb.CONTROL_SCRIPTED_EASY,
        "scripted_hard": pb.CONTROL_SCRIPTED_HARD,
        "selfplay": pb.CONTROL_AGENT,
        "league": pb.CONTROL_AGENT,
    }[env.opponent]
    for team, mode in ((lane_sim.TEAM_RADIANT, pb.CONTROL_AGENT), (lane_sim.TEAM_DIRE, opp_mode)):
        for _ in range(env.team_size):
            picks.append(pb.HeroPick(team_id=team, hero_id=int(rng.choice(pool)), control_mode=mode))
    return pb.GameConfig(
        ticks_per_observation=env.ticks_per_observation,
        seed=seed,
        max_dota_time=env.max_dota_time,
        hero_picks=picks,
    )


@dataclasses.dataclass
class _Lane:
    """One agent-controlled player inside one game, with its chunk in
    progress."""

    env_idx: int
    player_id: int
    team_id: int
    prev_ws: pb.WorldState = None  # type: ignore[assignment]
    obs: Observation = None        # type: ignore[assignment]
    obs_seq: List[Observation] = dataclasses.field(default_factory=list)
    actions: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    logps: List[float] = dataclasses.field(default_factory=list)
    rewards: List[float] = dataclasses.field(default_factory=list)
    dones: List[float] = dataclasses.field(default_factory=list)
    carry0: Tuple[np.ndarray, np.ndarray] = None  # type: ignore[assignment]
    # the version at the chunk's start: a refresh mid-chunk must not label
    # its earlier steps fresh, so a chunk ships with the oldest version
    # that contributed to it
    version0: int = 0
    episode_reward: float = 0.0


class ActorPool(WindowedStatsMixin):
    """N games of the scalar game, every agent lane stepped by one batched
    policy call: ``step``, ``run``, ``stats``, ``set_params``,
    ``refresh_weights``, ``params``, ``version``. ``opponent="selfplay"``
    makes every hero an agent lane sharing the params; scripted opponents
    play inside the games."""

    def __init__(
        self,
        config: RunConfig,
        policy: Policy,
        params: Params,
        transport: Any = None,
        env_factory: Callable[[], LocalDotaEnv] = LocalDotaEnv,
        seed: int = 0,
        version: int = 0,
        rollout_sink: Optional[Callable[["pb.Rollout"], None]] = None,
        device: DeviceLike = None,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        if config.model.core != "lstm":
            raise NotImplementedError(
                "ActorPool (the scalar path) supports the LSTM core only, as the reference's; the vec and device "
                "actors run any core"
            )
        self.config = config
        # the encode kwargs of the rollout wire, derived once
        self._wire_kwargs = rollout_wire_kwargs(config)
        self.device = resolve_device(device)
        # the pool's own module: functional_call swaps a module's params
        # for the call, which must never touch a module another thread
        # trains
        self.policy = copy.deepcopy(policy).requires_grad_(False)
        self._reward_weights = dict(config.reward.as_dict())
        self._warn_no_anchor_support()
        # (params, version) swap as one tuple: a refresh from another
        # thread mid-step must never tag a chunk with a version newer than
        # the params that produced it
        self._weights: Tuple[Params, int] = (params, version)
        self._chunk_version = version
        self.transport = transport
        self.rollout_sink = rollout_sink
        self._next_rollout_id = 0
        self._next_game_seed = seed * 100_003
        self._tel = registry if registry is not None else telemetry.get_registry()

        self.envs: List[LocalDotaEnv] = [env_factory() for _ in range(config.env.n_envs)]
        # each game's length in env steps (the outcome counters)
        self._ep_env_steps: List[int] = [0] * config.env.n_envs
        self._outcome_bucket = outcome_records.opponent_bucket(config.env.opponent)
        self.lanes: List[_Lane] = []
        for i, env in enumerate(self.envs):
            self._reset_env(i, env)
        n = len(self.lanes)
        self.n_lanes = n
        H = config.model.hidden_dim
        self._hidden = H
        # the recurrent carry stays on the card between steps
        self._carry_dev = self.policy.initial_state(n)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._reset_mask = np.zeros((n,), np.bool_)
        zeros_row = np.zeros((H,), np.float32)
        for lane in self.lanes:
            self._begin_chunk(lane, (zeros_row, zeros_row))
        self._step_fn = make_device_step(self.policy)

        self.env_steps = 0
        self.steps = 0
        self.rollouts_shipped = 0
        self.episodes_done = 0
        self.episode_rewards: List[float] = []
        self.wins = 0
        outcome_records.ensure_actor_metrics(self._tel)
        self._util = utilization.make_actor(self._tel)
        # every weights version this pool applied
        self.versions_applied = {version}

    # -- games and lanes -----------------------------------------------------------

    def _warn_no_anchor_support(self) -> None:
        cfg = self.config
        if cfg.env.opponent == "league" and cfg.league.anchor_prob > 0:
            print("WARNING: league.anchor_prob is implemented by the device, fused and vec actors; this scalar "
                  "pool runs pure snapshot self-play (no scripted-anchor games)", flush=True)

    def _reset_env(self, env_idx: int, env: LocalDotaEnv) -> None:
        game_cfg = build_game_config(self.config, self._next_game_seed)
        self._next_game_seed += 1
        self._ep_env_steps[env_idx] = 0
        init = env.reset(game_cfg)
        if init.status != pb.STATUS_OK:
            raise RuntimeError(f"env {env_idx}: reset returned status {init.status}")
        existing = [lane for lane in self.lanes if lane.env_idx == env_idx]
        ws_by_team = {ws.team_id: ws for ws in init.world_states}
        agent_players = self._agent_players(game_cfg)
        if existing:
            if len(existing) != len(agent_players):
                raise RuntimeError(f"env {env_idx}: {len(agent_players)} agent heroes after a reset, "
                                   f"{len(existing)} lanes")
            for lane, (player_id, team_id) in zip(existing, agent_players):
                lane.player_id = player_id
                lane.team_id = team_id
                ws = ws_by_team[team_id]
                lane.prev_ws = ws
                lane.obs = self._featurize(ws, player_id)
                lane.episode_reward = 0.0
        else:
            for player_id, team_id in agent_players:
                ws = ws_by_team[team_id]
                lane = _Lane(env_idx=env_idx, player_id=player_id, team_id=team_id)
                lane.prev_ws = ws
                lane.obs = self._featurize(ws, player_id)
                self.lanes.append(lane)

    @staticmethod
    def _agent_players(game_cfg: pb.GameConfig) -> List[Tuple[int, int]]:
        return [(pid, pick.team_id) for pid, pick in enumerate(game_cfg.hero_picks)
                if pick.control_mode == pb.CONTROL_AGENT]

    def _featurize(self, ws: pb.WorldState, player_id: int) -> Observation:
        return featurize(ws, player_id, self.config.obs, self.config.actions)

    def _begin_chunk(self, lane: _Lane, carry0: Tuple[np.ndarray, np.ndarray]) -> None:
        lane.obs_seq = []
        lane.actions = []
        lane.logps = []
        lane.rewards = []
        lane.dones = []
        lane.carry0 = (np.asarray(carry0[0], np.float32).copy(), np.asarray(carry0[1], np.float32).copy())
        lane.version0 = self._chunk_version

    # -- weights -------------------------------------------------------------------

    @property
    def params(self) -> Params:
        return self._weights[0]

    @property
    def version(self) -> int:
        return self._weights[1]

    def set_params(self, params: Params, version: int) -> None:
        """Play ``params`` (a state dict of device tensors) as ``version``
        from the next step on."""
        self._tel.gauge("actor/weight_refresh_lag").set(version - self.version)
        self._weights = (params, version)
        self.versions_applied.add(version)

    def refresh_weights(self) -> bool:
        """Apply the transport's newest weights frame if it is a new
        version; True when one was applied."""
        if self.transport is None:
            return False
        msg = self.transport.latest_weights()
        if msg is None or msg.version == self.version:
            return False
        self._tel.gauge("actor/weight_refresh_lag").set(msg.version - self.version)
        version, tree = decode_weights(msg)
        self._weights = ({k: v.to(self.device) for k, v in convert(tree).items()}, version)
        self.versions_applied.add(version)
        return True

    # -- stepping ------------------------------------------------------------------

    def step(self, noise: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Advance every lane one env step: one policy dispatch, one copy
        to the host. ``noise`` replaces the pool's own Gumbel draws."""
        with self._tel.span("actor/step"):
            self._step_impl(noise)
        self._tel.counter("actor/env_steps").inc(len(self.lanes))

    def _step_impl(self, noise: Optional[Dict[str, torch.Tensor]]) -> None:
        obs_batch = stack_observations([lane.obs for lane in self.lanes])
        # one read of the weights serves the whole step: the dispatch uses
        # these params, and chunks beginning this step get this version
        params, self._chunk_version = self._weights
        with self._tel.span("actor/infer"):
            packed, self._carry_dev = self._step_fn(
                params, obs_to_device(obs_batch, self.device), self._carry_dev,
                torch.from_numpy(self._reset_mask).to(self.device), generator=self._generator, noise=noise)
            actions_np, logp_np, carry_np = _unpack(packed.cpu().numpy(), self._carry_dev)
        self._reset_mask[:] = False
        self.steps += 1

        # from here to the end of the observe and reward loop is env_step,
        # but the per-lane featurize calls (counted apart)
        t_env = time.perf_counter()
        feat_s = 0.0
        # actions grouped by (game, team): a game steps once all its agent
        # teams have acted
        by_env_team: Dict[Tuple[int, int], List[pb.Action]] = {}
        for i, lane in enumerate(self.lanes):
            idx = {h: int(actions_np[i, j]) for j, h in enumerate(D.HEADS)}
            lane.actions.append(idx)
            lane.logps.append(float(logp_np[i]))
            lane.obs_seq.append(lane.obs)
            proto = decode_action(idx, lane.obs, lane.player_id, move_bins=self.config.actions.move_bins)
            by_env_team.setdefault((lane.env_idx, lane.team_id), []).append(proto)
        for (env_idx, team_id), protos in by_env_team.items():
            self.envs[env_idx].act(pb.Actions(team_id=team_id, actions=protos))

        # observe, reward, find the episode and chunk ends
        T = self.config.ppo.rollout_len
        finished: List[Tuple[int, _Lane, bool]] = []
        for e in range(len(self.envs)):
            self._ep_env_steps[e] += 1
        step_terms: Dict[str, float] = {}
        for i, lane in enumerate(self.lanes):
            env = self.envs[lane.env_idx]
            ws = env.observe(lane.team_id).world_state
            r, terms = shaped_reward(lane.prev_ws, ws, lane.player_id, weights=self._reward_weights)
            for term, tv in terms.items():
                step_terms[term] = step_terms.get(term, 0.0) + tv
            done = env.done
            lane.rewards.append(r)
            lane.dones.append(1.0 if done else 0.0)
            lane.episode_reward += r
            lane.prev_ws = ws
            t_f = time.perf_counter()
            lane.obs = self._featurize(ws, lane.player_id)
            feat_s += time.perf_counter() - t_f
            self.env_steps += 1
            if done:
                # a fresh episode, a fresh carry: the device step zeroes
                # this row on the next call, and the new chunk's carry0 is
                # zeros to match
                self._reset_mask[i] = True
            if done or len(lane.actions) >= T:
                finished.append((i, lane, done))
            if done and lane is self._env_owner(lane.env_idx):
                self._on_episode_end(lane.env_idx, ws)
        outcome_records.add_reward_terms(self._tel, step_terms)
        if self._util is not None:
            self._util.phase("featurize", feat_s)
            self._util.phase("env_step", time.perf_counter() - t_env - feat_s)

        if finished:
            zeros_row = np.zeros((self._hidden,), np.float32)
            for i, lane, done in finished:
                self._finish_chunk(lane)
                self._begin_chunk(lane, (zeros_row, zeros_row) if done else (carry_np[0][i], carry_np[1][i]))

        # reset the ended games, after every lane shipped its chunk
        for env_idx, env in enumerate(self.envs):
            if env.done:
                self._reset_env(env_idx, env)

    def _env_owner(self, env_idx: int) -> _Lane:
        """A game's first lane (each episode is counted once, by it)."""
        return next(lane for lane in self.lanes if lane.env_idx == env_idx)

    def _on_episode_end(self, env_idx: int, ws: pb.WorldState) -> None:
        self.episodes_done += 1
        owner = self._env_owner(env_idx)
        self.episode_rewards.append(owner.episode_reward)
        won = ws.winning_team == owner.team_id
        if won:
            self.wins += 1
        self.record_episode_outcome(self._outcome_bucket, won, self._ep_env_steps[env_idx],
                                    side="radiant" if owner.team_id == lane_sim.TEAM_RADIANT else "dire",
                                    registry=self._tel)

    def _finish_chunk(self, lane: _Lane) -> None:
        """Pad, pack and ship one lane's chunk."""
        t_enc = time.perf_counter()
        T = self.config.ppo.rollout_len
        n = len(lane.actions)
        if not 0 < n <= T:
            raise RuntimeError(f"a chunk of {n} steps (rollout_len {T})")
        valid = [1.0] * n + [0.0] * (T - n)
        # the n step observations and the bootstrap one, repeated to T+1
        obs_seq = lane.obs_seq + [lane.obs] * (T + 1 - n)
        dicts = [observation_to_dict(o) for o in obs_seq]
        arrays = {
            "obs": {k: np.stack([d[k] for d in dicts]) for k in dicts[0]},
            "actions": {h: np.asarray([a[h] for a in lane.actions] + [0] * (T - n), np.int32)
                        for h in self.config.actions.head_sizes},
            "behavior_logp": np.asarray(lane.logps + [0.0] * (T - n), np.float32),
            "rewards": np.asarray(lane.rewards + [0.0] * (T - n), np.float32),
            "dones": np.asarray(lane.dones + [1.0] * (T - n), np.float32),
            "valid": np.asarray(valid, np.float32),
            "carry0": (lane.carry0[0], lane.carry0[1]),
        }
        meta = dict(model_version=lane.version0, env_id=lane.env_idx, rollout_id=self._next_rollout_id, length=n,
                    total_reward=float(np.sum(lane.rewards)))
        self._next_rollout_id += 1
        t_ship = time.perf_counter()
        # the chunk's assembly is encode; its proto and publish, ship_wait
        if self._util is not None:
            self._util.phase("encode", t_ship - t_enc)
        if self.rollout_sink is not None:
            # in process: full width, no wire to save bytes on
            self.rollout_sink(encode_rollout(arrays, **meta))
        elif self.transport is not None:
            self.transport.publish_rollout(encode_rollout(arrays, **meta, **self._wire_kwargs))
        if self._util is not None:
            self._util.phase("ship_wait", time.perf_counter() - t_ship)
        self.rollouts_shipped += 1
        self._tel.counter("actor/rollouts_shipped").inc()
        self._tel.counter("actor/frames_shipped").inc(n)

    # -- driving -------------------------------------------------------------------

    def run(self, n_steps: int, refresh_every: int = 8) -> Dict[str, float]:
        """``n_steps`` steps, polling for new weights every
        ``refresh_every`` (0: never); returns ``stats()``."""
        for t in range(n_steps):
            if refresh_every and t % refresh_every == 0:
                self.refresh_weights()
                if self._util is not None:
                    self._util.maybe_fold()   # cadence-gated: one clock compare
            self.step()
        return self.stats()

    def stats(self) -> Dict[str, float]:
        recent = self.episode_rewards[-20:]
        return {
            "env_steps": float(self.env_steps),
            "rollouts_shipped": float(self.rollouts_shipped),
            "episodes_done": float(self.episodes_done),
            "episode_reward_mean": float(np.mean(recent)) if recent else 0.0,
            "win_rate": self.wins / self.episodes_done if self.episodes_done else 0.0,
            **self.windowed_entries(),
        }

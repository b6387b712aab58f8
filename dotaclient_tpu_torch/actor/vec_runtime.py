"""The host actor pool: N games x P players stepped as numpy arrays, the
policy on the card.

Counterpart of ``dotaclient_tpu/actor/vec_runtime.py``. The environment is
the numpy ``VecLaneSim``; featurize, reward and action translation are one
vectorized call each (``features/vec_featurizer.py``). A step is one policy
dispatch and one copy back to the host: ``make_device_step`` masks the
carry of the lanes that reset, runs ``Policy.step`` (the ``lstm_seq`` kernel
at T=1 on CUDA), samples every head and packs the actions, log-probs and
the f32 carry into one tensor, which ``step`` copies to the host once.
Sampling takes injected Gumbel noise (``noise=``), like every sampling point
of the port, so a test can feed it the noise the JAX side drew.

Chunks are the reference's: a lane's chunk ships when it has
``rollout_len`` steps or its game ends, with the carry at its start
(``carry0``), T+1 observations (the bootstrap one repeated over the pad),
and the version of the weights it started under. Decoded ``(meta, arrays)``
go to ``rollout_sink`` in process (the learner's ``vec`` mode), or are
encoded (``encode_rollout_bytes``) and published over a transport (the
actor CLI). ``refresh_weights`` applies the transport's newest weights
frame: decoded, converted from the Flax layout (``models/convert.py``) and
moved to the card. In league mode ``_OpponentLanes`` drives the Dire side
with frozen params; its experience never ships.

The pool steps its own copy of the policy module with ``functional_call``,
so a learner training the module it was given on another thread is never
disturbed. With a process fleet publisher installed (``utils/fleet.py``
``configure``, as the actor CLI does) ``run`` ships the registry's snapshot
over the transport after each weights refresh, at the publisher's cadence.

The utilization plane (``utils/utilization.py`` ``make_actor``) splits the
pool's wall clock into ``env_step`` (the sim and the reward),
``featurize``, ``encode`` (chunk assembly and trace stamps), ``ship_wait``
(the publish: a socket send, or an shm slot claim and copy) and the
residual ``other`` (the policy step among it), folded into
``util/actor/*`` at the weights refreshes of ``run``. With a tracer
configured when the pool is built (``utils/tracing.py``), every
``trace_sample_n``-th chunk gets a record with its ``collect`` (the lane's
chunk start) and ``encode`` hops, emitted here and carried as a padded
blob on the wire or as ``meta["trace"]`` in process, and a weights refresh
emits an ``apply`` event with the frame's publish stamp.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from dotaclient_tpu_torch.actor.window_stats import WindowedStatsMixin
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.envs.lane_sim import CONTROL_AGENT, TEAM_RADIANT
from dotaclient_tpu_torch.envs.vec_lane_sim import (
    OPPONENT_CONTROL,
    VecLaneSim,
    VecSimSpec,
    apply_anchor_games,
    draft_games,
)
from dotaclient_tpu_torch.features.vec_featurizer import VecFeaturizer, VecRewards
from dotaclient_tpu_torch.models import distributions as D
from dotaclient_tpu_torch.models.convert import convert
from dotaclient_tpu_torch.models.policy import Carry, Policy, mask_carry
from dotaclient_tpu_torch.outcome import records as outcome_records
from dotaclient_tpu_torch.transport.serialize import (
    decode_weights,
    encode_rollout,
    encode_rollout_bytes,
    rollout_wire_kwargs,
    weights_trace,
)
from dotaclient_tpu_torch.utils import faults, fleet, telemetry, tracing, utilization
from dotaclient_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

DecodedRollout = Tuple[Dict[str, Any], Any]
Params = Dict[str, torch.Tensor]


def make_device_step(policy: Policy) -> Callable[..., Tuple[torch.Tensor, Carry]]:
    """The pool's device step: ``step(params, obs, carry, reset_mask,
    generator=None, noise=None) -> (packed, new_carry)``. ``params`` is a
    state dict applied to ``policy`` with ``functional_call``; ``obs`` and
    ``reset_mask`` are device tensors. ``packed`` is one f32 tensor
    ``[L, 5 + 1 + C]``: the five head indices (exact in f32), the joint
    log-prob and every leaf of the new carry in f32, flattened to ``[L, -1]``
    in ``tree_leaves`` order (C values a row: 2H for the LSTM's (c, h)), for
    the one copy to the host."""

    @torch.no_grad()
    def step(params: Params, obs: Dict[str, torch.Tensor], carry, reset_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None, noise: Optional[Dict[str, torch.Tensor]] = None):
        carry = mask_carry(carry, 1.0 - reset_mask.float())
        logits, _, new_carry = functional_call(policy, params, (obs, carry))
        actions, logp = D.sample(logits, obs, generator=generator, noise=noise)
        L = logp.shape[0]
        packed = torch.cat([torch.stack([actions[h] for h in D.HEADS], dim=1).float(), logp[:, None].float(),
                            *(t.float().reshape(L, -1) for t in tree_leaves(new_carry))], dim=1)
        return packed, new_carry

    return step


def obs_to_device(obs: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host pool's stacked observation leaves onto ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in obs.items()}


def _unpack(host: np.ndarray, template: Any) -> Tuple[np.ndarray, np.ndarray, Any]:
    """The host copy of ``packed`` -> (actions int32 [L, 5], logp [L], the
    carry in f32 with ``template``'s tree and row shapes)."""
    n = len(D.HEADS)
    L, col = host.shape[0], n + 1
    leaves = []
    for t in tree_leaves(template):
        size = int(np.prod(t.shape[1:], dtype=np.int64))
        leaves.append(host[:, col:col + size].reshape((L,) + tuple(t.shape[1:])))
        col += size
    return host[:, :n].astype(np.int32), host[:, n], tree_unflatten(template, leaves)


class VecActorPool(WindowedStatsMixin):
    """The batched host actor: ``step``, ``run``, ``stats``, ``set_params``,
    ``refresh_weights``, ``flush_partial``, ``params``, ``version``."""

    def __init__(
        self,
        config: RunConfig,
        policy: Policy,
        params: Params,
        transport: Any = None,
        seed: int = 0,
        version: int = 0,
        rollout_sink: Optional[Callable[[List[DecodedRollout]], None]] = None,
        device: DeviceLike = None,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        # the pool's own module: functional_call swaps a module's params
        # for the call, which must never touch a module another thread
        # trains
        self.policy = copy.deepcopy(policy).requires_grad_(False)
        self._weights: Tuple[Params, int] = (params, version)
        self.transport = transport
        self.rollout_sink = rollout_sink
        env = config.env
        N, P = env.n_envs, 2 * env.team_size
        spec = VecSimSpec(n_games=N, team_size=env.team_size, max_units=config.obs.max_units,
                          ticks_per_obs=env.ticks_per_observation, max_dota_time=env.max_dota_time,
                          move_bins=config.actions.move_bins)
        hero_ids, control = draft_games(N, env.team_size, env.hero_pool, env.opponent, seed)
        # host-pool league draws never feed PFSP, so anchor games need no
        # attribution mask here (the device actor has one)
        self.n_anchor_games = apply_anchor_games(control, env.team_size, env.opponent, config.league)
        self.sim = VecLaneSim(spec, hero_ids, control, seed=seed)
        self._reseed_rng = np.random.default_rng(seed ^ 0x5EED)

        # learner lanes: the Radiant agents, and the Dire side in self-play;
        # league opponents get frozen params through set_opponent
        if OPPONENT_CONTROL[env.opponent] == CONTROL_AGENT:
            learner_players = list(range(P)) if env.opponent == "selfplay" else list(range(env.team_size))
            opponent_players = [] if env.opponent == "selfplay" else list(range(env.team_size, P))
        else:
            learner_players, opponent_players = list(range(env.team_size)), []
        self.feat = VecFeaturizer(self.sim, config.obs, config.actions, learner_players)
        self.rewards = VecRewards(self.sim, learner_players, weights=dict(config.reward.as_dict()))
        self._step_fn = make_device_step(self.policy)
        self._opponent: Optional[_OpponentLanes] = None
        if opponent_players:
            self._opponent = _OpponentLanes(self, opponent_players, params, version)

        L = self.feat.n_lanes
        self.n_lanes = L
        T = config.ppo.rollout_len
        self._carry_dev = self.policy.initial_state(L)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._reset_mask = np.zeros((L,), np.bool_)

        obs0 = self.feat.featurize_all()
        self._pending_obs = obs0
        self._obs_buf = {k: np.zeros((L, T + 1) + v.shape[1:], v.dtype) for k, v in obs0.items()}
        self._act_buf = np.zeros((L, T, len(D.HEADS)), np.int32)
        self._logp_buf = np.zeros((L, T), np.float32)
        self._rew_buf = np.zeros((L, T), np.float32)
        self._done_buf = np.zeros((L, T), np.float32)
        self._cursor = np.zeros((L,), np.int64)
        # the carry at each lane's chunk start: host f32 buffers mirroring
        # the policy's carry tree
        self._carry0 = tree_map(lambda t: np.zeros(tuple(t.shape), np.float32), self._carry_dev)
        self._version0 = np.full((L,), version, np.int64)
        self._lane_reward = np.zeros((L,), np.float64)

        self._next_rollout_id = 0
        self.env_steps = 0
        self.steps = 0
        self.rollouts_shipped = 0
        self.episodes_done = 0
        self.episode_rewards: List[float] = []
        self.wins = 0
        self._tel = registry if registry is not None else telemetry.get_registry()
        outcome_records.ensure_actor_metrics(self._tel)
        self._outcome_bucket = outcome_records.opponent_bucket(env.opponent)
        self._ep_game_steps = np.zeros((N,), np.int64)
        self._faults = faults.get()   # None unless fault injection is on
        self._fleet = fleet.get()     # None unless the process ships fleet snapshots
        # captured once: tracing off costs one pointer test a ship; the
        # lanes' chunk-start stamps exist only when tracing is on
        self._tracer = tracing.get()
        self._actor_tag = seed & 0xFFFF
        self._chunk_start = np.full((L,), tracing.now()) if self._tracer is not None else None
        self._util = utilization.make_actor(self._tel)
        self._wire_kwargs = rollout_wire_kwargs(config)
        # every weights version this pool applied
        self.versions_applied = {version}

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

    def set_opponent(self, params: Params, version: int) -> None:
        """The league opponent lanes' frozen params."""
        if self._opponent is None:
            raise ValueError("no opponent lanes (the opponent is scripted or selfplay)")
        self._opponent.set_params(params, version)

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
        if self._tracer is not None:
            # the publish->apply leg: the frame's publish stamp, when the
            # learner traces too
            rec = tracing.parse_blob(weights_trace(msg) or b"")
            publish_ts = rec["hops"][0][1] if rec and rec["hops"] else None
            self._tracer.emit("apply", version=int(version), publish_ts=publish_ts)
        return True

    # -- stepping -------------------------------------------------------------------

    def _to_device(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return obs_to_device(obs, self.device)

    def step(self, noise: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Advance every game one step: one policy dispatch, one copy to
        the host. ``noise`` replaces the pool's own Gumbel draws."""
        with self._tel.span("actor/step"):
            self._step_impl(noise)
        self._tel.counter("actor/env_steps").inc(self.n_lanes)

    def _step_impl(self, noise: Optional[Dict[str, torch.Tensor]]) -> None:
        T = self.config.ppo.rollout_len
        L = self.n_lanes
        lanes = np.arange(L)
        obs = self._pending_obs
        params, version = self._weights

        # span/actor/infer: the dispatch and the one copy back; the
        # opponent's step between them overlaps the card and is left out
        t0 = time.perf_counter()
        packed, self._carry_dev = self._step_fn(
            params, self._to_device(obs), self._carry_dev,
            torch.from_numpy(self._reset_mask).to(self.device), generator=self._generator, noise=noise)
        infer_s = time.perf_counter() - t0
        opp_actions = self._opponent.step() if self._opponent is not None else None
        t1 = time.perf_counter()
        actions_np, logp_np, carry_np = _unpack(packed.cpu().numpy(), self._carry_dev)
        infer_s += time.perf_counter() - t1
        self._tel.timer("span/actor/infer").observe(infer_s)
        self._reset_mask[:] = False

        # the pre-action obs and the sampled actions at each lane's cursor
        cur = self._cursor
        for k, v in obs.items():
            self._obs_buf[k][lanes, cur] = v
        self._act_buf[lanes, cur] = actions_np
        self._logp_buf[lanes, cur] = logp_np

        sim_actions = self.feat.actions_to_sim(actions_np)
        if opp_actions is not None:
            for k in sim_actions:
                np.copyto(sim_actions[k], opp_actions[k], where=self._opponent.player_mask[None, :])
        t_env = time.perf_counter()
        self.sim.step(sim_actions)
        r = self.rewards.compute()                                 # [L]
        if self._util is not None:
            self._util.phase("env_step", time.perf_counter() - t_env)
        self._ep_game_steps += 1
        outcome_records.add_reward_terms(self._tel, self.rewards.last_term_sums)
        done_game = self.sim.done                                  # [N]
        done_lane = np.repeat(done_game, len(self.feat.agent_players))
        self._rew_buf[lanes, cur] = r
        self._done_buf[lanes, cur] = done_lane
        self._lane_reward += r
        self._cursor += 1
        self.env_steps += L
        self.steps += 1

        t_feat = time.perf_counter()
        obs_next = self.feat.featurize_all()
        if self._util is not None:
            self._util.phase("featurize", time.perf_counter() - t_feat)
        finished = (self._cursor >= T) | done_lane
        if finished.any():
            self._emit_chunks(np.nonzero(finished)[0], done_lane, obs_next, carry_np, version)
        if done_game.any():
            games = np.nonzero(done_game)[0]
            self._record_episodes(games)
            self.sim.reset(games, seeds=self._reseed_rng.integers(0, 2**31 - 1, size=len(games)))
            # the reset is not an experienced transition: without a new
            # snapshot the next reward would credit the reset's delta
            self.rewards.snapshot()
            if self._opponent is not None:
                self._opponent.on_reset(games)
            self._reset_mask |= done_lane
            t_feat = time.perf_counter()
            obs_next = self.feat.featurize_all()   # the fresh episodes'
            if self._util is not None:
                self._util.phase("featurize", time.perf_counter() - t_feat)
        self._pending_obs = obs_next

    def _emit_chunks(self, lanes: np.ndarray, done_lane: np.ndarray, obs_next: Dict[str, np.ndarray],
                     carry_np: Any, version: int) -> None:
        """Ship the finished lanes' chunks and restart their accumulators."""
        T = self.config.ppo.rollout_len
        out: List[DecodedRollout] = []
        blobs: List[Optional[bytes]] = []   # a chunk's wire trace blob
        t_enc = time.perf_counter()
        for lane in lanes:
            n = int(self._cursor[lane])
            done = bool(done_lane[lane])
            # the bootstrap obs at position n, repeated over the pad
            for k, v in obs_next.items():
                self._obs_buf[k][lane, n:] = v[lane]
            self._act_buf[lane, n:] = 0
            self._logp_buf[lane, n:] = 0.0
            self._rew_buf[lane, n:] = 0.0
            self._done_buf[lane, n:] = 1.0
            valid = np.zeros((T,), np.float32)
            valid[:n] = 1.0
            arrays = {
                "obs": {k: v[lane].copy() for k, v in self._obs_buf.items()},
                "actions": {h: self._act_buf[lane, :, j].copy() for j, h in enumerate(D.HEADS)},
                "behavior_logp": self._logp_buf[lane].copy(),
                "rewards": self._rew_buf[lane].copy(),
                "dones": self._done_buf[lane].copy(),
                "valid": valid,
                "carry0": tree_map(lambda b: b[lane].copy(), self._carry0),
            }
            meta = {
                "model_version": int(self._version0[lane]),
                "env_id": int(lane) // max(len(self.feat.agent_players), 1),
                "rollout_id": self._next_rollout_id,
                "length": n,
                "total_reward": float(self._rew_buf[lane, :n].sum()),
            }
            self._next_rollout_id += 1
            blob = None
            if self._tracer is not None:
                # collect: when this lane's chunk began (its last ship, or
                # the pool's start)
                collect_ts = float(self._chunk_start[lane])
                self._chunk_start[lane] = tracing.now()
                if self._tracer.should_sample():
                    rec = tracing.new_record(self._tracer.next_tid(self._actor_tag), self._actor_tag,
                                             meta["model_version"])
                    rec["hops"].append(["collect", collect_ts])
                    tracing.append_hop(rec, "encode")
                    # the actor's side of the record, kept even when this
                    # process is SIGKILLed later
                    self._tracer.emit_chunk(rec)
                    if self.rollout_sink is not None:
                        meta["trace"] = rec   # in process the record rides the meta
                    else:
                        blob = tracing.record_to_blob(rec)
            blobs.append(blob)
            if self._faults is not None and self._faults.fire("actor.nonfinite_payload"):
                # a NaN reward in a well-formed frame: the learner ring's
                # admission check must drop it
                arrays["rewards"][0] = np.nan
            out.append((meta, arrays))
            self._cursor[lane] = 0
            self._version0[lane] = version
            for buf, src in zip(tree_leaves(self._carry0), tree_leaves(carry_np)):
                buf[lane] = 0.0 if done else src[lane]
        # encode: the chunks' assembly and trace stamps; the publish below
        # is ship_wait
        if self._util is not None:
            self._util.phase("encode", time.perf_counter() - t_enc)
        self._tel.counter("actor/rollouts_shipped").inc(len(out))
        self._tel.counter("actor/frames_shipped").inc(float(sum(m["length"] for m, _ in out)))
        t_ship = time.perf_counter()
        if self.rollout_sink is not None:
            self.rollout_sink(out)
        elif self.transport is not None:
            publish_bytes = getattr(self.transport, "publish_rollout_bytes", None)
            for (meta, arrays), blob in zip(out, blobs):
                if publish_bytes is not None:
                    publish_bytes(encode_rollout_bytes(arrays, **meta, **self._wire_kwargs, trace=blob))
                else:
                    self.transport.publish_rollout(encode_rollout(arrays, **meta, **self._wire_kwargs, trace=blob))
        if self._util is not None:
            self._util.phase("ship_wait", time.perf_counter() - t_ship)
        self.rollouts_shipped += len(out)

    def _record_episodes(self, games: np.ndarray) -> None:
        A = len(self.feat.agent_players)
        owner_team = self.sim.player_team(int(self.feat.agent_players[0]))
        side = "radiant" if owner_team == TEAM_RADIANT else "dire"
        for g in games:
            g = int(g)
            self.episodes_done += 1
            self.episode_rewards.append(float(self._lane_reward[g * A]))
            won = int(self.sim.winning_team[g]) == owner_team
            if won:
                self.wins += 1
            # anchor games (the first n_anchor_games) played a scripted bot
            bucket = "vs_scripted" if g < self.n_anchor_games else self._outcome_bucket
            self.record_episode_outcome(bucket, won, int(self._ep_game_steps[g]), side=side, registry=self._tel)
            self._ep_game_steps[g] = 0
            self._lane_reward[g * A:(g + 1) * A] = 0.0

    # -- driving ----------------------------------------------------------------------

    def run(self, n_steps: int, refresh_every: int = 8) -> Dict[str, float]:
        """``n_steps`` steps, polling for new weights every
        ``refresh_every`` (0: never)."""
        for t in range(n_steps):
            if refresh_every and t % refresh_every == 0:
                self.refresh_weights()
                if self._fleet is not None and self.transport is not None:
                    # cadence-gated inside; a send error propagates like a
                    # failed rollout publish, to the caller's reconnect
                    self._fleet.maybe_publish(self.transport)
                if self._util is not None:
                    self._util.maybe_fold()   # cadence-gated: one clock compare
            self.step()
        return self.stats()

    def flush_partial(self) -> int:
        """Ship every lane's chunk in progress now, with its true
        ``length`` and a padded tail (the graceful stop); returns the
        count."""
        lanes = np.nonzero(self._cursor > 0)[0]
        if len(lanes) == 0:
            return 0
        carry_np = tree_map(lambda t: t.float().cpu().numpy(), self._carry_dev)
        self._emit_chunks(lanes, np.zeros(self.n_lanes, dtype=bool), self._pending_obs, carry_np, self.version)
        return len(lanes)

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


class _OpponentLanes:
    """The league's opponent players: frozen params drive the Dire side
    through a second featurizer and device step; their experience never
    ships."""

    def __init__(self, pool: VecActorPool, players: List[int], params: Params, version: int) -> None:
        self.pool = pool
        self.players = players
        self.player_mask = np.zeros((pool.sim.spec.n_players,), bool)
        self.player_mask[players] = True
        self.feat = VecFeaturizer(pool.sim, pool.config.obs, pool.config.actions, players)
        self._weights = (params, version)
        self._carry = pool.policy.initial_state(self.feat.n_lanes)
        self._generator = torch.Generator(device=pool.device)
        self._generator.manual_seed(hash(tuple(players)) & 0x7FFFFFFF)
        self._reset = np.zeros((self.feat.n_lanes,), np.bool_)

    def set_params(self, params: Params, version: int) -> None:
        self._weights = (params, version)

    def on_reset(self, games: np.ndarray) -> None:
        A = len(self.players)
        for g in games:
            self._reset[int(g) * A:(int(g) + 1) * A] = True

    def step(self) -> Dict[str, np.ndarray]:
        pool = self.pool
        packed, self._carry = pool._step_fn(self._weights[0], pool._to_device(self.feat.featurize_all()),
                                            self._carry, torch.from_numpy(self._reset).to(pool.device),
                                            generator=self._generator)
        self._reset[:] = False
        actions = packed[:, :len(D.HEADS)].cpu().numpy().astype(np.int32)
        return self.feat.actions_to_sim(actions)

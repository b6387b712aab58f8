"""On-device rollout: featurize -> policy step -> sample -> sim step ->
shaped reward -> in-loop episode reset, T steps with no host round trip.

Counterpart of ``dotaclient_tpu/actor/device_rollout.py``. The chunk spans
episodes (``valid`` is all ones; ``dones`` marks the boundaries and the
learner's sequence forward resets the carry mid-chunk), so no frame is
padding. Episode stats accumulate on the device as per-game and per-lane
partials and are read only by ``drain_stats``.

In league mode (``opponent="league"``) the Dire players are opponent
lanes: their own featurizer, their own recurrent carry, and a policy step
with the frozen opponent's params (``functional_call`` on the actor's
policy), whose actions overwrite the learner side's for those players
before the sim steps. Anchor games pin their opponent side to a scripted
bot, whose control the sim applies over those actions.

Randomness comes from the actor's own ``torch.Generator`` on the device,
drawn in a fixed order each step: the five Gumbel arrays of the learner
lanes' heads, those of the opponent lanes' heads (league mode), the sim
step's wave jitter, then the reset's. ``_rollout_impl`` also takes that
noise as inputs, so a test can hand in what the JAX package drew from its
per-game keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.envs import torch_lane_sim as sim_mod
from dotaclient_tpu_torch.envs.lane_sim import TEAM_DIRE, TEAM_RADIANT
from dotaclient_tpu_torch.envs.vec_lane_sim import VecSimSpec, apply_anchor_games, draft_games
from dotaclient_tpu_torch.features.reward import fold_terms
from dotaclient_tpu_torch.features.torch_featurizer import TorchFeaturizer, shaped_reward_terms
from dotaclient_tpu_torch.models import distributions as D
from dotaclient_tpu_torch.models.policy import Policy, mask_carry
from dotaclient_tpu_torch.outcome import ingraph as outcome_ingraph
from dotaclient_tpu_torch.outcome import records as outcome_records
from dotaclient_tpu_torch.utils import telemetry


@dataclasses.dataclass
class DeviceActorState:
    """Everything the rollout loop carries across chunks, on the device."""

    sim: sim_mod.SimState
    carry: Tuple[torch.Tensor, torch.Tensor]   # learner lanes' LSTM state (c, h)
    opp_carry: Tuple[torch.Tensor, torch.Tensor]  # opponent lanes' (a 1-row dummy without them)
    ep_return: torch.Tensor                    # f32 [L] running episode return
    ep_steps: torch.Tensor                     # i32 [N] env steps into each game's episode
    # cumulative episode stats as per-game/per-lane partials; drain_stats
    # reads them and reduce_device_stats sums the game axis
    stats: Dict[str, Any]


def reduce_device_stats(stats: Mapping[str, Any]) -> Dict[str, Any]:
    """Collapse fetched per-game/per-lane stat partials (host numpy) to the
    scalar dict the host surfaces expect: counters to scalars, the per-game
    episode-length histogram [N, B] to [B]."""
    out: Dict[str, Any] = {}
    for k, v in stats.items():
        if isinstance(v, Mapping):
            out[k] = reduce_device_stats(v)
        elif k == "out_ep_len_hist":
            a = np.asarray(v)
            out[k] = a.sum(axis=0) if a.ndim == 2 else a
        else:
            out[k] = np.asarray(v).sum()
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts and tuples of one structure."""
    if isinstance(trees[0], Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def flatten_state(state: Any) -> list:
    """The tensor leaves of a ``DeviceActorState`` (dataclasses, tuples and
    dicts), in a fixed order: the checkpointed form of the actor."""
    if dataclasses.is_dataclass(state):
        return [leaf for f in dataclasses.fields(state) for leaf in flatten_state(getattr(state, f.name))]
    if isinstance(state, Mapping):
        return [leaf for k in state for leaf in flatten_state(state[k])]
    if isinstance(state, tuple):
        return [leaf for v in state for leaf in flatten_state(v)]
    return [state]


def unflatten_state(template: Any, leaves: list) -> Any:
    """``template``'s structure with ``leaves`` (``flatten_state``'s order)."""
    it = iter(leaves)

    def build(t):
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{f.name: build(getattr(t, f.name)) for f in dataclasses.fields(t)})
        if isinstance(t, Mapping):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


# the policy of one side of a rollout: a module (its own params) or a state
# dict applied to the actor's policy with ``functional_call``
PolicyParams = Union[Policy, Mapping[str, torch.Tensor]]


def build_spec(config: RunConfig) -> VecSimSpec:
    env = config.env
    return VecSimSpec(
        n_games=env.n_envs,
        team_size=env.team_size,
        max_units=config.obs.max_units,
        ticks_per_obs=env.ticks_per_observation,
        max_dota_time=env.max_dota_time,
        move_bins=config.actions.move_bins,
    )


def lane_split(config: RunConfig) -> Tuple[list, list]:
    """(learner players, opponent players) per the opponent mode."""
    env = config.env
    P = 2 * env.team_size
    if env.opponent == "selfplay":
        return list(range(P)), []
    if env.opponent == "league":
        return list(range(env.team_size)), list(range(env.team_size, P))
    return list(range(env.team_size)), []


class DeviceActor:
    """Owns the device-resident env and recurrent state; ``_rollout_impl``
    makes one chunk [L, T(+1), ...] on the device. ``stats`` and
    ``drain_stats`` are the host-visible surface."""

    def __init__(
        self,
        config: RunConfig,
        policy: Policy,
        seed: int = 0,
        registry: Optional[telemetry.Registry] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.policy = policy
        self.spec = build_spec(config)
        learner_players, opponent_players = lane_split(config)
        self.learner_players = learner_players
        self.opponent_players = opponent_players
        self.feat = TorchFeaturizer(self.spec, config.obs, config.actions, learner_players, self.device)
        self._opp_feat = (
            TorchFeaturizer(self.spec, config.obs, config.actions, opponent_players, self.device)
            if opponent_players else None
        )
        self.n_lanes = self.feat.n_lanes
        self.n_opp_lanes = max(len(opponent_players) * self.spec.n_games, 1)
        N = self.spec.n_games

        hero_ids, control = draft_games(
            N, config.env.team_size, config.env.hero_pool, config.env.opponent, seed
        )
        self.n_anchor_games = apply_anchor_games(
            control, config.env.team_size, config.env.opponent, config.league
        )
        self._scripted_possible = (
            config.env.opponent not in ("selfplay", "league") or self.n_anchor_games > 0
        )
        self._owner_team = TEAM_RADIANT if learner_players[0] < self.spec.team_size else TEAM_DIRE
        self._owner_side = "radiant" if self._owner_team == TEAM_RADIANT else "dire"
        # per-game mask of games against a snapshot (not an anchor bot)
        self._league_game_mask = torch.arange(N, device=self.device) >= self.n_anchor_games
        self._outcome_masks = outcome_ingraph.bucket_masks(
            N, config.env.opponent, self.n_anchor_games, self.device
        )
        # players whose sim actions come from the opponent lanes
        self._opp_mask = torch.zeros(self.spec.n_players, dtype=torch.bool, device=self.device)
        self._opp_mask[opponent_players] = True
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        sim0 = sim_mod.init_state(
            self.spec,
            torch.from_numpy(hero_ids).to(self.device),
            torch.from_numpy(control).to(self.device),
            generator=self.generator,
        )
        self.state = DeviceActorState(
            sim=sim0,
            carry=policy.initial_state(self.n_lanes),
            opp_carry=policy.initial_state(self.n_opp_lanes),
            ep_return=torch.zeros((self.n_lanes,), dtype=torch.float32, device=self.device),
            ep_steps=torch.zeros((N,), dtype=torch.int32, device=self.device),
            stats=self._zero_stats(),
        )
        # host-side counters, updated by the caller and from drained stats
        self.env_steps = 0
        self.rollouts_shipped = 0
        self.episodes_done = 0
        self.wins = 0
        self._reward_sum = 0.0
        self._ep_count_window = 0.0
        self._recent: Dict[str, float] = {}
        self._tel = registry if registry is not None else telemetry.get_registry()
        outcome_records.ensure_actor_metrics(self._tel)

    def reset_recurrent(self) -> None:
        """Zero every lane's recurrent carry, the learner's and the
        opponent's; the games keep their episodes."""
        self.state.carry = self.policy.initial_state(self.n_lanes)
        self.state.opp_carry = self.policy.initial_state(self.n_opp_lanes)

    def _zero_stats(self) -> Dict[str, Any]:
        """Per-game [N] counters and per-lane [L] reward sums."""
        N, L = self.spec.n_games, self.n_lanes
        zg = torch.zeros((N,), dtype=torch.float32, device=self.device)
        zl = torch.zeros((L,), dtype=torch.float32, device=self.device)
        out: Dict[str, Any] = {
            "episodes": zg, "wins": zg, "reward_sum": zl, "ep_return_sum": zg,
            "league_episodes": zg, "league_wins": zg,
        }
        out.update(outcome_ingraph.zero_outcome_stats(N, self.device))
        out["out_reward_terms"] = {term: zl for term in outcome_records.REWARD_TERMS}
        return out

    # -- the chunk generator ------------------------------------------------

    def _policy_step(self, params: PolicyParams, obs, carry):
        """``Policy.step`` of one side: a module steps with its own params,
        a state dict through ``functional_call`` on the actor's policy
        (``Policy.forward`` is ``step``)."""
        if isinstance(params, torch.nn.Module):
            return params.step(obs, carry)
        return functional_call(self.policy, params, (obs, carry))

    def _rollout_impl(
        self,
        params: PolicyParams,
        state: DeviceActorState,
        opp_params: Optional[PolicyParams] = None,
        noise: Optional[Mapping[str, torch.Tensor]] = None,
        jitter: Optional[Mapping[str, torch.Tensor]] = None,
        opp_noise: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Tuple[DeviceActorState, Dict[str, Any], Dict[str, Any]]:
        """T steps of the game from ``state``, the learner lanes under
        ``params`` and the opponent lanes (league mode, where
        ``opp_params`` is required) under ``opp_params``; each is a
        ``Policy`` or a state dict for the actor's policy. Returns (the new
        state, the chunk, this chunk's stat partials). ``noise`` and
        ``opp_noise`` (per head, [T, lanes, n]) and ``jitter`` ({"step",
        "reset"}, each [T, 2, N, C]) replace the generator's draws. Call it
        under ``torch.no_grad()``."""
        cfg, spec = self.config, self.spec
        T = cfg.ppo.rollout_len
        N, A, L = spec.n_games, len(self.learner_players), self.n_lanes
        feat, opp_feat, gen = self.feat, self._opp_feat, self.generator
        weights = cfg.reward.as_dict()
        if opp_feat is not None and opp_params is None:
            raise ValueError("opponent lanes exist (league mode): pass opp_params, e.g. from OpponentPool.sample_indexed")

        carry0 = tuple(t.to(torch.float32) for t in state.carry)
        sim, lstm, ep_ret, ep_steps = state.sim, state.carry, state.ep_return, state.ep_steps
        opp_lstm = state.opp_carry
        seq: Dict[str, list] = {k: [] for k in (
            "obs", "packed", "logp", "reward", "done_lane", "ep_done", "win", "ep_len",
            "ep_return", "rew_terms")}
        for t in range(T):
            obs = feat.featurize(sim)
            logits, _, lstm2 = self._policy_step(params, obs, lstm)
            acts, logp = D.sample(
                logits, obs, generator=gen,
                noise=None if noise is None else {h: noise[h][t] for h in D.HEADS},
            )
            packed = torch.stack([acts[h] for h in D.HEADS], dim=1).to(torch.int32)
            sim_acts = feat.actions_to_sim(packed)
            if opp_feat is not None:
                oobs = opp_feat.featurize(sim)
                ologits, _, opp_lstm2 = self._policy_step(opp_params, oobs, opp_lstm)
                oacts, _ = D.sample(
                    ologits, oobs, generator=gen,
                    noise=None if opp_noise is None else {h: opp_noise[h][t] for h in D.HEADS},
                )
                osim = opp_feat.actions_to_sim(torch.stack([oacts[h] for h in D.HEADS], dim=1))
                sim_acts = {k: torch.where(self._opp_mask[None, :], osim[k], v) for k, v in sim_acts.items()}
            sim2 = sim_mod.step(
                spec, sim, sim_acts, scripted_possible=self._scripted_possible,
                jitter=None if jitter is None else jitter["step"][t], generator=gen,
            )
            r_terms = shaped_reward_terms(spec, self.learner_players, sim, sim2, weights=weights)
            # the table-order fold: bit-identical to the reference's sum
            r = fold_terms(r_terms)
            done_g = sim2.done
            win_g = done_g & (sim2.winning_team == self._owner_team)
            ep_ret = ep_ret + r
            # this step closed the episode at length ep_steps + 1
            ep_steps2 = ep_steps + 1
            ep_len_g = torch.where(done_g, ep_steps2, 0)
            ep_steps = torch.where(done_g, 0, ep_steps2).to(torch.int32)

            sim = sim_mod.reset_where(
                spec, sim2, done_g, jitter=None if jitter is None else jitter["reset"][t], generator=gen,
            )
            done_lane = done_g[:, None].expand(N, A).reshape(L)
            lstm = mask_carry(lstm2, 1.0 - done_lane.to(torch.float32))
            if opp_feat is not None:
                n_opp = len(self.opponent_players)
                opp_done = done_g[:, None].expand(N, n_opp).reshape(N * n_opp)
                opp_lstm = mask_carry(opp_lstm2, 1.0 - opp_done.to(torch.float32))
            # completed-episode returns leave through stats (owner lane of
            # each game); the accumulator resets on done
            owner_ret = ep_ret.reshape(-1, A)[:, 0]
            for k, v in (("obs", obs), ("packed", packed), ("logp", logp), ("reward", r),
                         ("done_lane", done_lane.to(torch.float32)), ("ep_done", done_g),
                         ("win", win_g), ("ep_len", ep_len_g),
                         ("ep_return", torch.where(done_g, owner_ret, 0.0)), ("rew_terms", r_terms)):
                seq[k].append(v)
            ep_ret = torch.where(done_lane, 0.0, ep_ret)

        bootstrap = feat.featurize(sim)                              # [L, ...]
        obs_seq = {k: torch.cat([torch.stack([o[k] for o in seq["obs"]], dim=1), bootstrap[k][:, None]], dim=1)
                   for k in bootstrap}
        packed = torch.stack(seq["packed"], dim=1)                   # [L, T, 5]
        chunk = {
            "obs": obs_seq,
            "actions": {h: packed[:, :, j] for j, h in enumerate(D.HEADS)},
            "behavior_logp": torch.stack(seq["logp"], dim=1),
            "rewards": torch.stack(seq["reward"], dim=1),
            "dones": torch.stack(seq["done_lane"], dim=1),
            "valid": torch.ones((L, T), dtype=torch.float32, device=self.device),
            "carry0": carry0,
        }
        ep_done = torch.stack(seq["ep_done"])                        # [T, N]
        win = torch.stack(seq["win"])
        lg = self._league_game_mask[None, :]
        # per-game/per-lane partials: only the step axis is reduced
        stats: Dict[str, Any] = {
            "episodes": ep_done.sum(dim=0).to(torch.float32),
            "wins": win.sum(dim=0).to(torch.float32),
            "reward_sum": torch.stack(seq["reward"]).sum(dim=0),
            "ep_return_sum": torch.stack(seq["ep_return"]).sum(dim=0),
            "league_episodes": (ep_done & lg).sum(dim=0).to(torch.float32),
            "league_wins": (win & lg).sum(dim=0).to(torch.float32),
        }
        stats.update(outcome_ingraph.chunk_outcome_partials(
            ep_done, win, torch.stack(seq["ep_len"]), self._outcome_masks
        ))
        stats["out_reward_terms"] = {
            term: torch.stack([rt[term] for rt in seq["rew_terms"]]).sum(dim=0)
            for term in outcome_records.REWARD_TERMS
        }
        new_state = DeviceActorState(
            sim=sim, carry=lstm, opp_carry=opp_lstm, ep_return=ep_ret, ep_steps=ep_steps,
            stats=tree_map(torch.add, state.stats, stats),
        )
        return new_state, chunk, stats

    # -- host surface ------------------------------------------------------

    def collect(
        self, params: PolicyParams, opp_params: Optional[PolicyParams] = None
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One chunk [L, T(+1), ...] on the device under ``params``, the
        actor's state advanced: returns (chunk, this chunk's stat
        partials), with no read of the device. League mode requires
        ``opp_params`` (the frozen opponent): the live params in its place
        would silently turn the league into mirror self-play."""
        with self._tel.span("actor/collect"), torch.no_grad():
            self.state, chunk, stats = self._rollout_impl(params, self.state, opp_params)
        T = self.config.ppo.rollout_len
        self.env_steps += self.n_lanes * T
        self.rollouts_shipped += self.n_lanes
        self._tel.counter("actor/frames_shipped").inc(self.n_lanes * T)
        self._tel.counter("actor/rollouts_shipped").inc(self.n_lanes)
        return chunk, stats

    def begin_drain(self):
        """The half of :meth:`drain_stats` that reads nothing: take the
        stat accumulators (fresh tensors of the last collect, which nothing
        writes into), reset them, and return ``(device_stats, finish)``.
        ``finish(host_stats)`` folds the window into the host counters and
        returns :meth:`stats`; the caller (the snapshot engine's thread, or
        :meth:`drain_stats`) feeds it the one copy of ``device_stats``."""
        dev, self.state.stats = self.state.stats, self._zero_stats()
        return dev, self._finish_drain

    def drain_stats(self) -> Dict[str, float]:
        """Read the accumulated episode stats (the one read of the device,
        at log boundaries only), reset the accumulators, fold the window
        into the host counters and the outcome counters."""
        dev, finish = self.begin_drain()
        with self._tel.span("actor/drain"):
            host = tree_map(lambda t: t.cpu(), dev)
        return finish(host)

    def _finish_drain(self, host: Mapping[str, Any]) -> Dict[str, float]:
        s = reduce_device_stats(tree_map(lambda t: t.numpy(), host))
        self.episodes_done += int(s["episodes"])
        self.wins += int(s["wins"])
        self._reward_sum += float(s["ep_return_sum"])
        self._ep_count_window += float(s["episodes"])
        outcome_records.fold_device_stats(self._tel, s, owner_side=self._owner_side)
        # windowed since the previous drain: the responsive learning signal
        self._recent = {
            "episodes": float(s["episodes"]),
            "wins": float(s["wins"]),
            "ep_return_sum": float(s["ep_return_sum"]),
        }
        return self.stats()

    def stats(self) -> Dict[str, float]:
        # mean return over completed episodes (owner-lane convention)
        mean_ep = self._reward_sum / self._ep_count_window if self._ep_count_window else 0.0
        r_eps = self._recent.get("episodes", 0.0)
        return {
            "env_steps": float(self.env_steps),
            "rollouts_shipped": float(self.rollouts_shipped),
            "episodes_done": float(self.episodes_done),
            "episode_reward_mean": mean_ep,
            "win_rate": self.wins / self.episodes_done if self.episodes_done else 0.0,
            "episodes_recent": r_eps,
            "win_rate_recent": self._recent.get("wins", 0.0) / r_eps if r_eps else 0.0,
            "ep_reward_recent": self._recent.get("ep_return_sum", 0.0) / r_eps if r_eps else 0.0,
        }

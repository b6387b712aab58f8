"""Observations, shaped rewards and action translation over the device sim.

Counterpart of ``dotaclient_tpu/features/jax_featurizer.py``: the same
observation contract, the same static per-lane slot permutation, the same
reward terms in the same order. Lanes are game-major: lane ``g * A + a`` is
agent player ``a`` of game ``g``, ``n_lanes = N * A``.

The agent players of a featurizer are a contiguous range of player slots
(the learner's side, or every player in self-play), so their columns are
read by slicing; the slot permutation and the handles are made on the
device once, at construction, so that featurizing never copies from the
host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from dotaclient_tpu_torch.config import ActionSpec, ObsSpec
from dotaclient_tpu_torch.envs.lane_sim import (
    ACTION_ATTACK_UNIT,
    ACTION_CAST,
    ACTION_MOVE,
    ACTION_NOOP,
    NUKE_RANGE,
    TEAM_RADIANT,
    UNIT_HERO,
    UNIT_LANE_CREEP,
    UNIT_TOWER,
)
from dotaclient_tpu_torch.envs.torch_lane_sim import SimState, hero_castable
from dotaclient_tpu_torch.envs.vec_lane_sim import VecSimSpec
from dotaclient_tpu_torch.features import featurizer as F
from dotaclient_tpu_torch.features.reward import WEIGHTS as _DEFAULT_WEIGHTS
from dotaclient_tpu_torch.features.reward import fold_terms


def build_perm(spec: VecSimSpec, agent_players: Sequence[int]) -> np.ndarray:
    """Static per-lane unit ordering [A, S]: self, other heroes, creeps,
    towers."""
    S, P = spec.max_units, spec.n_players
    creeps = np.arange(spec.creep_lo, S)
    towers = np.arange(spec.tower_lo, spec.creep_lo)
    perm = np.zeros((len(agent_players), S), np.int64)
    for a, p in enumerate(agent_players):
        others = [q for q in range(P) if q != p]
        perm[a] = np.concatenate([[p], others, creeps, towers])
    return perm


def player_slice(agent_players: Sequence[int]) -> slice:
    """The agent players as a slice of the player axis; they must be a
    contiguous ascending range."""
    players = [int(p) for p in agent_players]
    if not players or players != list(range(players[0], players[0] + len(players))):
        raise ValueError(f"agent players must be a contiguous range, got {players}")
    return slice(players[0], players[0] + len(players))


class TorchFeaturizer:
    """Featurize/translate functions bound to a static lane layout on one
    device."""

    def __init__(
        self,
        spec: VecSimSpec,
        obs_spec: ObsSpec,
        action_spec: ActionSpec,
        agent_players: Sequence[int],
        device: torch.device,
    ) -> None:
        if obs_spec.max_units != spec.max_units:
            raise ValueError("ObsSpec.max_units must equal sim slot count")
        if action_spec.max_units != spec.max_units:
            raise ValueError("ActionSpec.max_units must equal sim slot count")
        self.spec = spec
        self.obs_spec = obs_spec
        self.action_spec = action_spec
        self.agent_players = tuple(int(p) for p in agent_players)
        self._ap = player_slice(self.agent_players)
        self.perm = build_perm(spec, agent_players)                  # np [A, S]
        A, S = self.perm.shape
        self.n_lanes = spec.n_games * A
        self._perm = torch.from_numpy(self.perm).to(device)
        self._perm_games = self._perm[None].expand(spec.n_games, A, S)
        self._handles = (
            torch.from_numpy(self.perm + 1).to(torch.int32).to(device)[None]
            .expand(spec.n_games, A, S).reshape(self.n_lanes, S)
        )
        self._mirror = torch.tensor(
            [p >= spec.team_size for p in self.agent_players], device=device
        )[None, :]

    # -- observations ------------------------------------------------------

    def featurize(self, state: SimState) -> Dict[str, torch.Tensor]:
        """All lanes' observations: tensors with leading axis L = N * A."""
        spec = self.spec
        N, P = spec.n_games, spec.n_players
        A = len(self.agent_players)
        ap = self._ap
        perm = self._perm

        def g(arr):
            return arr[:, perm]                                        # [N, A, S]

        unit_type = g(state.unit_type)
        team = g(state.team)
        alive = g(state.alive)
        x, y = g(state.x), g(state.y)
        health, health_max = g(state.health), g(state.health_max)
        mana, mana_max = g(state.mana), g(state.mana_max)
        castable = g(hero_castable(state))

        my_team = state.team[:, ap][:, :, None]
        # team-canonical frame: +x points at the enemy tower for both
        # sides; actions_to_sim mirrors back
        sign = torch.where(my_team == TEAM_RADIANT, 1.0, -1.0)
        me_x = state.x[:, ap][:, :, None]
        me_y = state.y[:, ap][:, :, None]
        me_alive = state.alive[:, ap]

        present = (unit_type != 0) & (alive | (unit_type == UNIT_HERO))
        is_hero = unit_type == UNIT_HERO
        is_creep = unit_type == UNIT_LANE_CREEP
        is_tower = unit_type == UNIT_TOWER
        is_ally = (team == my_team) & present
        is_self = torch.zeros_like(present)
        is_self[:, :, 0] = present[:, :, 0]
        dx = (x - me_x) * sign / F._POS_SCALE
        dy = (y - me_y) / F._POS_SCALE
        dist = torch.hypot(x - me_x, y - me_y)
        deniable = is_ally & ~is_self & is_creep & (health < 0.5 * health_max)

        cols = (
            is_hero, is_creep, is_tower, is_ally, present & ~is_ally, is_self,
            x * sign / F._POS_SCALE, y / F._POS_SCALE, dx, dy, dist / F._POS_SCALE,
            health / torch.clamp(health_max, min=1.0), health_max / F._HP_SCALE,
            mana / torch.clamp(mana_max, min=1.0),
            g(state.damage) / F._DMG_SCALE,
            g(state.attack_range) / F._RANGE_SCALE,
            g(state.move_speed) / F._SPEED_SCALE,
            g(state.armor) / F._ARMOR_SCALE,
            g(state.level) / F._LEVEL_SCALE, alive, castable, deniable,
        )
        f = torch.stack([c.to(torch.float32) for c in cols], dim=-1)
        f = f * present[..., None]

        self_castable = castable[:, :, 0]
        cast_range = torch.where(self_castable, NUKE_RANGE, 0.0)[:, :, None]
        is_enemy = present & (team != my_team)
        attackable = present & alive & (is_enemy | deniable) & ~is_self & me_alive[:, :, None]
        cast_tgt = is_enemy & alive & (dist <= cast_range) & me_alive[:, :, None]

        mask_action = torch.zeros((N, A, self.action_spec.n_action_types), dtype=torch.bool,
                                  device=present.device)
        mask_action[..., ACTION_NOOP] = True
        mask_action[..., ACTION_MOVE] = me_alive
        mask_action[..., ACTION_ATTACK_UNIT] = attackable.any(dim=-1)
        mask_action[..., ACTION_CAST] = self_castable & cast_tgt.any(dim=-1)
        mask_ability = torch.zeros((N, A, self.action_spec.max_abilities), dtype=torch.bool,
                                   device=present.device)
        mask_ability[..., 0] = mask_action[..., ACTION_CAST]

        tower_r, tower_d = spec.tower_lo, spec.tower_lo + 1
        tower_hp = torch.stack(
            [
                state.health[:, tower_r] / torch.clamp(state.health_max[:, tower_r], min=1.0),
                state.health[:, tower_d] / torch.clamp(state.health_max[:, tower_d], min=1.0),
            ],
            dim=1,
        )
        team_row = state.team[:, :P]
        kills_rad = (state.kills[:, :P] * (team_row == TEAM_RADIANT)).sum(dim=1)
        kills_dire = (state.kills[:, :P] * (team_row != TEAM_RADIANT)).sum(dim=1)
        i_rad = my_team[:, :, 0] == TEAM_RADIANT
        kill_diff = torch.where(
            i_rad, (kills_rad - kills_dire)[:, None], (kills_dire - kills_rad)[:, None]
        ).to(torch.float32)
        own_tower = torch.where(i_rad, tower_hp[:, 0:1], tower_hp[:, 1:2])
        enemy_tower = torch.where(i_rad, tower_hp[:, 1:2], tower_hp[:, 0:1])

        gl = torch.stack(
            [
                (state.dota_time / F._TIME_SCALE)[:, None].expand(N, A),
                torch.where(i_rad, 1.0, -1.0),
                state.gold[:, ap] / F._GOLD_SCALE,
                state.xp[:, ap] / F._XP_SCALE,
                state.level[:, ap] / F._LEVEL_SCALE,
                kill_diff / 10.0,
                own_tower,
                enemy_tower,
            ],
            dim=-1,
        ).to(torch.float32)
        pad = self.obs_spec.global_features - gl.shape[-1]
        if pad:
            gl = torch.cat([gl, gl.new_zeros((N, A, pad))], dim=-1)

        L = N * A

        def flat(arr):
            return arr.reshape((L,) + arr.shape[2:])

        return {
            "units": flat(f),
            "unit_mask": flat(present),
            "unit_handles": self._handles,
            "globals": flat(gl),
            "hero_id": state.hero_ids[:, ap].reshape(-1).to(torch.int32),
            "mask_action_type": flat(mask_action),
            "mask_target_unit": flat(attackable),
            "mask_cast_target": flat(cast_tgt),
            "mask_ability": flat(mask_ability),
        }

    # -- action translation ------------------------------------------------

    def actions_to_sim(self, packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Policy head indices [L, 5] -> sim action tensors [N, P]; players
        that are not agents get type -1 (scripted players are overridden
        in the sim)."""
        spec = self.spec
        N, P, S = spec.n_games, spec.n_players, spec.max_units
        A = len(self.agent_players)
        packed = packed.reshape(N, A, 5).to(torch.int32)
        ap = self._ap

        obs_slot = torch.clamp(packed[..., 3], 0, S - 1)
        sim_slot = self._perm_games.gather(2, obs_slot[..., None].long())[..., 0].to(torch.int32)

        def scatter(col, fill):
            out = torch.full((N, P), fill, dtype=torch.int32, device=packed.device)
            out[:, ap] = col
            return out

        # canonical -> world: Dire lanes mirror the move-x bin back
        mx = torch.where(self._mirror, self.action_spec.move_bins - 1 - packed[..., 1], packed[..., 1])
        return {
            "type": scatter(packed[..., 0], -1),
            "move_x": scatter(mx, 0),
            "move_y": scatter(packed[..., 2], 0),
            "target_slot": scatter(sim_slot, 0),
            "ability": scatter(packed[..., 4], 0),
        }


def shaped_reward_terms(
    spec: VecSimSpec,
    agent_players: Sequence[int],
    prev: SimState,
    cur: SimState,
    weights=None,
) -> Dict[str, torch.Tensor]:
    """Weighted per-term shaped reward, each term a per-lane [L] f32 tensor,
    in the table order that ``fold_terms`` sums (``weights`` overrides the
    default table)."""
    W = _DEFAULT_WEIGHTS if weights is None else weights
    P = spec.n_players
    ap = player_slice(agent_players)

    def hero_hp_frac(s: SimState) -> torch.Tensor:
        return torch.where(
            s.alive[:, :P], s.health[:, :P] / torch.clamp(s.health_max[:, :P], min=1.0), 0.0
        )

    def tower_frac(s: SimState) -> torch.Tensor:
        tr, td = spec.tower_lo, spec.tower_lo + 1
        frac = torch.stack(
            [
                s.health[:, tr] / torch.clamp(s.health_max[:, tr], min=1.0),
                s.health[:, td] / torch.clamp(s.health_max[:, td], min=1.0),
            ],
            dim=1,
        )
        alive = torch.stack([s.alive[:, tr], s.alive[:, td]], dim=1)
        return torch.where(alive, frac, 0.0)

    rad_mask = cur.team[:, :P] == TEAM_RADIANT

    def team_mean_hp(s: SimState):
        hp = hero_hp_frac(s)
        cnt_r = torch.clamp(rad_mask.sum(dim=1), min=1)
        cnt_d = torch.clamp((~rad_mask).sum(dim=1), min=1)
        return (hp * rad_mask).sum(dim=1) / cnt_r, (hp * ~rad_mask).sum(dim=1) / cnt_d

    mean_r0, mean_d0 = team_mean_hp(prev)
    mean_r1, mean_d1 = team_mean_hp(cur)
    tower0, tower1 = tower_frac(prev), tower_frac(cur)

    my_team = cur.team[:, ap]
    i_rad = my_team == TEAM_RADIANT
    e_hp0 = torch.where(i_rad, mean_d0[:, None], mean_r0[:, None])
    e_hp1 = torch.where(i_rad, mean_d1[:, None], mean_r1[:, None])
    e_tw0 = torch.where(i_rad, tower0[:, 1:2], tower0[:, 0:1])
    e_tw1 = torch.where(i_rad, tower1[:, 1:2], tower1[:, 0:1])
    o_tw0 = torch.where(i_rad, tower0[:, 0:1], tower0[:, 1:2])
    o_tw1 = torch.where(i_rad, tower1[:, 0:1], tower1[:, 1:2])

    def d(field):
        return getattr(cur, field)[:, ap] - getattr(prev, field)[:, ap]

    hp0 = hero_hp_frac(prev)[:, ap]
    hp1 = hero_hp_frac(cur)[:, ap]

    just_ended = cur.done & ~prev.done & (cur.winning_team != 0)
    win_sign = torch.where(cur.winning_team[:, None] == my_team, 1.0, -1.0)
    terms = {
        "xp": W["xp"] * d("xp"),
        "gold": W["gold"] * d("gold"),
        "hp": W["hp"] * (hp1 - hp0),
        "enemy_hp": W["enemy_hp"] * -(e_hp1 - e_hp0),
        "last_hits": W["last_hits"] * d("last_hits"),
        "denies": W["denies"] * d("denies"),
        "kills": W["kills"] * d("kills"),
        "deaths": W["deaths"] * d("deaths"),
        "tower_damage": W["tower_damage"] * (e_tw0 - e_tw1),
        "own_tower": W["own_tower"] * (o_tw1 - o_tw0),
        "win": W["win"] * win_sign * just_ended[:, None],
    }
    return {term: arr.reshape(-1).to(torch.float32) for term, arr in terms.items()}


def shaped_rewards(
    spec: VecSimSpec,
    agent_players: Sequence[int],
    prev: SimState,
    cur: SimState,
    weights=None,
) -> torch.Tensor:
    """Per-lane shaped reward [L]: ``fold_terms`` of the terms."""
    return fold_terms(shaped_reward_terms(spec, agent_players, prev, cur, weights))

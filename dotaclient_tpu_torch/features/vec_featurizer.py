"""Batched featurizer and shaped reward over the numpy simulator's arrays.

A copy of ``dotaclient_tpu/features/vec_featurizer.py``, numpy only:
``VecFeaturizer`` produces the observation contract (feature columns, masks,
slot 0 is self) for every lane of a ``VecLaneSim`` in one call, reading the
scales of ``features/featurizer.py``; ``VecRewards`` is the shaped reward
from sim-state deltas with ``features/reward.py``'s ``WEIGHTS``, folded by
``fold_terms``. Every operation is the reference's, so the same state gives
the same arrays bit for bit.

Per-lane unit order is [self, other heroes (by player slot), creep slots,
towers], a static permutation of the sim's slots computed once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from dotaclient_tpu_torch.config import ActionSpec, ObsSpec
from dotaclient_tpu_torch.envs.lane_sim import (
    ACTION_ATTACK_UNIT,
    ACTION_CAST,
    ACTION_MOVE,
    ACTION_NOOP,
    NUKE_RANGE,
    TEAM_DIRE,
    TEAM_RADIANT,
    UNIT_HERO,
    UNIT_LANE_CREEP,
    UNIT_TOWER,
)
from dotaclient_tpu_torch.envs.vec_lane_sim import VecLaneSim
from dotaclient_tpu_torch.features import featurizer as F
from dotaclient_tpu_torch.features.reward import WEIGHTS, fold_terms


class VecFeaturizer:
    """Featurizes ``agent_players`` lanes of every game in one call.

    Output arrays are flattened over lanes: leading axis ``L = n_games ×
    len(agent_players)``, lane ``l = game * A + a``.
    """

    def __init__(
        self,
        sim: VecLaneSim,
        obs_spec: ObsSpec,
        action_spec: ActionSpec,
        agent_players: Sequence[int],
    ) -> None:
        spec = sim.spec
        S, P = spec.max_units, spec.n_players
        if obs_spec.max_units != S:
            raise ValueError(
                f"ObsSpec.max_units ({obs_spec.max_units}) must equal the sim "
                f"slot count ({S}) for the vectorized path"
            )
        if action_spec.max_units != S:
            raise ValueError("ActionSpec.max_units must equal sim slot count")
        self.sim = sim
        self.obs_spec = obs_spec
        self.action_spec = action_spec
        self.agent_players = np.asarray(agent_players, np.int64)
        A = len(self.agent_players)

        # perm[a] = unit ordering for agent a: self, other heroes, creeps,
        # towers (static — computed once).
        perm = np.zeros((A, S), np.int64)
        creeps = np.arange(spec.creep_lo, S)
        towers = np.arange(spec.tower_lo, spec.creep_lo)
        for a, p in enumerate(self.agent_players):
            others = [q for q in range(P) if q != p]
            perm[a] = np.concatenate([[p], others, creeps, towers])
        self.perm = perm                                   # [A, S]
        self.n_lanes = sim.n_games * A

    # -- observations ------------------------------------------------------

    def featurize_all(self) -> Dict[str, np.ndarray]:
        """All lanes' observations: dict of arrays with leading axis L."""
        sim, spec = self.sim, self.sim.spec
        N, S, P = spec.n_games, spec.max_units, spec.n_players
        A = len(self.agent_players)
        ap = self.agent_players
        perm = self.perm                                    # [A, S]

        def g(arr: np.ndarray) -> np.ndarray:
            """Gather [N, S] → [N, A, S] in per-lane unit order."""
            return arr[:, perm]

        unit_type = g(sim.unit_type)
        team = g(sim.team)
        alive = g(sim.alive)
        x, y = g(sim.x), g(sim.y)
        health, health_max = g(sim.health), g(sim.health_max)
        mana, mana_max = g(sim.mana), g(sim.mana_max)
        castable = g(sim.hero_castable())

        my_team = sim.team[:, ap][:, :, None]               # [N, A, 1]
        sign = np.where(sim.team[:, ap] == 2, 1.0, -1.0)[:, :, None]
        me_x = sim.x[:, ap][:, :, None]
        me_y = sim.y[:, ap][:, :, None]
        me_alive = sim.alive[:, ap]                         # [N, A]

        present = (unit_type != 0) & (alive | (unit_type == UNIT_HERO))
        is_hero = unit_type == UNIT_HERO
        is_creep = unit_type == UNIT_LANE_CREEP
        is_tower = unit_type == UNIT_TOWER
        is_ally = (team == my_team) & present
        is_self = np.zeros((N, A, S), bool)
        is_self[:, :, 0] = present[:, :, 0]
        dx = (x - me_x) * sign / F._POS_SCALE
        dy = (y - me_y) / F._POS_SCALE
        dist = np.hypot(x - me_x, y - me_y)
        deniable = is_ally & ~is_self & is_creep & (health < 0.5 * health_max)

        f = np.zeros((N, A, S, self.obs_spec.unit_features), np.float32)
        cols = (
            is_hero, is_creep, is_tower, is_ally, present & ~is_ally, is_self,
            x * sign / F._POS_SCALE, y / F._POS_SCALE, dx, dy, dist / F._POS_SCALE,
            health / np.maximum(health_max, 1.0), health_max / F._HP_SCALE,
            mana / np.maximum(mana_max, 1.0),
            g(sim.damage) / F._DMG_SCALE, g(sim.attack_range) / F._RANGE_SCALE,
            g(sim.move_speed) / F._SPEED_SCALE, g(sim.armor) / F._ARMOR_SCALE,
            g(sim.level) / F._LEVEL_SCALE, alive, castable, deniable,
        )
        for i, c in enumerate(cols):
            f[..., i] = c
        f *= present[..., None]

        # target masks (scalar-featurizer rules)
        self_castable = castable[:, :, 0]                   # [N, A]
        cast_range = np.where(self_castable, NUKE_RANGE, 0.0)[:, :, None]
        is_enemy = present & (team != my_team)
        attackable = (
            present & alive & (is_enemy | deniable) & ~is_self
            & me_alive[:, :, None]
        )
        cast_tgt = (
            is_enemy & alive & (dist <= cast_range) & me_alive[:, :, None]
        )

        mask_action = np.zeros((N, A, self.action_spec.n_action_types), bool)
        mask_action[..., ACTION_NOOP] = True
        mask_action[..., ACTION_MOVE] = me_alive
        mask_action[..., ACTION_ATTACK_UNIT] = attackable.any(-1)
        mask_action[..., ACTION_CAST] = self_castable & cast_tgt.any(-1)
        mask_ability = np.zeros((N, A, self.action_spec.max_abilities), bool)
        mask_ability[..., 0] = mask_action[..., ACTION_CAST]

        # globals
        tower_r = sim.tower_slot(TEAM_RADIANT)
        tower_d = sim.tower_slot(TEAM_DIRE)
        tower_hp = np.stack(
            [
                sim.health[:, tower_r] / np.maximum(sim.health_max[:, tower_r], 1.0),
                sim.health[:, tower_d] / np.maximum(sim.health_max[:, tower_d], 1.0),
            ],
            axis=1,
        )                                                   # [N, 2] (rad, dire)
        team_row = sim.team[:, :P]
        kills_rad = (sim.kills[:, :P] * (team_row == TEAM_RADIANT)).sum(1)
        kills_dire = (sim.kills[:, :P] * (team_row == TEAM_DIRE)).sum(1)
        i_rad = (my_team[:, :, 0] == TEAM_RADIANT)          # [N, A]
        kill_diff = np.where(
            i_rad, kills_rad[:, None] - kills_dire[:, None],
            kills_dire[:, None] - kills_rad[:, None],
        )
        own_tower = np.where(i_rad, tower_hp[:, 0:1], tower_hp[:, 1:2])
        enemy_tower = np.where(i_rad, tower_hp[:, 1:2], tower_hp[:, 0:1])

        gl = np.zeros((N, A, self.obs_spec.global_features), np.float32)
        gl[..., 0] = sim.dota_time[:, None] / F._TIME_SCALE
        gl[..., 1] = np.where(i_rad, 1.0, -1.0)
        gl[..., 2] = sim.gold[:, ap] / F._GOLD_SCALE
        gl[..., 3] = sim.xp[:, ap] / F._XP_SCALE
        gl[..., 4] = sim.level[:, ap] / F._LEVEL_SCALE
        gl[..., 5] = kill_diff / 10.0
        gl[..., 6] = own_tower
        gl[..., 7] = enemy_tower

        L = N * A
        def flat(arr: np.ndarray) -> np.ndarray:
            return arr.reshape((L,) + arr.shape[2:])

        return {
            "units": flat(f),
            "unit_mask": flat(present),
            "unit_handles": flat(
                np.broadcast_to((perm + 1).astype(np.int32)[None], (N, A, S)).copy()
            ),
            "globals": flat(gl),
            "hero_id": sim.hero_ids[:, ap].reshape(-1).astype(np.int32),
            "mask_action_type": flat(mask_action),
            "mask_target_unit": flat(attackable),
            "mask_cast_target": flat(cast_tgt),
            "mask_ability": flat(mask_ability),
        }

    # -- action translation ------------------------------------------------

    def actions_to_sim(self, packed: np.ndarray) -> Dict[str, np.ndarray]:
        """Policy head indices [L, 5] (HEADS order: action_type, move_x,
        move_y, target_unit, ability) → sim action arrays [N, P].

        Obs target slots map back to sim slots through the static ``perm``;
        players not in ``agent_players`` get type=-1 (scripted/no-op).
        """
        sim, spec = self.sim, self.sim.spec
        N, P = spec.n_games, spec.n_players
        A = len(self.agent_players)
        packed = packed.reshape(N, A, 5)

        out = {
            "type": np.full((N, P), -1, np.int32),
            "move_x": np.zeros((N, P), np.int32),
            "move_y": np.zeros((N, P), np.int32),
            "target_slot": np.zeros((N, P), np.int64),
            "ability": np.zeros((N, P), np.int32),
        }
        ap = self.agent_players
        out["type"][:, ap] = packed[..., 0]
        # canonical → world frame: Dire lanes mirror the move-x bin (the
        # featurizer mirrored their observations; see featurize)
        mirror = sim.team[:, ap] != 2
        mx = packed[..., 1]
        out["move_x"][:, ap] = np.where(
            mirror, self.action_spec.move_bins - 1 - mx, mx
        )
        out["move_y"][:, ap] = packed[..., 2]
        # obs slot → sim slot
        obs_slot = np.clip(packed[..., 3], 0, spec.max_units - 1)
        sim_slot = np.take_along_axis(
            np.broadcast_to(self.perm[None], (N, A, spec.max_units)),
            obs_slot[..., None],
            axis=2,
        )[..., 0]
        out["target_slot"][:, ap] = sim_slot
        out["ability"][:, ap] = packed[..., 4]
        return out


class VecRewards:
    """Shaped reward for every lane from sim-state deltas — the vector form
    of ``features.reward.shaped_reward`` (same WEIGHTS, same components)."""

    def __init__(
        self,
        sim: VecLaneSim,
        agent_players: Sequence[int],
        weights: Optional[Dict[str, float]] = None,
    ) -> None:
        self.sim = sim
        self.agent_players = np.asarray(agent_players, np.int64)
        self.weights = dict(WEIGHTS if weights is None else weights)
        # last compute()'s weighted per-term sums (outcome decomposition)
        self.last_term_sums: Dict[str, float] = {
            t: 0.0 for t in self.weights
        }
        self.snapshot()

    def _state(self) -> Dict[str, np.ndarray]:
        sim = self.sim
        P = sim.spec.n_players
        ap = self.agent_players
        hero_hp_frac = np.where(
            sim.alive[:, :P],
            sim.health[:, :P] / np.maximum(sim.health_max[:, :P], 1.0),
            0.0,
        )                                                   # [N, P]
        tower_frac = np.stack(
            [
                sim.health[:, sim.tower_slot(TEAM_RADIANT)]
                / np.maximum(sim.health_max[:, sim.tower_slot(TEAM_RADIANT)], 1.0),
                sim.health[:, sim.tower_slot(TEAM_DIRE)]
                / np.maximum(sim.health_max[:, sim.tower_slot(TEAM_DIRE)], 1.0),
            ],
            axis=1,
        )
        # destroyed towers leave the scalar worldstate → scalar reward reads
        # them as 0; alive-masking matches that.
        tower_alive = np.stack(
            [
                sim.alive[:, sim.tower_slot(TEAM_RADIANT)],
                sim.alive[:, sim.tower_slot(TEAM_DIRE)],
            ],
            axis=1,
        )
        tower_frac = np.where(tower_alive, tower_frac, 0.0)
        team_row = sim.team[:, :P]
        # mean enemy-hero hp fraction per team viewpoint
        rad_mask = team_row == TEAM_RADIANT
        def mean_where(mask: np.ndarray) -> np.ndarray:
            cnt = np.maximum(mask.sum(1), 1)
            return (hero_hp_frac * mask).sum(1) / cnt
        mean_rad = mean_where(rad_mask)                     # mean hp of radiant heroes
        mean_dire = mean_where(~rad_mask)
        return {
            "gold": sim.gold[:, ap].copy(),
            "xp": sim.xp[:, ap].copy(),
            "hp": hero_hp_frac[:, ap].copy(),
            "last_hits": sim.last_hits[:, ap].copy(),
            "denies": sim.denies[:, ap].copy(),
            "kills": sim.kills[:, ap].copy(),
            "deaths": sim.deaths[:, ap].copy(),
            "tower": tower_frac,                            # [N, 2] rad, dire
            "mean_hp_rad": mean_rad,
            "mean_hp_dire": mean_dire,
            "done": sim.done.copy(),
        }

    def snapshot(self) -> None:
        self._prev = self._state()

    def compute(self) -> np.ndarray:
        """Per-lane shaped reward [L] for the interval since ``snapshot``;
        re-snapshots afterwards."""
        sim = self.sim
        cur = self._state()
        prev = self._prev
        ap = self.agent_players
        my_team = sim.team[:, ap]                           # [N, A]
        i_rad = my_team == TEAM_RADIANT

        enemy_hp_prev = np.where(i_rad, prev["mean_hp_dire"][:, None], prev["mean_hp_rad"][:, None])
        enemy_hp_cur = np.where(i_rad, cur["mean_hp_dire"][:, None], cur["mean_hp_rad"][:, None])
        enemy_tower_prev = np.where(i_rad, prev["tower"][:, 1:2], prev["tower"][:, 0:1])
        enemy_tower_cur = np.where(i_rad, cur["tower"][:, 1:2], cur["tower"][:, 0:1])
        own_tower_prev = np.where(i_rad, prev["tower"][:, 0:1], prev["tower"][:, 1:2])
        own_tower_cur = np.where(i_rad, cur["tower"][:, 0:1], cur["tower"][:, 1:2])

        WEIGHTS = self.weights
        # only the step the game ends pays the win term (done stays True
        # until the runtime resets the game)
        just_ended = sim.done & ~prev["done"] & (sim.winning_team != 0)
        win_sign = np.where(
            sim.winning_team[:, None] == my_team, 1.0, -1.0
        )
        # weighted per-term breakdown, summed in the historical term
        # order; the per-term sums feed the outcome plane's reward
        # decomposition (outcome/reward_sum/<term>)
        weighted = {
            "xp": WEIGHTS["xp"] * (cur["xp"] - prev["xp"]),
            "gold": WEIGHTS["gold"] * (cur["gold"] - prev["gold"]),
            "hp": WEIGHTS["hp"] * (cur["hp"] - prev["hp"]),
            "enemy_hp": WEIGHTS["enemy_hp"] * -(enemy_hp_cur - enemy_hp_prev),
            "last_hits": WEIGHTS["last_hits"]
            * (cur["last_hits"] - prev["last_hits"]),
            "denies": WEIGHTS["denies"] * (cur["denies"] - prev["denies"]),
            "kills": WEIGHTS["kills"] * (cur["kills"] - prev["kills"]),
            "deaths": WEIGHTS["deaths"] * (cur["deaths"] - prev["deaths"]),
            "tower_damage": WEIGHTS["tower_damage"]
            * (enemy_tower_prev - enemy_tower_cur),
            "own_tower": WEIGHTS["own_tower"]
            * (own_tower_cur - own_tower_prev),
            "win": WEIGHTS["win"] * win_sign * just_ended[:, None],
        }
        r = fold_terms(weighted)
        self.last_term_sums = {
            term: float(arr.sum()) for term, arr in weighted.items()
        }
        self._prev = cur
        return r.reshape(-1).astype(np.float32)

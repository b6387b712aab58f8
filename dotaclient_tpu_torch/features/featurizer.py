"""WorldState proto -> fixed-shape arrays; action indices -> Action proto.

Counterpart of ``dotaclient_tpu/features/featurizer.py``. ``featurize`` is a
pure map from one player's view of a ``WorldState`` to an ``Observation`` of
static shapes (``ObsSpec.max_units`` unit slots, validity in masks, never in
shapes). Unit slot 0 is the controlled hero; the other units follow heroes
first, in (unit type, handle) order. The frame is team-canonical: +x points
at the enemy tower, and ``decode_action`` mirrors ``move_x`` back for Dire.
The normalisation scales below are also read by the device featurizer
(``features/torch_featurizer.py``) and the numpy one
(``features/vec_featurizer.py``). On the same world state the arrays equal
the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np

from dotaclient_tpu_torch.config import ActionSpec, ObsSpec
from dotaclient_tpu_torch.protos import dota_pb2 as pb

# Normalisation scales. The lane is +-2000 units long; times are in seconds.
_POS_SCALE = 2000.0
_TIME_SCALE = 600.0
_HP_SCALE = 2000.0
_GOLD_SCALE = 3000.0
_XP_SCALE = 2500.0
_DMG_SCALE = 150.0
_RANGE_SCALE = 700.0
_SPEED_SCALE = 400.0
_ARMOR_SCALE = 20.0
_LEVEL_SCALE = 10.0

# Feature column meanings for the per-unit vector (ObsSpec.unit_features == 22).
UNIT_FEATURES = (
    "is_hero", "is_creep", "is_tower", "is_ally", "is_enemy", "is_self",
    "x", "y", "dx_self", "dy_self", "dist_self",
    "health_frac", "health_max", "mana_frac",
    "attack_damage", "attack_range", "move_speed", "armor", "level",
    "is_alive", "ability_castable", "deniable",
)

GLOBAL_FEATURES = (
    "dota_time", "team_sign", "gold", "xp", "level",
    "kill_diff", "own_tower_hp", "enemy_tower_hp",
)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One featurized worldstate from a single player's perspective.

    All arrays have static shapes drawn from (ObsSpec, ActionSpec); batching
    is a plain ``np.stack`` over instances.
    """

    units: np.ndarray          # f32 [max_units, unit_features]
    unit_mask: np.ndarray      # bool [max_units] — slot holds a live unit
    unit_handles: np.ndarray   # i32 [max_units] — proto handle per slot (0=pad)
    globals: np.ndarray        # f32 [global_features]
    hero_id: np.ndarray        # i32 [] — controlled hero id (hero embedding)
    # Per-head legality masks (True == legal). Illegal actions must never be
    # sampled; the policy applies these before softmax. The target head has
    # two masks because legality is conditional on the action type: ATTACK may
    # hit any enemy or a deniable allied creep; CAST only enemies inside the
    # nuke's range.
    mask_action_type: np.ndarray   # bool [n_action_types]
    mask_target_unit: np.ndarray   # bool [max_units] — ATTACK targets
    mask_cast_target: np.ndarray   # bool [max_units] — CAST targets
    mask_ability: np.ndarray       # bool [max_abilities]


def _unit_sort_key(unit: pb.Unit) -> tuple:
    # Heroes first, then creeps, towers, buildings; stable by handle.
    order = {
        pb.UNIT_HERO: 0,
        pb.UNIT_LANE_CREEP: 1,
        pb.UNIT_TOWER: 2,
        pb.UNIT_BUILDING: 3,
    }
    return (order.get(unit.unit_type, 9), unit.handle)


def featurize(
    world_state: pb.WorldState,
    player_id: int,
    obs_spec: ObsSpec,
    action_spec: ActionSpec,
) -> Observation:
    """Featurize ``world_state`` from ``player_id``'s perspective."""
    U, F = obs_spec.max_units, obs_spec.unit_features
    if action_spec.max_units != U:
        raise ValueError(
            "ActionSpec.max_units must equal ObsSpec.max_units (the target "
            f"head indexes unit slots): {action_spec.max_units} != {U}"
        )
    units_arr = np.zeros((U, F), dtype=np.float32)
    unit_mask = np.zeros((U,), dtype=bool)
    unit_handles = np.zeros((U,), dtype=np.int32)
    mask_target = np.zeros((U,), dtype=bool)
    mask_cast = np.zeros((U,), dtype=bool)
    mask_ability = np.zeros((action_spec.max_abilities,), dtype=bool)

    me: Optional[pb.Unit] = None
    for unit in world_state.units:
        if unit.unit_type == pb.UNIT_HERO and unit.player_id == player_id:
            me = unit
            break

    my_team = me.team_id if me is not None else world_state.team_id
    mx = me.location.x if me is not None else 0.0
    my_ = me.location.y if me is not None else 0.0
    me_alive = bool(me is not None and me.is_alive)
    # Team-canonical frame: +x always points at the ENEMY tower (the map is
    # symmetric about x=0, towers at ±LANE_HALF_LENGTH). Without this a
    # policy is side-specific — trained as Radiant it cannot be executed on
    # Dire lanes (league opponents, eval mirrors), which shows up as wild
    # side asymmetries in self-play. decode_action mirrors move_x back.
    sign = 1.0 if my_team == 2 else -1.0

    others = sorted(
        (u for u in world_state.units if me is None or u.handle != me.handle),
        key=_unit_sort_key,
    )
    ordered = ([me] if me is not None else []) + others

    # Cast range comes from the worldstate itself (Ability.cast_range of the
    # controlled hero's castable ability), not from baked game knowledge.
    cast_range = 0.0
    if me is not None:
        for a in me.abilities:
            if a.castable and a.cast_range > 0.0:
                cast_range = max(cast_range, a.cast_range)
    any_attackable = False
    any_nukable = False
    self_castable = False

    for slot, unit in enumerate(ordered[:U]):
        is_self = me is not None and unit.handle == me.handle
        is_ally = unit.team_id == my_team
        dx = (unit.location.x - mx) * sign / _POS_SCALE
        dy = (unit.location.y - my_) / _POS_SCALE
        dist = float(np.hypot(unit.location.x - mx, unit.location.y - my_))
        castable = any(a.castable for a in unit.abilities)
        deniable = (
            is_ally
            and not is_self
            and unit.unit_type == pb.UNIT_LANE_CREEP
            and unit.health < 0.5 * unit.health_max
        )
        units_arr[slot] = (
            float(unit.unit_type == pb.UNIT_HERO),
            float(unit.unit_type == pb.UNIT_LANE_CREEP),
            float(unit.unit_type == pb.UNIT_TOWER),
            float(is_ally),
            float(not is_ally),
            float(is_self),
            unit.location.x * sign / _POS_SCALE,
            unit.location.y / _POS_SCALE,
            dx,
            dy,
            dist / _POS_SCALE,
            unit.health / max(unit.health_max, 1.0),
            unit.health_max / _HP_SCALE,
            unit.mana / max(unit.mana_max, 1.0),
            unit.attack_damage / _DMG_SCALE,
            unit.attack_range / _RANGE_SCALE,
            unit.movement_speed / _SPEED_SCALE,
            unit.armor / _ARMOR_SCALE,
            unit.level / _LEVEL_SCALE,
            float(unit.is_alive),
            float(castable),
            float(deniable),
        )
        unit_mask[slot] = True
        unit_handles[slot] = unit.handle
        if is_self:
            self_castable = castable
            continue
        if not unit.is_alive:
            continue
        attack_ok = (not is_ally) or deniable
        if me_alive and attack_ok:
            mask_target[slot] = True
            any_attackable = True
        if me_alive and not is_ally and cast_range > 0.0 and dist <= cast_range:
            mask_cast[slot] = True
            any_nukable = True

    # Global features from the self player's scoreboard entry.
    my_player: Optional[pb.Player] = None
    kill_diff = 0.0
    for p in world_state.players:
        if p.player_id == player_id:
            my_player = p
    if my_player is not None:
        my_kills = sum(
            p.kills for p in world_state.players if p.team_id == my_team
        )
        enemy_kills = sum(
            p.kills for p in world_state.players if p.team_id != my_team
        )
        kill_diff = float(my_kills - enemy_kills)

    own_tower_hp, enemy_tower_hp = 0.0, 0.0
    for unit in world_state.units:
        if unit.unit_type == pb.UNIT_TOWER:
            frac = unit.health / max(unit.health_max, 1.0)
            if unit.team_id == my_team:
                own_tower_hp = frac
            else:
                enemy_tower_hp = frac

    globals_arr = np.zeros((obs_spec.global_features,), dtype=np.float32)
    globals_arr[: len(GLOBAL_FEATURES)] = (
        world_state.dota_time / _TIME_SCALE,
        1.0 if my_team == 2 else -1.0,
        (my_player.gold if my_player else 0.0) / _GOLD_SCALE,
        (my_player.xp if my_player else 0.0) / _XP_SCALE,
        (me.level if me is not None else 0) / _LEVEL_SCALE,
        kill_diff / 10.0,
        own_tower_hp,
        enemy_tower_hp,
    )

    mask_action = np.zeros((action_spec.n_action_types,), dtype=bool)
    mask_action[pb.ACTION_NOOP] = True
    if me_alive:
        mask_action[pb.ACTION_MOVE] = True
        mask_action[pb.ACTION_ATTACK_UNIT] = any_attackable
        mask_action[pb.ACTION_CAST] = self_castable and any_nukable
    if mask_action[pb.ACTION_CAST]:
        mask_ability[0] = True  # one nuke in slot 0 for now

    return Observation(
        units=units_arr,
        unit_mask=unit_mask,
        unit_handles=unit_handles,
        globals=globals_arr,
        hero_id=np.asarray(me.hero_id if me is not None else 0, dtype=np.int32),
        mask_action_type=mask_action,
        mask_target_unit=mask_target,
        mask_cast_target=mask_cast,
        mask_ability=mask_ability,
    )


def observation_to_dict(obs: Observation) -> Dict[str, np.ndarray]:
    return {f.name: getattr(obs, f.name) for f in dataclasses.fields(Observation)}


def stack_observations(obs_list) -> Dict[str, np.ndarray]:
    """Stack N observations into batched arrays (leading axis N)."""
    return {
        f.name: np.stack([getattr(o, f.name) for o in obs_list])
        for f in dataclasses.fields(Observation)
    }


def decode_action(
    action_indices: Mapping[str, int],
    obs: Observation,
    player_id: int,
    move_bins: int = 9,
) -> pb.Action:
    """Inverse codec: per-head indices sampled by the policy → Action proto.

    ``target_unit`` head indices are slot positions; the featurizer's
    ``unit_handles`` column recovers the proto handle.
    """
    a_type = int(action_indices["action_type"])
    action = pb.Action(player_id=player_id, type=a_type)
    if a_type == pb.ACTION_MOVE:
        mx_idx = int(action_indices["move_x"])
        if obs.globals[1] < 0:  # Dire: canonical frame is x-mirrored
            mx_idx = move_bins - 1 - mx_idx
        action.move_x = mx_idx
        action.move_y = int(action_indices["move_y"])
    elif a_type in (pb.ACTION_ATTACK_UNIT, pb.ACTION_CAST):
        slot = int(action_indices["target_unit"])
        action.target_handle = int(obs.unit_handles[slot])
        if a_type == pb.ACTION_CAST:
            action.ability_slot = int(action_indices["ability"])
    return action

"""The shaped reward from consecutive world states, and its one summation
order.

Counterpart of ``dotaclient_tpu/features/reward.py``: ``reward_components``
and ``shaped_reward`` are pure functions of (previous, current) world state
and a player, over the terms xp, gold, hp, enemy hp, last hits, denies,
kills, deaths, tower damage, own tower and the win. ``WEIGHTS`` are the
defaults of ``RewardConfig``; ``fold_terms`` is the summation order every
producer of the scalar reward (this module, the numpy ``VecRewards``, the
device rollout) folds through, so the rewards agree bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from dotaclient_tpu_torch.config import RewardConfig
from dotaclient_tpu_torch.protos import dota_pb2 as pb

WEIGHTS: Dict[str, float] = dict(RewardConfig().as_dict())


def _player(ws: pb.WorldState, player_id: int) -> Optional[pb.Player]:
    for p in ws.players:
        if p.player_id == player_id:
            return p
    return None


def _hero(ws: pb.WorldState, player_id: int) -> Optional[pb.Unit]:
    for u in ws.units:
        if u.unit_type == pb.UNIT_HERO and u.player_id == player_id:
            return u
    return None


def _hp_frac(unit: Optional[pb.Unit]) -> float:
    if unit is None or not unit.is_alive:
        return 0.0
    return unit.health / max(unit.health_max, 1.0)


def _tower_hp_frac(ws: pb.WorldState, team_id: int) -> float:
    for u in ws.units:
        if u.unit_type == pb.UNIT_TOWER and u.team_id == team_id:
            return u.health / max(u.health_max, 1.0)
    return 0.0  # destroyed towers leave the worldstate


def reward_components(
    prev: pb.WorldState, cur: pb.WorldState, player_id: int
) -> Dict[str, float]:
    """Per-component shaped reward for ``player_id`` over one interval."""
    p0, p1 = _player(prev, player_id), _player(cur, player_id)
    h0, h1 = _hero(prev, player_id), _hero(cur, player_id)
    if p1 is None:
        return {k: 0.0 for k in WEIGHTS}
    my_team = p1.team_id
    enemy_team = 2 if my_team == 3 else 3

    # Enemy hero hp: mean fraction over enemy heroes (harass signal).
    def enemy_hp_mean(ws: pb.WorldState) -> float:
        fracs = [
            _hp_frac(u)
            for u in ws.units
            if u.unit_type == pb.UNIT_HERO and u.team_id != my_team
        ]
        return sum(fracs) / len(fracs) if fracs else 0.0

    comps = {
        "xp": (p1.xp - p0.xp) if p0 else 0.0,
        "gold": (p1.gold - p0.gold) if p0 else 0.0,
        "hp": _hp_frac(h1) - _hp_frac(h0),
        "enemy_hp": -(enemy_hp_mean(cur) - enemy_hp_mean(prev)),
        "last_hits": float((h1.last_hits if h1 else 0) - (h0.last_hits if h0 else 0)),
        "denies": float((h1.denies if h1 else 0) - (h0.denies if h0 else 0)),
        "kills": float((p1.kills if p1 else 0) - (p0.kills if p0 else 0)),
        "deaths": float((p1.deaths if p1 else 0) - (p0.deaths if p0 else 0)),
        "tower_damage": _tower_hp_frac(prev, enemy_team)
        - _tower_hp_frac(cur, enemy_team),
        "own_tower": _tower_hp_frac(cur, my_team)
        - _tower_hp_frac(prev, my_team),
        "win": 0.0,
    }
    if cur.game_state == pb.GAME_STATE_POST_GAME and cur.winning_team:
        comps["win"] = 1.0 if cur.winning_team == my_team else -1.0
    return comps


def fold_terms(weighted: Dict[str, object]):
    """Left-fold a weighted per-term breakdown in table (insertion) order.
    This order is the contract: every producer of the scalar reward folds
    through this one helper, so the reward is bit-identical to the
    reference's sum of the same terms. Works on any ``+``-able values."""
    total = None
    for arr in weighted.values():
        total = arr if total is None else total + arr
    return total


def shaped_reward(
    prev: pb.WorldState,
    cur: pb.WorldState,
    player_id: int,
    weights: Optional[Dict[str, float]] = None,
) -> Tuple[float, Dict[str, float]]:
    """Scalar shaped reward plus the weighted per-component breakdown."""
    w = WEIGHTS if weights is None else weights
    comps = reward_components(prev, cur, player_id)
    weighted = {k: w[k] * v for k, v in comps.items()}
    return sum(weighted.values()), weighted

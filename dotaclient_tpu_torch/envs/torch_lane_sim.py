"""The lane game as batched tensors on the device.

Counterpart of ``dotaclient_tpu/envs/jax_lane_sim.py``, phase for phase:
every game of a batch is a row of fixed-shape ``[N, S]`` tensors (N games,
S unit slots, layout of ``envs/vec_lane_sim.VecSimSpec``), and ``step``
advances all of them by one observation interval with no host round trip
and no shape that depends on the game, so the rollout loop never
synchronises with the host.

What differs from the JAX module, and why:

* The state carries no random key. The only randomness of the game, the
  y-jitter of a spawned creep wave, is an input: ``init_state``,
  ``reset_where`` and ``step`` take ``jitter`` ([2, N, C], uniform on
  [-40, 40), one [N, C] draw per team, Radiant first, C =
  ``spec.creeps_per_team``) or draw it from ``generator``. A test hands in
  the numbers the JAX module drew.
* Damage and kill credit are summed by an explicit f32 multiply by a
  one-hot and a sum over the attacker axis, as the JAX module does with a
  one-hot matmul: no scatter-add (whose atomics add in no fixed order on
  CUDA) and no matmul (which TF32 would round to 10 mantissa bits, moving
  kill thresholds).
* Target picks use ``torch.argmin``/``torch.argmax``, which return the
  first index of a tie, as JAX's do.
* Integer fields stay int32 in the state and are cast to int64 only where
  they index.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from dotaclient_tpu_torch.envs.lane_sim import (
    ACTION_ATTACK_UNIT,
    ACTION_CAST,
    ACTION_MOVE,
    ACTION_NOOP,
    ATTACKS_PER_SECOND,
    CONTROL_AGENT,
    CONTROL_SCRIPTED_HARD,
    CREEP_ARMOR,
    CREEP_DAMAGE,
    CREEP_HP,
    CREEP_RANGE,
    CREEP_SPEED,
    CREEP_WAVE_PERIOD,
    CREEP_XP,
    CREEPS_PER_WAVE,
    DENY_XP_FACTOR,
    GENERIC_HERO,
    GOLD_PASSIVE_PER_SEC,
    GOLD_PER_HERO_KILL,
    GOLD_PER_LASTHIT,
    HERO_STATS,
    LANE_HALF_LENGTH,
    MAX_LEVEL,
    NUKE_BASE_DAMAGE,
    NUKE_COOLDOWN,
    NUKE_DAMAGE_PER_LEVEL,
    NUKE_MANA,
    NUKE_RANGE,
    NUKE_SLOT,
    RESPAWN_BASE_SECONDS,
    RESPAWN_PER_LEVEL_SECONDS,
    TEAM_DIRE,
    TEAM_RADIANT,
    TICKS_PER_SECOND,
    TOWER_ARMOR,
    TOWER_DAMAGE,
    TOWER_HP,
    TOWER_RANGE,
    TOWER_X,
    UNIT_HERO,
    UNIT_LANE_CREEP,
    UNIT_TOWER,
    XP_PER_HERO_KILL,
    XP_PER_LEVEL,
    XP_RADIUS,
)
from dotaclient_tpu_torch.envs.vec_lane_sim import VecSimSpec

_BIG = 1e9

Actions = Dict[str, torch.Tensor]   # type/move_x/move_y/target_slot/ability, [N, P]


@dataclasses.dataclass
class SimState:
    """All tensors have leading axis N (games); unit axis S = spec.max_units.
    Every function here returns a new state and never writes into one."""

    unit_type: torch.Tensor     # i32 [N, S]
    team: torch.Tensor          # i32 [N, S]
    x: torch.Tensor             # f32 [N, S]
    y: torch.Tensor             # f32 [N, S]
    health: torch.Tensor        # f32 [N, S]
    health_max: torch.Tensor    # f32 [N, S]
    mana: torch.Tensor          # f32 [N, S]
    mana_max: torch.Tensor      # f32 [N, S]
    damage: torch.Tensor        # f32 [N, S]
    attack_range: torch.Tensor  # f32 [N, S]
    move_speed: torch.Tensor    # f32 [N, S]
    armor: torch.Tensor         # f32 [N, S]
    level: torch.Tensor         # i32 [N, S]
    alive: torch.Tensor         # bool [N, S]
    attack_cd: torch.Tensor     # f32 [N, S]
    ability_cd: torch.Tensor    # f32 [N, S]
    xp: torch.Tensor            # f32 [N, S] (hero slots)
    gold: torch.Tensor          # f32 [N, S]
    last_hits: torch.Tensor     # i32 [N, S]
    denies: torch.Tensor        # i32 [N, S]
    kills: torch.Tensor         # i32 [N, S]
    deaths: torch.Tensor        # i32 [N, S]
    respawn_at: torch.Tensor    # f32 [N, S]
    dota_time: torch.Tensor     # f32 [N]
    tick: torch.Tensor          # i32 [N]
    done: torch.Tensor          # bool [N]
    winning_team: torch.Tensor  # i32 [N]
    next_wave_at: torch.Tensor  # f32 [N]
    hero_ids: torch.Tensor      # i32 [N, P]
    control_modes: torch.Tensor # i32 [N, P]

    def replace(self, **fields: torch.Tensor) -> "SimState":
        return dataclasses.replace(self, **fields)


FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


def _armor_mult(armor: torch.Tensor) -> torch.Tensor:
    return 1.0 - (0.06 * armor) / (1.0 + 0.06 * armor)


@functools.lru_cache(maxsize=None)
def _hero_stats_table(device: torch.device) -> torch.Tensor:
    """Dense hero_id -> stats lookup [n + 1, 6] (generic fallback rows),
    made once per device so that no step copies it from the host."""
    n = max(HERO_STATS) + 1
    table = torch.tensor(GENERIC_HERO, dtype=torch.float32).repeat(n + 1, 1)
    for hid, stats in HERO_STATS.items():
        table[hid] = torch.tensor(stats, dtype=torch.float32)
    return table.to(device)


def _set_cols(arr: torch.Tensor, lo: int, hi: int, vals) -> torch.Tensor:
    """``arr`` with columns [lo, hi) replaced by ``vals`` (a new tensor)."""
    out = arr.clone()
    out[:, lo:hi] = vals
    return out


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of an index tensor along a new last axis of size n."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def draw_jitter(spec: VecSimSpec, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """One wave spawn's y-jitter [2, N, C], uniform on [-40, 40)."""
    u = torch.rand((2, spec.n_games, spec.creeps_per_team), generator=generator, device=device)
    return u * 80.0 - 40.0


def init_state(
    spec: VecSimSpec,
    hero_ids: torch.Tensor,
    control_modes: torch.Tensor,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> SimState:
    """A fresh batch of games on ``hero_ids``' device: heroes and towers
    placed, the first creep wave spawned with ``jitter`` (drawn from
    ``generator`` when not given)."""
    N, S, P = spec.n_games, spec.max_units, spec.n_players
    dev = hero_ids.device
    f0 = torch.zeros((N, S), dtype=torch.float32, device=dev)
    i0 = torch.zeros((N, S), dtype=torch.int32, device=dev)
    state = SimState(
        unit_type=i0, team=i0, x=f0, y=f0,
        health=f0, health_max=torch.ones((N, S), dtype=torch.float32, device=dev),
        mana=f0, mana_max=f0, damage=f0, attack_range=f0,
        move_speed=f0, armor=f0, level=torch.ones((N, S), dtype=torch.int32, device=dev),
        alive=torch.zeros((N, S), dtype=torch.bool, device=dev), attack_cd=f0, ability_cd=f0,
        xp=f0, gold=f0, last_hits=i0, denies=i0, kills=i0, deaths=i0,
        respawn_at=torch.full((N, S), -1.0, dtype=torch.float32, device=dev),
        dota_time=torch.zeros((N,), dtype=torch.float32, device=dev),
        tick=torch.zeros((N,), dtype=torch.int32, device=dev),
        done=torch.zeros((N,), dtype=torch.bool, device=dev),
        winning_team=torch.zeros((N,), dtype=torch.int32, device=dev),
        next_wave_at=torch.zeros((N,), dtype=torch.float32, device=dev),
        hero_ids=hero_ids.to(torch.int32),
        control_modes=control_modes.to(torch.int32),
    )

    # heroes (slot == player id; Radiant first)
    pslots = torch.arange(P, device=dev)
    team_row = torch.where(pslots < spec.team_size, TEAM_RADIANT, TEAM_DIRE).to(torch.int32)
    side = torch.where(team_row == TEAM_RADIANT, -1.0, 1.0)
    table = _hero_stats_table(dev)
    stats = table[state.hero_ids.clamp(0, table.shape[0] - 1).long()]      # [N, P, 6]
    state = state.replace(
        unit_type=_set_cols(state.unit_type, 0, P, UNIT_HERO),
        team=_set_cols(state.team, 0, P, team_row.expand(N, P)),
        x=_set_cols(state.x, 0, P, (side * (LANE_HALF_LENGTH - 300.0)).expand(N, P)),
        y=_set_cols(state.y, 0, P, (60.0 * (pslots % 5)).to(torch.float32).expand(N, P)),
        health=_set_cols(state.health, 0, P, stats[..., 0]),
        health_max=_set_cols(state.health_max, 0, P, stats[..., 0]),
        mana=_set_cols(state.mana, 0, P, stats[..., 1]),
        mana_max=_set_cols(state.mana_max, 0, P, stats[..., 1]),
        damage=_set_cols(state.damage, 0, P, stats[..., 2]),
        attack_range=_set_cols(state.attack_range, 0, P, stats[..., 3]),
        move_speed=_set_cols(state.move_speed, 0, P, stats[..., 4]),
        armor=_set_cols(state.armor, 0, P, stats[..., 5]),
        alive=_set_cols(state.alive, 0, P, True),
    )

    # towers
    for k, team in enumerate((TEAM_RADIANT, TEAM_DIRE)):
        t = spec.tower_lo + k
        state = state.replace(
            unit_type=_set_cols(state.unit_type, t, t + 1, UNIT_TOWER),
            team=_set_cols(state.team, t, t + 1, team),
            x=_set_cols(state.x, t, t + 1, TOWER_X[team]),
            health=_set_cols(state.health, t, t + 1, TOWER_HP),
            health_max=_set_cols(state.health_max, t, t + 1, TOWER_HP),
            damage=_set_cols(state.damage, t, t + 1, TOWER_DAMAGE),
            attack_range=_set_cols(state.attack_range, t, t + 1, TOWER_RANGE),
            armor=_set_cols(state.armor, t, t + 1, TOWER_ARMOR),
            alive=_set_cols(state.alive, t, t + 1, True),
        )

    if jitter is None:
        jitter = draw_jitter(spec, generator, dev)
    state = _spawn_waves(spec, state, torch.ones((N,), dtype=torch.bool, device=dev), jitter)
    return state.replace(next_wave_at=torch.full((N,), CREEP_WAVE_PERIOD, dtype=torch.float32, device=dev))


def reset_where(
    spec: VecSimSpec,
    state: SimState,
    mask: torch.Tensor,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> SimState:
    """Re-initialise the games where ``mask`` [N]: fresh rows are made for
    the whole batch (with ``jitter`` for their first wave) and merged where
    the mask holds."""
    fresh = init_state(spec, state.hero_ids, state.control_modes, jitter, generator)

    def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return SimState(**{k: merge(getattr(fresh, k), getattr(state, k)) for k in FIELDS})


def _spawn_waves(spec: VecSimSpec, state: SimState, due: torch.Tensor, jitter: torch.Tensor) -> SimState:
    """Spawn one creep wave per team where ``due`` (claiming free pool
    slots); ``jitter[i]`` [N, C] is team i's y-jitter."""
    C = spec.creeps_per_team
    for i, team in enumerate((TEAM_RADIANT, TEAM_DIRE)):
        lo, hi = spec.creep_lo + i * C, spec.creep_lo + (i + 1) * C
        sign = 1.0 if team == TEAM_RADIANT else -1.0
        free = ~state.alive[:, lo:hi]                                # [N, C]
        order = torch.cumsum(free, dim=1) - 1
        take = free & (order < CREEPS_PER_WAVE) & due[:, None]
        k = order.to(torch.float32)

        def w(arr, val):
            return _set_cols(arr, lo, hi, torch.where(take, val, arr[:, lo:hi]))

        state = state.replace(
            unit_type=w(state.unit_type, UNIT_LANE_CREEP),
            team=w(state.team, team),
            x=w(state.x, TOWER_X[team] + sign * (250.0 + 40.0 * k)),
            y=w(state.y, jitter[i]),
            health=w(state.health, CREEP_HP),
            health_max=w(state.health_max, CREEP_HP),
            damage=w(state.damage, CREEP_DAMAGE),
            attack_range=w(state.attack_range, CREEP_RANGE),
            move_speed=w(state.move_speed, CREEP_SPEED),
            armor=w(state.armor, CREEP_ARMOR),
            level=w(state.level, 1),
            alive=w(state.alive, True),
            attack_cd=w(state.attack_cd, 0.0),
        )
    return state


def _pairwise_dist(state: SimState) -> torch.Tensor:
    dx = state.x[:, :, None] - state.x[:, None, :]
    dy = state.y[:, :, None] - state.y[:, None, :]
    return torch.hypot(dx, dy)


def hero_castable(state: SimState) -> torch.Tensor:
    return (state.unit_type == UNIT_HERO) & (state.ability_cd <= 0.0) & (state.mana >= NUKE_MANA)


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------


def step(
    spec: VecSimSpec,
    state: SimState,
    actions: Actions,
    scripted_possible: bool = True,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> SimState:
    """One observation interval for every game that is not done: movement,
    hero attacks and casts, creeps and towers, then clocks, regeneration,
    respawns, the creep wave (with ``jitter``, drawn from ``generator``
    when not given) and the timeout. ``scripted_possible=False`` (no
    player is scripted) skips the scripted bots."""
    N, S, P = spec.n_games, spec.max_units, spec.n_players
    live = ~state.done
    dt = spec.ticks_per_obs / TICKS_PER_SECOND
    dist = _pairwise_dist(state)
    if jitter is None:
        jitter = draw_jitter(spec, generator, state.x.device)

    a_type = torch.where(actions["type"] < 0, ACTION_NOOP, actions["type"])
    move_x = actions["move_x"]
    move_y = actions["move_y"]
    target = torch.clamp(actions["target_slot"], 0, S - 1).long()
    ability = actions["ability"]

    if scripted_possible:
        scripted = state.control_modes != CONTROL_AGENT
        sa = _scripted_actions(spec, state, dist)
        a_type = torch.where(scripted, sa["type"], a_type)
        move_x = torch.where(scripted, sa["move_x"], move_x)
        move_y = torch.where(scripted, sa["move_y"], move_y)
        target = torch.where(scripted, sa["target_slot"].long(), target)
        ability = torch.where(scripted, sa["ability"], ability)

    hero_alive = state.alive[:, :P] & live[:, None]

    # 1. movement
    half = (spec.move_bins - 1) / 2.0
    moving = hero_alive & (a_type == ACTION_MOVE)
    mdx = (move_x - half) / max(half, 1.0)
    mdy = (move_y - half) / max(half, 1.0)
    norm = torch.hypot(mdx, mdy)
    ok = moving & (norm > 1e-6)
    scale = torch.where(ok, state.move_speed[:, :P] * dt / torch.clamp(norm, min=1e-9), 0.0)
    new_hx = torch.clamp(state.x[:, :P] + mdx * scale, -LANE_HALF_LENGTH, LANE_HALF_LENGTH)
    new_hy = torch.clamp(state.y[:, :P] + mdy * scale, -400.0, 400.0)
    state = state.replace(
        x=_set_cols(state.x, 0, P, torch.where(ok, new_hx, state.x[:, :P])),
        y=_set_cols(state.y, 0, P, torch.where(ok, new_hy, state.y[:, :P])),
    )

    # 2. hero attacks / casts (phase A)
    tgt_dist = dist[:, :P, :].gather(2, target[..., None])[..., 0]
    t_alive = state.alive.gather(1, target)
    t_team = state.team.gather(1, target)
    t_type = state.unit_type.gather(1, target)
    t_hp = state.health.gather(1, target)
    t_hpmax = state.health_max.gather(1, target)
    my_team = state.team[:, :P]

    is_deny = (t_team == my_team) & (t_type == UNIT_LANE_CREEP) & (t_hp < 0.5 * t_hpmax)
    attack_ok = (
        hero_alive
        & (a_type == ACTION_ATTACK_UNIT)
        & t_alive
        & ((t_team != my_team) | is_deny)
        & (tgt_dist <= state.attack_range[:, :P] + 50.0)
        & (state.attack_cd[:, :P] <= 0.0)
    )
    cast_ok = (
        hero_alive
        & (a_type == ACTION_CAST)
        & (ability == NUKE_SLOT)
        & t_alive
        & (t_team != my_team)
        & (tgt_dist <= NUKE_RANGE)
        & (state.ability_cd[:, :P] <= 0.0)
        & (state.mana[:, :P] >= NUKE_MANA)
    )
    state = state.replace(
        attack_cd=_set_cols(state.attack_cd, 0, P,
                            torch.where(attack_ok, 1.0 / ATTACKS_PER_SECOND, state.attack_cd[:, :P])),
        mana=_set_cols(state.mana, 0, P, torch.where(cast_ok, state.mana[:, :P] - NUKE_MANA, state.mana[:, :P])),
        ability_cd=_set_cols(state.ability_cd, 0, P,
                             torch.where(cast_ok, NUKE_COOLDOWN, state.ability_cd[:, :P])),
    )
    raw = torch.where(attack_ok, state.damage[:, :P], 0.0) + torch.where(
        cast_ok, NUKE_BASE_DAMAGE + NUKE_DAMAGE_PER_LEVEL * state.level[:, :P], 0.0
    )
    hit = attack_ok | cast_ok
    t_mult = _armor_mult(state.armor.gather(1, target))
    # f32 multiply by a one-hot and sum over the attacker axis: a fixed
    # order, no atomics and no TF32 (see the module docstring)
    dmg = (torch.where(hit, raw * t_mult, 0.0)[..., None] * _onehot(target, S)).sum(dim=1)
    state = _resolve_deaths(
        spec, state, dmg, dist, hero_hit=hit, hero_target=target, hero_deny=is_deny & attack_ok,
    )

    # 3. creeps and towers act (phase B, phase-start targeting world)
    state = _step_ai(spec, state, dist, dt, live)

    # 4. clocks, regen, respawns, waves, timeout
    return _step_clocks(spec, state, dt, live, jitter)


def _resolve_deaths(
    spec: VecSimSpec,
    state: SimState,
    dmg: torch.Tensor,
    dist: torch.Tensor,
    hero_hit: Optional[torch.Tensor] = None,
    hero_target: Optional[torch.Tensor] = None,
    hero_deny: Optional[torch.Tensor] = None,
) -> SimState:
    N, S, P = spec.n_games, spec.max_units, spec.n_players
    pre_alive = state.alive
    health = torch.where(pre_alive, state.health - dmg, state.health)
    died = pre_alive & (health <= 0.0)
    health = torch.where(died, 0.0, health)
    alive = pre_alive & ~died
    state = state.replace(health=health, alive=alive)

    is_creep = state.unit_type == UNIT_LANE_CREEP
    is_hero = state.unit_type == UNIT_HERO
    died_creep = died & is_creep
    died_hero = died & is_hero
    died_tower = died & (state.unit_type == UNIT_TOWER)

    denied_creep = torch.zeros((N, S), dtype=torch.bool, device=dmg.device)
    if hero_hit is not None:
        # kill credit: the lowest player index whose landed attack targeted
        # the dead slot (argmax over the credit picks the first)
        credit = hero_hit[:, :, None] & (
            hero_target[:, :, None] == torch.arange(S, device=dmg.device)[None, None, :]
        )                                                           # [N, P, S]
        by_hero = died & credit.any(dim=1)                          # [N, S]
        first_p = torch.argmax(credit.to(torch.int32), dim=1)       # [N, S]
        deny_credit = hero_deny.gather(1, first_p)                  # [N, S]

        cred_creep = by_hero & is_creep
        denied_creep = cred_creep & deny_credit
        lasthit = cred_creep & ~deny_credit
        cred_hero = by_hero & is_hero

        # fixed-order reduction over victim slots (see the dmg comment)
        onehot_p = _onehot(first_p, S)                              # [N, S, S]

        def reduce_p(vals: torch.Tensor) -> torch.Tensor:
            return (vals.to(torch.float32)[..., None] * onehot_p).sum(dim=1)

        state = state.replace(
            denies=state.denies + reduce_p(denied_creep).to(torch.int32),
            last_hits=state.last_hits + reduce_p(lasthit).to(torch.int32),
            kills=state.kills + reduce_p(cred_hero).to(torch.int32),
            gold=state.gold + reduce_p(GOLD_PER_LASTHIT * lasthit + GOLD_PER_HERO_KILL * cred_hero),
        )
        state = _grant_xp(spec, state, reduce_p(XP_PER_HERO_KILL * cred_hero)[:, :P])

    # creep XP: living enemy heroes within radius split it
    xp_each = torch.where(denied_creep, CREEP_XP * DENY_XP_FACTOR, CREEP_XP)
    hero_d = dist[:, :P, :]                                         # [N, P, S]
    eligible = (
        state.alive[:, :P, None]
        & (state.team[:, :P, None] != state.team[:, None, :])
        & (hero_d <= XP_RADIUS)
        & died_creep[:, None, :]
    )                                                               # [N, P, S]
    cnt = torch.clamp(eligible.sum(dim=1), min=1)                   # [N, S]
    share = (eligible * (xp_each / cnt)[:, None, :]).sum(dim=2)     # [N, P]
    state = _grant_xp(spec, state, share)

    # hero deaths: respawn timers
    hp_slots = died_hero[:, :P]
    state = state.replace(
        deaths=_set_cols(state.deaths, 0, P, state.deaths[:, :P] + hp_slots.to(torch.int32)),
        respawn_at=_set_cols(state.respawn_at, 0, P, torch.where(
            hp_slots,
            state.dota_time[:, None] + RESPAWN_BASE_SECONDS + RESPAWN_PER_LEVEL_SECONDS * state.level[:, :P],
            state.respawn_at[:, :P],
        )),
    )

    # tower death ends the game
    rad_died = died_tower[:, spec.tower_lo]
    dire_died = died_tower[:, spec.tower_lo + 1]
    return state.replace(
        done=state.done | rad_died | dire_died,
        winning_team=torch.where(
            dire_died, TEAM_RADIANT, torch.where(rad_died, TEAM_DIRE, state.winning_team)
        ).to(torch.int32),
    )


def _grant_xp(spec: VecSimSpec, state: SimState, xp_gain: torch.Tensor) -> SimState:
    """Add XP [N, P] to hero slots with closed-form level-ups (level =
    1 + floor(xp / 220), capped; per level +40 max HP and heal, +20 max
    mana, +4 damage; elementwise, so simultaneous grants cannot apply
    twice)."""
    P = spec.n_players
    xp = _set_cols(state.xp, 0, P, state.xp[:, :P] + xp_gain)
    cur = state.level[:, :P]
    new = torch.clamp(torch.floor_divide(xp[:, :P], XP_PER_LEVEL).to(torch.int32) + 1, max=MAX_LEVEL)
    gained = torch.clamp(new - cur, min=0).to(torch.float32)
    hp_max = _set_cols(state.health_max, 0, P, state.health_max[:, :P] + 40.0 * gained)
    return state.replace(
        xp=xp,
        level=_set_cols(state.level, 0, P, torch.maximum(cur, new)),
        health_max=hp_max,
        health=_set_cols(state.health, 0, P,
                         torch.minimum(state.health[:, :P] + 40.0 * gained, hp_max[:, :P])),
        mana_max=_set_cols(state.mana_max, 0, P, state.mana_max[:, :P] + 20.0 * gained),
        damage=_set_cols(state.damage, 0, P, state.damage[:, :P] + 4.0 * gained),
    )


def _step_ai(spec: VecSimSpec, state: SimState, dist: torch.Tensor, dt: float, live: torch.Tensor) -> SimState:
    S = spec.max_units
    alive = state.alive & live[:, None]
    enemy = alive[:, :, None] & alive[:, None, :] & (state.team[:, :, None] != state.team[:, None, :])
    d_masked = torch.where(enemy, dist, _BIG)

    is_creep = (state.unit_type == UNIT_LANE_CREEP) & alive
    is_tower = (state.unit_type == UNIT_TOWER) & alive

    nearest = torch.argmin(d_masked, dim=2)
    nearest_d = d_masked.gather(2, nearest[:, :, None])[:, :, 0]
    can_attack = is_creep & (nearest_d <= state.attack_range + 20.0)
    attacking = can_attack & (state.attack_cd <= 0.0)

    in_tower_range = d_masked <= state.attack_range[:, :, None]
    t_pref = torch.where(
        in_tower_range,
        d_masked + torch.where(state.unit_type[:, None, :] == UNIT_HERO, 1e6, 0.0),
        _BIG * 2.0,
    )
    t_near = torch.argmin(t_pref, dim=2)
    t_attacking = is_tower & (t_pref.amin(dim=2) < _BIG) & (state.attack_cd <= 0.0)

    atk = attacking | t_attacking
    tgt = torch.where(t_attacking, t_near, nearest)
    state = state.replace(attack_cd=torch.where(atk, 1.0 / ATTACKS_PER_SECOND, state.attack_cd))
    t_mult = _armor_mult(state.armor.gather(1, tgt))
    # fixed-order one-hot reduction (see the phase-A dmg comment)
    dmg = (torch.where(atk, state.damage * t_mult, 0.0)[..., None] * _onehot(tgt, S)).sum(dim=1)
    state = _resolve_deaths(spec, state, dmg, dist)

    marching = is_creep & ~can_attack & state.alive
    goal_x = torch.where(state.team == TEAM_RADIANT, TOWER_X[TEAM_DIRE], TOWER_X[TEAM_RADIANT])
    step_len = state.move_speed * dt
    delta = goal_x - state.x
    return state.replace(
        x=torch.where(marching, state.x + torch.sign(delta) * torch.minimum(step_len, delta.abs()), state.x)
    )


def _step_clocks(
    spec: VecSimSpec, state: SimState, dt: float, live: torch.Tensor, jitter: torch.Tensor
) -> SimState:
    P = spec.n_players
    livef = live.to(torch.float32)[:, None]
    dota_time = torch.where(live, state.dota_time + dt, state.dota_time)
    state = state.replace(
        dota_time=dota_time,
        tick=torch.where(live, state.tick + spec.ticks_per_obs, state.tick),
        attack_cd=torch.clamp(state.attack_cd - dt * livef, min=0.0),
        ability_cd=torch.clamp(state.ability_cd - dt * livef, min=0.0),
    )
    hero_alive = (state.unit_type == UNIT_HERO) & state.alive & live[:, None]
    state = state.replace(
        gold=torch.where(hero_alive, state.gold + GOLD_PASSIVE_PER_SEC * dt, state.gold),
        health=torch.where(hero_alive, torch.minimum(state.health + 1.5 * dt, state.health_max), state.health),
        mana=torch.where(hero_alive, torch.minimum(state.mana + 1.0 * dt, state.mana_max), state.mana),
    )

    # respawns
    hero_dead = (
        (state.unit_type == UNIT_HERO) & ~state.alive & live[:, None]
        & (state.respawn_at >= 0.0)
        & (state.respawn_at <= state.dota_time[:, None])
    )
    pslots = torch.arange(P, device=live.device)
    side = torch.where(state.team[:, :P] == TEAM_RADIANT, -1.0, 1.0)
    hd = hero_dead[:, :P]
    state = state.replace(
        alive=_set_cols(state.alive, 0, P, state.alive[:, :P] | hd),
        health=_set_cols(state.health, 0, P, torch.where(hd, state.health_max[:, :P], state.health[:, :P])),
        mana=_set_cols(state.mana, 0, P, torch.where(hd, state.mana_max[:, :P], state.mana[:, :P])),
        x=_set_cols(state.x, 0, P, torch.where(hd, side * (LANE_HALF_LENGTH - 300.0), state.x[:, :P])),
        y=_set_cols(state.y, 0, P, torch.where(hd, (60.0 * (pslots % 5)).to(torch.float32), state.y[:, :P])),
        respawn_at=_set_cols(state.respawn_at, 0, P, torch.where(hd, -1.0, state.respawn_at[:, :P])),
    )

    # waves
    wave_due = live & ~state.done & (state.dota_time >= state.next_wave_at)
    state = _spawn_waves(spec, state, wave_due, jitter)
    state = state.replace(
        next_wave_at=torch.where(wave_due, state.dota_time + CREEP_WAVE_PERIOD, state.next_wave_at)
    )

    # timeout adjudication: (tower hp, team kills, team gold) lexicographic
    timed_out = live & ~state.done & (state.dota_time >= spec.max_dota_time)
    is_rad = state.team[:, :P] == TEAM_RADIANT
    rk = (state.kills[:, :P] * is_rad).sum(dim=1).to(torch.float32)
    dk = (state.kills[:, :P] * ~is_rad).sum(dim=1).to(torch.float32)
    rg = (state.gold[:, :P] * is_rad).sum(dim=1)
    dg = (state.gold[:, :P] * ~is_rad).sum(dim=1)
    rt = state.health[:, spec.tower_lo]
    dt_ = state.health[:, spec.tower_lo + 1]
    r_wins = (rt > dt_) | ((rt == dt_) & ((rk > dk) | ((rk == dk) & (rg > dg))))
    d_wins = (dt_ > rt) | ((rt == dt_) & ((dk > rk) | ((rk == dk) & (dg > rg))))
    verdict = torch.where(r_wins, TEAM_RADIANT, torch.where(d_wins, TEAM_DIRE, 0))
    return state.replace(
        done=state.done | timed_out,
        winning_team=torch.where(timed_out, verdict, state.winning_team).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# scripted bots
# ---------------------------------------------------------------------------


def _scripted_actions(spec: VecSimSpec, state: SimState, dist: torch.Tensor) -> Actions:
    N, P = spec.n_games, spec.n_players
    dev = dist.device
    half = (spec.move_bins - 1) / 2.0
    my_team = state.team[:, :P]
    hard = state.control_modes == CONTROL_SCRIPTED_HARD
    hero_alive = state.alive[:, :P]
    hp_frac = state.health[:, :P] / torch.clamp(state.health_max[:, :P], min=1.0)

    enemy = state.alive[:, None, :] & (state.team[:, None, :] != my_team[:, :, None])
    pd = dist[:, :P, :]
    d_enemy = torch.where(enemy, pd, _BIG)

    is_hero_s = state.unit_type == UNIT_HERO
    is_creep_s = state.unit_type == UNIT_LANE_CREEP
    enemy_hero = enemy & is_hero_s[:, None, :]
    d_ehero = torch.where(enemy_hero, pd, _BIG)

    i32 = torch.int32
    out_type = torch.full((N, P), ACTION_NOOP, dtype=i32, device=dev)
    out_mx = torch.zeros((N, P), dtype=i32, device=dev)
    out_my = torch.zeros((N, P), dtype=i32, device=dev)
    out_tgt = torch.zeros((N, P), dtype=i32, device=dev)
    out_abl = torch.zeros((N, P), dtype=i32, device=dev)

    def move_toward(mask, gx, gy, o_type, o_mx, o_my):
        dx = gx - state.x[:, :P]
        dy = gy - state.y[:, :P]
        norm = torch.hypot(dx, dy)
        okm = mask & (norm >= 1e-6)
        denom = torch.clamp(norm, min=1e-9)
        mx = torch.clamp(torch.round(half + half * dx / denom), 0, spec.move_bins - 1).to(i32)
        my = torch.clamp(torch.round(half + half * dy / denom), 0, spec.move_bins - 1).to(i32)
        return (
            torch.where(okm, ACTION_MOVE, o_type).to(i32),
            torch.where(okm, mx, o_mx),
            torch.where(okm, my, o_my),
        )

    todo = hero_alive

    # HARD retreat
    near_ehero = d_ehero.amin(dim=2) <= 900.0
    retreat = todo & hard & (hp_frac < 0.3) & near_ehero
    own_tower_x = torch.where(my_team == TEAM_RADIANT, TOWER_X[TEAM_RADIANT], TOWER_X[TEAM_DIRE])
    out_type, out_mx, out_my = move_toward(
        retreat, own_tower_x, torch.zeros_like(own_tower_x), out_type, out_mx, out_my
    )
    todo = todo & ~retreat

    def attack(do, tgt, o_type, o_tgt):
        return torch.where(do, ACTION_ATTACK_UNIT, o_type).to(i32), torch.where(do, tgt, o_tgt)

    def lowest(cands, key):
        """First slot of the lowest ``key`` among ``cands`` [N, P, S]."""
        return torch.argmin(torch.where(cands, key, _BIG), dim=2).to(i32)

    # HARD nuke the lowest-HP enemy hero in range
    castable = (state.mana[:, :P] >= NUKE_MANA) & (state.ability_cd[:, :P] <= 0.0)
    nukable = enemy_hero & (pd <= NUKE_RANGE)
    health_s = state.health[:, None, :].expand_as(pd)
    nuke_tgt = lowest(nukable, health_s)
    can_nuke = todo & hard & castable & nukable.any(dim=2)
    out_type = torch.where(can_nuke, ACTION_CAST, out_type).to(i32)
    out_tgt = torch.where(can_nuke, nuke_tgt, out_tgt)
    out_abl = torch.where(can_nuke, NUKE_SLOT, out_abl).to(i32)
    todo = todo & ~can_nuke

    in_range = enemy & (pd <= state.attack_range[:, :P, None] + 50.0)

    # HARD last-hit a killable creep
    eff_dmg = state.damage[:, :P, None] * _armor_mult(state.armor[:, None, :])
    killable = in_range & is_creep_s[:, None, :] & (state.health[:, None, :] <= eff_dmg)
    do_lh = todo & hard & killable.any(dim=2)
    out_type, out_tgt = attack(do_lh, lowest(killable, health_s), out_type, out_tgt)
    todo = todo & ~do_lh

    # HARD harass an enemy hero while healthy
    heroes_in_range = in_range & is_hero_s[:, None, :]
    do_harass = todo & hard & heroes_in_range.any(dim=2) & (hp_frac >= 0.5)
    out_type, out_tgt = attack(do_harass, lowest(heroes_in_range, health_s), out_type, out_tgt)
    todo = todo & ~do_harass

    # HARD pressure the lowest-HP creep in range
    creeps_in_range = in_range & is_creep_s[:, None, :]
    do_press = todo & hard & creeps_in_range.any(dim=2)
    out_type, out_tgt = attack(do_press, lowest(creeps_in_range, health_s), out_type, out_tgt)
    todo = todo & ~do_press

    # EASY / fallback: attack the nearest in range
    do_atk = todo & in_range.any(dim=2)
    out_type, out_tgt = attack(do_atk, lowest(in_range, pd), out_type, out_tgt)
    todo = todo & ~do_atk

    # march toward the nearest enemy (or mid)
    nearest_any = torch.argmin(d_enemy, dim=2)
    has_enemy = d_enemy.amin(dim=2) < _BIG
    gx = torch.where(has_enemy, state.x.gather(1, nearest_any), 0.0)
    gy = torch.where(has_enemy, state.y.gather(1, nearest_any), 0.0)
    out_type, out_mx, out_my = move_toward(todo, gx, gy, out_type, out_mx, out_my)

    return {"type": out_type, "move_x": out_mx, "move_y": out_my, "target_slot": out_tgt, "ability": out_abl}

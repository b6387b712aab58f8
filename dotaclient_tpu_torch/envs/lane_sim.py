"""The lane game: its rule constants and the scalar, proto-exporting game.

Counterpart of ``dotaclient_tpu/envs/lane_sim.py``. The constants are read
by the device simulator (``envs/torch_lane_sim.py``) and the numpy one
(``envs/vec_lane_sim.py``), with the protocol's enum values (``UNIT_*``,
``ACTION_*``, ``CONTROL_*``, ``GAME_STATE_*``) also as plain ints, equal to
``protos/dota.proto``'s.

``LaneSim`` is one game on the host, the stand-in for the Dota 2 process and
dotaservice pair: a lane with creep waves, last-hit and deny gold, XP and
levels, one castable nuke, towers, deaths and respawns and a win condition.
It is deterministic given its ``GameConfig.seed`` (the creeps' spawn jitter
is its one random draw) and the action stream, and ``world_state(team)``
exports the game as the ``WorldState`` proto the reference's bots read.
``scripted_action`` is the easy and hard scripted bots' controller. Given
the same seed and actions, the world states serialize to the JAX package's
bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from dotaclient_tpu_torch.protos import dota_pb2 as pb

# protocol enums (dota.proto)
UNIT_INVALID, UNIT_HERO, UNIT_LANE_CREEP, UNIT_TOWER, UNIT_BUILDING = 0, 1, 2, 3, 4
ACTION_NOOP, ACTION_MOVE, ACTION_ATTACK_UNIT, ACTION_CAST = 0, 1, 2, 3
CONTROL_AGENT, CONTROL_SCRIPTED_EASY, CONTROL_SCRIPTED_HARD = 0, 1, 2
GAME_STATE_INIT, GAME_STATE_PRE_GAME, GAME_STATE_IN_PROGRESS, GAME_STATE_POST_GAME = 0, 1, 2, 3

# Team ids follow the Dota convention.
TEAM_RADIANT = 2
TEAM_DIRE = 3
TEAMS = (TEAM_RADIANT, TEAM_DIRE)

TICKS_PER_SECOND = 30
LANE_HALF_LENGTH = 2000.0
TOWER_X = {TEAM_RADIANT: -LANE_HALF_LENGTH, TEAM_DIRE: LANE_HALF_LENGTH}
CREEP_WAVE_PERIOD = 30.0
CREEPS_PER_WAVE = 4
MAX_LEVEL = 10

# XP required to reach level i+1 from level i.
XP_PER_LEVEL = 220.0
XP_RADIUS = 1200.0
DENY_XP_FACTOR = 0.3  # fraction of creep XP granted to enemies when denied

GOLD_PER_LASTHIT = 40.0
GOLD_PASSIVE_PER_SEC = 1.7
GOLD_PER_HERO_KILL = 200.0
XP_PER_HERO_KILL = 280.0
RESPAWN_BASE_SECONDS = 6.0
RESPAWN_PER_LEVEL_SECONDS = 2.0

NUKE_SLOT = 0
NUKE_MANA = 50.0
NUKE_COOLDOWN = 10.0
NUKE_RANGE = 600.0
NUKE_BASE_DAMAGE = 75.0
NUKE_DAMAGE_PER_LEVEL = 25.0

HERO_STATS = {
    # hero_id: (hp, mana, damage, attack_range, move_speed, armor)
    1: (550.0, 270.0, 52.0, 500.0, 310.0, 2.0),   # "nevermore"
    2: (480.0, 360.0, 48.0, 650.0, 295.0, 1.0),   # "lina"
    3: (500.0, 300.0, 45.0, 550.0, 290.0, 1.5),   # "sniper"
}
GENERIC_HERO = (520.0, 300.0, 48.0, 550.0, 300.0, 1.5)

CREEP_HP = 550.0
CREEP_DAMAGE = 20.0
CREEP_RANGE = 110.0
CREEP_SPEED = 325.0
CREEP_ARMOR = 2.0
CREEP_XP = 60.0

TOWER_HP = 1800.0
TOWER_DAMAGE = 110.0
TOWER_RANGE = 700.0
TOWER_ARMOR = 10.0

ATTACKS_PER_SECOND = 1.0


def _armor_multiplier(armor: float) -> float:
    return 1.0 - (0.06 * armor) / (1.0 + 0.06 * armor)


@dataclasses.dataclass
class SimUnit:
    handle: int
    unit_type: int
    team_id: int
    x: float
    y: float
    health: float
    health_max: float
    mana: float = 0.0
    mana_max: float = 0.0
    damage: float = 0.0
    attack_range: float = 0.0
    move_speed: float = 0.0
    armor: float = 0.0
    player_id: int = -1
    hero_id: int = 0
    level: int = 1
    xp: float = 0.0
    gold: float = 0.0
    last_hits: int = 0
    denies: int = 0
    kills: int = 0
    deaths: int = 0
    attack_cooldown: float = 0.0
    ability_cooldown: float = 0.0
    respawn_at: float = -1.0
    alive: bool = True

    def dist(self, other: "SimUnit") -> float:
        return math.hypot(self.x - other.x, self.y - other.y)


class LaneSim:
    """One lane, two teams. Deterministic given (config.seed, action stream)."""

    def __init__(self, config: pb.GameConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self.ticks_per_obs = max(1, config.ticks_per_observation or 6)
        self.max_dota_time = config.max_dota_time or 600.0
        self.move_bins = config.move_bins or 9
        self.dota_time = 0.0
        self.tick = 0
        self._next_handle = 1
        self._next_wave_at = 0.0
        self.units: Dict[int, SimUnit] = {}
        self.game_state = pb.GAME_STATE_IN_PROGRESS
        self.winning_team = 0
        self.heroes: List[SimUnit] = []
        self.towers: Dict[int, SimUnit] = {}

        picks = list(config.hero_picks)
        if not picks:
            picks = [
                pb.HeroPick(team_id=TEAM_RADIANT, hero_id=1, control_mode=pb.CONTROL_AGENT),
                pb.HeroPick(team_id=TEAM_DIRE, hero_id=1, control_mode=pb.CONTROL_SCRIPTED_EASY),
            ]
        self.control_modes: Dict[int, int] = {}
        player_id = 0
        for pick in picks:
            hero = self._spawn_hero(player_id, pick.team_id, pick.hero_id)
            self.control_modes[player_id] = pick.control_mode
            self.heroes.append(hero)
            player_id += 1

        for team in TEAMS:
            self.towers[team] = self._spawn_tower(team)
        self._spawn_wave()

    # -- spawning ----------------------------------------------------------

    def _handle(self) -> int:
        h = self._next_handle
        self._next_handle += 1
        return h

    def _hero_spawn_pos(self, team_id: int, player_id: int) -> tuple:
        side = -1.0 if team_id == TEAM_RADIANT else 1.0
        return (side * (LANE_HALF_LENGTH - 300.0), 60.0 * (player_id % 5))

    def _spawn_hero(self, player_id: int, team_id: int, hero_id: int) -> SimUnit:
        hp, mana, dmg, rng_, speed, armor = HERO_STATS.get(hero_id, GENERIC_HERO)
        x, y = self._hero_spawn_pos(team_id, player_id)
        unit = SimUnit(
            handle=self._handle(), unit_type=pb.UNIT_HERO, team_id=team_id,
            x=x, y=y, health=hp, health_max=hp, mana=mana, mana_max=mana,
            damage=dmg, attack_range=rng_, move_speed=speed, armor=armor,
            player_id=player_id, hero_id=hero_id,
        )
        self.units[unit.handle] = unit
        return unit

    def _spawn_tower(self, team_id: int) -> SimUnit:
        unit = SimUnit(
            handle=self._handle(), unit_type=pb.UNIT_TOWER, team_id=team_id,
            x=TOWER_X[team_id], y=0.0, health=TOWER_HP, health_max=TOWER_HP,
            damage=TOWER_DAMAGE, attack_range=TOWER_RANGE, armor=TOWER_ARMOR,
        )
        self.units[unit.handle] = unit
        return unit

    def _spawn_wave(self) -> None:
        for team in TEAMS:
            sign = 1.0 if team == TEAM_RADIANT else -1.0
            for i in range(CREEPS_PER_WAVE):
                unit = SimUnit(
                    handle=self._handle(), unit_type=pb.UNIT_LANE_CREEP,
                    team_id=team,
                    x=TOWER_X[team] + sign * (250.0 + 40.0 * i),
                    y=float(self.rng.uniform(-40.0, 40.0)),
                    health=CREEP_HP, health_max=CREEP_HP, damage=CREEP_DAMAGE,
                    attack_range=CREEP_RANGE, move_speed=CREEP_SPEED,
                    armor=CREEP_ARMOR,
                )
                self.units[unit.handle] = unit
        self._next_wave_at = self.dota_time + CREEP_WAVE_PERIOD

    # -- queries -----------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.game_state == pb.GAME_STATE_POST_GAME

    def hero_for_player(self, player_id: int) -> SimUnit:
        return self.heroes[player_id]

    def living(self, team_id: Optional[int] = None) -> List[SimUnit]:
        return [
            u for u in self.units.values()
            if u.alive and (team_id is None or u.team_id == team_id)
        ]

    def enemies_of(self, team_id: int) -> List[SimUnit]:
        return [u for u in self.units.values() if u.alive and u.team_id != team_id]

    # -- stepping ----------------------------------------------------------

    def step(self, actions: Dict[int, pb.Action]) -> None:
        """Advance one observation interval (``ticks_per_obs`` game ticks).

        ``actions`` maps player_id -> Action for agent-controlled players;
        scripted players are driven internally. An agent-controlled hero with
        no submitted action no-ops (it is never handed to the scripted bots).
        Unknown player ids are ignored.
        """
        if self.done:
            return
        dt = self.ticks_per_obs / TICKS_PER_SECOND
        n_players = len(self.heroes)
        full_actions = {
            pid: a for pid, a in actions.items() if 0 <= pid < n_players
        }
        for hero in self.heroes:
            if hero.player_id not in full_actions:
                mode = self.control_modes.get(hero.player_id, pb.CONTROL_SCRIPTED_EASY)
                if mode == pb.CONTROL_AGENT:
                    continue  # no order this interval -> no-op
                full_actions[hero.player_id] = scripted_action(
                    self, hero, mode, self.move_bins
                )

        # 1. apply orders (movement now; attack/cast intents resolved below)
        intents: Dict[int, pb.Action] = {}
        for player_id, action in full_actions.items():
            hero = self.heroes[player_id]
            if not hero.alive:
                continue
            if action.type == pb.ACTION_MOVE:
                half = (self.move_bins - 1) / 2.0
                dx = (action.move_x - half) / max(half, 1.0)
                dy = (action.move_y - half) / max(half, 1.0)
                norm = math.hypot(dx, dy)
                if norm > 1e-6:
                    scale = hero.move_speed * dt / norm
                    hero.x = float(np.clip(hero.x + dx * scale, -LANE_HALF_LENGTH, LANE_HALF_LENGTH))
                    hero.y = float(np.clip(hero.y + dy * scale, -400.0, 400.0))
            elif action.type in (pb.ACTION_ATTACK_UNIT, pb.ACTION_CAST):
                intents[player_id] = action

        # 2. hero attack / cast resolution
        for player_id, action in intents.items():
            hero = self.heroes[player_id]
            if not hero.alive:
                continue
            target = self.units.get(action.target_handle)
            if target is None or not target.alive:
                continue
            if action.type == pb.ACTION_ATTACK_UNIT:
                deny = target.team_id == hero.team_id
                if deny and not (
                    target.unit_type == pb.UNIT_LANE_CREEP
                    and target.health < 0.5 * target.health_max
                ):
                    continue  # denies only on own creeps under half HP
                if hero.dist(target) <= hero.attack_range + 50.0 and hero.attack_cooldown <= 0.0:
                    self._deal_damage(hero, target, hero.damage)
                    hero.attack_cooldown = 1.0 / ATTACKS_PER_SECOND
            else:  # ACTION_CAST
                if (
                    action.ability_slot == NUKE_SLOT
                    and hero.ability_cooldown <= 0.0
                    and hero.mana >= NUKE_MANA
                    and target.team_id != hero.team_id
                    and hero.dist(target) <= NUKE_RANGE
                ):
                    hero.mana -= NUKE_MANA
                    hero.ability_cooldown = NUKE_COOLDOWN
                    dmg = NUKE_BASE_DAMAGE + NUKE_DAMAGE_PER_LEVEL * hero.level
                    self._deal_damage(hero, target, dmg)

        # 3. creeps and towers act
        self._step_ai_units(dt)

        # 4. timers, regen, respawns, waves, win check
        self._step_clocks(dt)

    def _deal_damage(self, attacker: SimUnit, target: SimUnit, raw: float) -> None:
        target.health -= raw * _armor_multiplier(target.armor)
        if target.health <= 0.0 and target.alive:
            self._on_death(attacker, target)

    def _on_death(self, killer: SimUnit, victim: SimUnit) -> None:
        victim.alive = False
        victim.health = 0.0
        if victim.unit_type == pb.UNIT_LANE_CREEP:
            denied = killer.team_id == victim.team_id
            if killer.unit_type == pb.UNIT_HERO:
                if denied:
                    killer.denies += 1
                else:
                    killer.last_hits += 1
                    killer.gold += GOLD_PER_LASTHIT
            xp_each = CREEP_XP * (DENY_XP_FACTOR if denied else 1.0)
            enemy_heroes = [
                h for h in self.heroes
                if h.alive and h.team_id != victim.team_id
                and h.dist(victim) <= XP_RADIUS
            ]
            for h in enemy_heroes:
                self._grant_xp(h, xp_each / max(len(enemy_heroes), 1))
            del self.units[victim.handle]
        elif victim.unit_type == pb.UNIT_HERO:
            victim.deaths += 1
            if killer.unit_type == pb.UNIT_HERO:
                killer.kills += 1
                killer.gold += GOLD_PER_HERO_KILL
                self._grant_xp(killer, XP_PER_HERO_KILL)
            victim.respawn_at = self.dota_time + (
                RESPAWN_BASE_SECONDS + RESPAWN_PER_LEVEL_SECONDS * victim.level
            )
        elif victim.unit_type == pb.UNIT_TOWER:
            self.game_state = pb.GAME_STATE_POST_GAME
            self.winning_team = TEAM_RADIANT if victim.team_id == TEAM_DIRE else TEAM_DIRE

    def _grant_xp(self, hero: SimUnit, xp: float) -> None:
        hero.xp += xp
        while hero.level < MAX_LEVEL and hero.xp >= XP_PER_LEVEL * hero.level:
            hero.level += 1
            hero.health_max += 40.0
            hero.health = min(hero.health + 40.0, hero.health_max)
            hero.mana_max += 20.0
            hero.damage += 4.0

    def _step_ai_units(self, dt: float) -> None:
        for unit in list(self.units.values()):
            if not unit.alive or unit.unit_type == pb.UNIT_HERO:
                continue
            enemies = self.enemies_of(unit.team_id)
            if unit.unit_type == pb.UNIT_TOWER:
                # towers prefer creeps, then heroes, in range
                in_range = [e for e in enemies if unit.dist(e) <= unit.attack_range]
                in_range.sort(key=lambda e: (e.unit_type == pb.UNIT_HERO, unit.dist(e)))
                if in_range and unit.attack_cooldown <= 0.0:
                    self._deal_damage(unit, in_range[0], unit.damage)
                    unit.attack_cooldown = 1.0 / ATTACKS_PER_SECOND
                continue
            # lane creeps: attack nearest enemy in range else march toward
            # the enemy tower
            if not enemies:
                continue
            nearest = min(enemies, key=unit.dist)
            if unit.dist(nearest) <= unit.attack_range + 20.0:
                if unit.attack_cooldown <= 0.0:
                    self._deal_damage(unit, nearest, unit.damage)
                    unit.attack_cooldown = 1.0 / ATTACKS_PER_SECOND
            else:
                enemy_team = TEAM_DIRE if unit.team_id == TEAM_RADIANT else TEAM_RADIANT
                goal_x = TOWER_X[enemy_team]
                step = unit.move_speed * dt
                unit.x += math.copysign(min(step, abs(goal_x - unit.x)), goal_x - unit.x)

    def _step_clocks(self, dt: float) -> None:
        self.dota_time += dt
        self.tick += self.ticks_per_obs
        for unit in self.units.values():
            unit.attack_cooldown = max(0.0, unit.attack_cooldown - dt)
            unit.ability_cooldown = max(0.0, unit.ability_cooldown - dt)
            if unit.unit_type == pb.UNIT_HERO and unit.alive:
                unit.gold += GOLD_PASSIVE_PER_SEC * dt
                unit.health = min(unit.health + 1.5 * dt, unit.health_max)
                unit.mana = min(unit.mana + 1.0 * dt, unit.mana_max)
        for hero in self.heroes:
            if not hero.alive and 0.0 <= hero.respawn_at <= self.dota_time:
                hero.alive = True
                hero.health = hero.health_max
                hero.mana = hero.mana_max
                hero.x, hero.y = self._hero_spawn_pos(hero.team_id, hero.player_id)
                hero.respawn_at = -1.0
        if self.dota_time >= self._next_wave_at and not self.done:
            self._spawn_wave()
        if self.dota_time >= self.max_dota_time and not self.done:
            self.game_state = pb.GAME_STATE_POST_GAME
            # timeout adjudication: tower HP, then kills, then gold
            def score(team: int) -> tuple:
                return (
                    self.towers[team].health,
                    sum(h.kills for h in self.heroes if h.team_id == team),
                    sum(h.gold for h in self.heroes if h.team_id == team),
                )
            r, d = score(TEAM_RADIANT), score(TEAM_DIRE)
            self.winning_team = TEAM_RADIANT if r > d else TEAM_DIRE if d > r else 0

    # -- proto export ------------------------------------------------------

    def world_state(self, team_id: int) -> pb.WorldState:
        ws = pb.WorldState(
            team_id=team_id,
            game_time=self.dota_time,
            dota_time=self.dota_time,
            tick=self.tick,
            game_state=self.game_state,
            winning_team=self.winning_team,
        )
        for unit in self.units.values():
            # dead heroes stay in the worldstate with is_alive=False (as in
            # Valve's CMsgBotWorldState); dead creeps/towers are removed
            if not unit.alive and unit.unit_type != pb.UNIT_HERO:
                continue
            u = ws.units.add(
                handle=unit.handle, unit_type=unit.unit_type, team_id=unit.team_id,
                player_id=unit.player_id, hero_id=unit.hero_id,
                health=unit.health, health_max=unit.health_max,
                mana=unit.mana, mana_max=unit.mana_max, is_alive=unit.alive,
                level=unit.level, attack_damage=unit.damage,
                attack_range=unit.attack_range, armor=unit.armor,
                movement_speed=unit.move_speed, last_hits=unit.last_hits,
                denies=unit.denies,
            )
            u.location.x = unit.x
            u.location.y = unit.y
            if unit.unit_type == pb.UNIT_HERO:
                u.abilities.add(
                    slot=NUKE_SLOT, ability_id=1,
                    cooldown_remaining=unit.ability_cooldown,
                    level=unit.level,
                    castable=(unit.ability_cooldown <= 0.0 and unit.mana >= NUKE_MANA),
                    cast_range=NUKE_RANGE,
                )
        for hero in self.heroes:
            ws.players.add(
                player_id=hero.player_id, team_id=hero.team_id,
                hero_id=hero.hero_id, kills=hero.kills, deaths=hero.deaths,
                gold=hero.gold, xp=hero.xp,
            )
        return ws


# ---------------------------------------------------------------------------
# Scripted opponents (the "hard bot" the win-rate metric runs against,
# BASELINE.json:2)
# ---------------------------------------------------------------------------


def scripted_action(sim: LaneSim, hero: SimUnit, mode: int, move_bins: int = 9) -> pb.Action:
    """Deterministic bot controller. EASY marches and attacks the nearest
    enemy; HARD adds last-hit timing, low-HP retreat, and nuke usage."""
    action = pb.Action(player_id=hero.player_id, type=pb.ACTION_NOOP)
    if not hero.alive:
        return action
    enemies = sim.enemies_of(hero.team_id)
    hard = mode == pb.CONTROL_SCRIPTED_HARD
    enemy_heroes = [e for e in enemies if e.unit_type == pb.UNIT_HERO]

    if hard and hero.health < 0.3 * hero.health_max and any(
        hero.dist(e) <= 900.0 for e in enemy_heroes
    ):
        return _move_toward(hero, TOWER_X[hero.team_id], 0.0, move_bins)

    if hard and hero.mana >= NUKE_MANA and hero.ability_cooldown <= 0.0:
        nukable = [e for e in enemy_heroes if hero.dist(e) <= NUKE_RANGE]
        if nukable:
            target = min(nukable, key=lambda e: e.health)
            return pb.Action(
                player_id=hero.player_id, type=pb.ACTION_CAST,
                target_handle=target.handle, ability_slot=NUKE_SLOT,
            )

    in_range = [e for e in enemies if hero.dist(e) <= hero.attack_range + 50.0]
    if in_range:
        if hard:
            # last-hit discipline: prefer creeps that this attack would kill
            killable = [
                e for e in in_range
                if e.unit_type == pb.UNIT_LANE_CREEP
                and e.health <= hero.damage * _armor_multiplier(e.armor)
            ]
            if killable:
                return _attack(hero, min(killable, key=lambda e: e.health))
            # harass the enemy hero when healthier, otherwise pressure the
            # lowest-HP creep so the lane doesn't push into us
            heroes_in_range = [e for e in in_range if e.unit_type == pb.UNIT_HERO]
            if heroes_in_range and hero.health >= 0.5 * hero.health_max:
                return _attack(hero, min(heroes_in_range, key=lambda e: e.health))
            creeps_in_range = [e for e in in_range if e.unit_type == pb.UNIT_LANE_CREEP]
            if creeps_in_range:
                return _attack(hero, min(creeps_in_range, key=lambda e: e.health))
            return _attack(hero, min(in_range, key=hero.dist))
        return _attack(hero, min(in_range, key=hero.dist))

    # nothing in range: march toward mid / nearest enemy
    if enemies:
        nearest = min(enemies, key=hero.dist)
        return _move_toward(hero, nearest.x, nearest.y, move_bins)
    return _move_toward(hero, 0.0, 0.0, move_bins)


def _attack(hero: SimUnit, target: SimUnit) -> pb.Action:
    return pb.Action(
        player_id=hero.player_id, type=pb.ACTION_ATTACK_UNIT,
        target_handle=target.handle,
    )


def _move_toward(hero: SimUnit, x: float, y: float, move_bins: int) -> pb.Action:
    half = (move_bins - 1) / 2.0
    dx, dy = x - hero.x, y - hero.y
    norm = math.hypot(dx, dy)
    if norm < 1e-6:
        return pb.Action(player_id=hero.player_id, type=pb.ACTION_NOOP)
    mx = int(round(half + half * dx / norm))
    my = int(round(half + half * dy / norm))
    return pb.Action(
        player_id=hero.player_id, type=pb.ACTION_MOVE,
        move_x=int(np.clip(mx, 0, move_bins - 1)),
        move_y=int(np.clip(my, 0, move_bins - 1)),
    )

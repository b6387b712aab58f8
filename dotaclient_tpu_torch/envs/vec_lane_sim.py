"""The numpy lane simulator: N games stepped as arrays on the host.

A copy of ``dotaclient_tpu/envs/vec_lane_sim.py``, numpy only, reading the
rule constants of ``envs/lane_sim.py``: ``draft_games`` (hero picks and
control modes), ``apply_anchor_games`` (league anchor games),
``VecSimSpec`` (the static slot layout), ``VecLaneSim`` (the simulator the
host actor pool ``actor/vec_runtime.py`` steps) and
``scripted_actions_vec`` (the scripted bots). Every operation and the order
of every reduction are the reference's, so from the same seed and the same
actions the two simulators agree bit for bit. ``world_state`` exports one
game as the port's ``WorldState`` proto. The device simulator of the fused
and buffered learners is ``envs/torch_lane_sim.py``.

Layout of one game's ``max_units`` slots: heroes in ``[0, P)`` (slot ==
player id, P = 2 x team_size), the two towers (Radiant, Dire) in
``[P, P+2)``, and the creep pools after them, Radiant's half first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from dotaclient_tpu_torch.envs.lane_sim import (
    ACTION_ATTACK_UNIT,
    ACTION_CAST,
    ACTION_MOVE,
    ACTION_NOOP,
    ATTACKS_PER_SECOND,
    CONTROL_AGENT,
    CONTROL_SCRIPTED_EASY,
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
    GAME_STATE_IN_PROGRESS,
    GAME_STATE_POST_GAME,
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
from dotaclient_tpu_torch.protos import dota_pb2 as pb

_BIG = 1e9


def _armor_mult(armor: np.ndarray) -> np.ndarray:
    return 1.0 - (0.06 * armor) / (1.0 + 0.06 * armor)


OPPONENT_CONTROL = {
    "scripted_easy": CONTROL_SCRIPTED_EASY,
    "scripted_hard": CONTROL_SCRIPTED_HARD,
    "selfplay": CONTROL_AGENT,
    "league": CONTROL_AGENT,
}


def draft_games(
    n_games: int,
    team_size: int,
    hero_pool: Sequence[int],
    opponent: str,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Hero picks + control modes for a batch of games: (hero_ids [N, P],
    control_modes [N, P]). Radiant players are always agent-controlled; Dire
    control follows ``opponent``."""
    P = 2 * team_size
    rng = np.random.default_rng(seed)
    pool = np.asarray(hero_pool or (1,), np.int32)
    hero_ids = rng.choice(pool, size=(n_games, P)).astype(np.int32)
    control = np.full((n_games, P), CONTROL_AGENT, np.int32)
    control[:, team_size:] = OPPONENT_CONTROL[opponent]
    return hero_ids, control


def apply_anchor_games(
    control: np.ndarray,    # i32 [N, P] from draft_games, mutated in place
    team_size: int,
    opponent: str,
    league_cfg,             # LeagueConfig
) -> int:
    """League anchor games (``LeagueConfig.anchor_prob``): pin the opponent
    side of the first K games to the scripted anchor bot. Returns K; with
    ``anchor_prob > 0`` at least one game anchors."""
    if opponent != "league" or league_cfg.anchor_prob <= 0:
        return 0
    n = control.shape[0]
    k = max(1, int(round(league_cfg.anchor_prob * n)))
    name = league_cfg.anchor_opponent
    if name == "mixed":
        share = min(1.0, max(0.0, league_cfg.anchor_easy_share))
        # round before ceil: 0.07 * 100 == 7.0000...01 must not add a game
        n_easy = int(math.ceil(round(share * k, 9)))
        if 0.0 < share < 1.0:
            if k >= 2:
                # a fractional share asks for both bots: neither rounds to 0
                n_easy = min(k - 1, max(1, n_easy))
            else:
                # one anchor game cannot host both bots: the majority takes it
                n_easy = 1 if share >= 0.5 else 0
        control[:n_easy, team_size:] = OPPONENT_CONTROL["scripted_easy"]
        control[n_easy:k, team_size:] = OPPONENT_CONTROL["scripted_hard"]
    else:
        control[:k, team_size:] = OPPONENT_CONTROL[name]
    return k


@dataclasses.dataclass(frozen=True)
class VecSimSpec:
    """Static layout of a batch of games."""

    n_games: int
    team_size: int = 1
    max_units: int = 32          # total slots S (== ObsSpec.max_units)
    ticks_per_obs: int = 6
    max_dota_time: float = 600.0
    move_bins: int = 9

    @property
    def n_players(self) -> int:
        return 2 * self.team_size

    @property
    def tower_lo(self) -> int:
        return self.n_players

    @property
    def creep_lo(self) -> int:
        return self.n_players + 2

    @property
    def creeps_per_team(self) -> int:
        return (self.max_units - self.creep_lo) // 2


class VecLaneSim:
    """N concurrent games over shared arrays. All public state arrays have
    leading axis ``n_games``; unit-axis length is ``spec.max_units``."""

    def __init__(
        self,
        spec: VecSimSpec,
        hero_ids: np.ndarray,          # i32 [N, P] — hero per player slot
        control_modes: np.ndarray,     # i32 [N, P] — CONTROL_* per player
        seed: int = 0,
    ) -> None:
        self.spec = spec
        N, S, P = spec.n_games, spec.max_units, spec.n_players
        if spec.creeps_per_team < CREEPS_PER_WAVE:
            raise ValueError(
                f"max_units={S} leaves {spec.creeps_per_team} creep slots per "
                f"team; need at least one wave ({CREEPS_PER_WAVE})"
            )
        self.hero_ids = np.asarray(hero_ids, np.int32).reshape(N, P)
        self.control_modes = np.asarray(control_modes, np.int32).reshape(N, P)
        self._seed = seed
        self.rngs = [np.random.default_rng(seed + g) for g in range(N)]

        # unit arrays [N, S]
        self.unit_type = np.zeros((N, S), np.int32)
        self.team = np.zeros((N, S), np.int32)
        self.x = np.zeros((N, S), np.float32)
        self.y = np.zeros((N, S), np.float32)
        self.health = np.zeros((N, S), np.float32)
        self.health_max = np.ones((N, S), np.float32)
        self.mana = np.zeros((N, S), np.float32)
        self.mana_max = np.zeros((N, S), np.float32)
        self.damage = np.zeros((N, S), np.float32)
        self.attack_range = np.zeros((N, S), np.float32)
        self.move_speed = np.zeros((N, S), np.float32)
        self.armor = np.zeros((N, S), np.float32)
        self.level = np.ones((N, S), np.int32)
        self.alive = np.zeros((N, S), bool)
        self.attack_cd = np.zeros((N, S), np.float32)
        self.ability_cd = np.zeros((N, S), np.float32)
        # hero-only stats live in the hero slots of the [N, S] arrays
        self.xp = np.zeros((N, S), np.float32)
        self.gold = np.zeros((N, S), np.float32)
        self.last_hits = np.zeros((N, S), np.int32)
        self.denies = np.zeros((N, S), np.int32)
        self.kills = np.zeros((N, S), np.int32)
        self.deaths = np.zeros((N, S), np.int32)
        self.respawn_at = np.full((N, S), -1.0, np.float32)

        # game arrays [N]
        self.dota_time = np.zeros((N,), np.float32)
        self.tick = np.zeros((N,), np.int64)
        self.done = np.zeros((N,), bool)
        self.winning_team = np.zeros((N,), np.int32)
        self._next_wave_at = np.zeros((N,), np.float32)
        # scratch: marks creeps denied this death phase (reduced XP)
        self._denied_flag = np.zeros((N, S), bool)

        self.reset(np.arange(N))

    # -- lifecycle ---------------------------------------------------------

    def reset(self, games: np.ndarray, seeds: Optional[np.ndarray] = None) -> None:
        """Re-initialize the given game rows (fresh episode)."""
        games = np.atleast_1d(np.asarray(games, np.int64))
        if games.size == 0:
            return
        spec = self.spec
        P, S = spec.n_players, spec.max_units
        if seeds is not None:
            for g, s in zip(games, np.atleast_1d(seeds)):
                self.rngs[int(g)] = np.random.default_rng(int(s))

        for arr in (
            self.unit_type, self.team, self.x, self.y, self.health,
            self.mana, self.mana_max, self.damage, self.attack_range,
            self.move_speed, self.armor, self.xp, self.gold,
            self.attack_cd, self.ability_cd,
        ):
            arr[games] = 0
        self.health_max[games] = 1.0
        self.level[games] = 1
        self.alive[games] = False
        self.last_hits[games] = 0
        self.denies[games] = 0
        self.kills[games] = 0
        self.deaths[games] = 0
        self.respawn_at[games] = -1.0
        self.dota_time[games] = 0.0
        self.tick[games] = 0
        self.done[games] = False
        self.winning_team[games] = 0

        # heroes: slot == player_id; Radiant players first, then Dire
        # (matches scalar-sim pick order built by ``build_game_config``).
        stats = np.array(
            [HERO_STATS.get(int(h), GENERIC_HERO)
             for h in self.hero_ids[games].ravel()],
            np.float32,
        ).reshape(len(games), P, 6)
        pslots = np.arange(P)
        team_row = np.where(pslots < spec.team_size, TEAM_RADIANT, TEAM_DIRE)
        side = np.where(team_row == TEAM_RADIANT, -1.0, 1.0)
        gi = games[:, None]
        self.unit_type[gi, pslots] = UNIT_HERO
        self.team[gi, pslots] = team_row
        self.x[gi, pslots] = side * (LANE_HALF_LENGTH - 300.0)
        self.y[gi, pslots] = 60.0 * (pslots % 5)
        self.health[gi, pslots] = stats[..., 0]
        self.health_max[gi, pslots] = stats[..., 0]
        self.mana[gi, pslots] = stats[..., 1]
        self.mana_max[gi, pslots] = stats[..., 1]
        self.damage[gi, pslots] = stats[..., 2]
        self.attack_range[gi, pslots] = stats[..., 3]
        self.move_speed[gi, pslots] = stats[..., 4]
        self.armor[gi, pslots] = stats[..., 5]
        self.alive[gi, pslots] = True

        # towers
        for k, team in enumerate((TEAM_RADIANT, TEAM_DIRE)):
            t = spec.tower_lo + k
            self.unit_type[games, t] = UNIT_TOWER
            self.team[games, t] = team
            self.x[games, t] = TOWER_X[team]
            self.y[games, t] = 0.0
            self.health[games, t] = TOWER_HP
            self.health_max[games, t] = TOWER_HP
            self.damage[games, t] = TOWER_DAMAGE
            self.attack_range[games, t] = TOWER_RANGE
            self.armor[games, t] = TOWER_ARMOR
            self.alive[games, t] = True

        self._spawn_waves(games)
        self._next_wave_at[games] = CREEP_WAVE_PERIOD

    def _creep_pool(self, team: int) -> np.ndarray:
        spec = self.spec
        lo = spec.creep_lo + (0 if team == TEAM_RADIANT else spec.creeps_per_team)
        return np.arange(lo, lo + spec.creeps_per_team)

    def _spawn_waves(self, games: np.ndarray) -> None:
        """Spawn one creep wave per team in each given game, claiming free
        slots in the team's pool (bounded — overflow creeps are skipped)."""
        spec = self.spec
        for team in (TEAM_RADIANT, TEAM_DIRE):
            pool = self._creep_pool(team)
            sign = 1.0 if team == TEAM_RADIANT else -1.0
            free = ~self.alive[np.ix_(games, pool)]              # [G, C]
            # rank free slots: k-th free slot gets wave position k
            order = np.cumsum(free, axis=1) - 1                  # [G, C]
            take = free & (order < CREEPS_PER_WAVE)
            g_idx, c_idx = np.nonzero(take)
            slots = pool[c_idx]
            rows = games[g_idx]
            k = order[g_idx, c_idx].astype(np.float32)
            self.unit_type[rows, slots] = UNIT_LANE_CREEP
            self.team[rows, slots] = team
            self.x[rows, slots] = TOWER_X[team] + sign * (250.0 + 40.0 * k)
            jitter = np.array(
                [self.rngs[int(r)].uniform(-40.0, 40.0) for r in rows],
                np.float32,
            )
            self.y[rows, slots] = jitter
            self.health[rows, slots] = CREEP_HP
            self.health_max[rows, slots] = CREEP_HP
            self.damage[rows, slots] = CREEP_DAMAGE
            self.attack_range[rows, slots] = CREEP_RANGE
            self.move_speed[rows, slots] = CREEP_SPEED
            self.armor[rows, slots] = CREEP_ARMOR
            self.level[rows, slots] = 1
            self.alive[rows, slots] = True
            self.attack_cd[rows, slots] = 0.0

    # -- derived views -----------------------------------------------------

    @property
    def n_games(self) -> int:
        return self.spec.n_games

    def tower_slot(self, team: int) -> int:
        return self.spec.tower_lo + (0 if team == TEAM_RADIANT else 1)

    def player_team(self, player: int) -> int:
        return TEAM_RADIANT if player < self.spec.team_size else TEAM_DIRE

    def hero_castable(self) -> np.ndarray:
        """bool [N, S]: unit has the nuke off cooldown with mana (heroes)."""
        return (
            (self.unit_type == UNIT_HERO)
            & (self.ability_cd <= 0.0)
            & (self.mana >= NUKE_MANA)
        )

    def _pairwise_dist(self) -> np.ndarray:
        """f32 [N, S, S] — distance between every slot pair."""
        dx = self.x[:, :, None] - self.x[:, None, :]
        dy = self.y[:, :, None] - self.y[:, None, :]
        return np.hypot(dx, dy)

    # -- stepping ----------------------------------------------------------

    def step(self, actions: Dict[str, np.ndarray]) -> None:
        """Advance every non-done game one observation interval.

        ``actions`` arrays are [N, P] int32: ``type``, ``move_x``, ``move_y``,
        ``target_slot`` (sim slot index), ``ability``. Players whose
        ``control_modes`` is scripted are driven internally, overriding the
        given arrays; CONTROL_AGENT players no-op when ``type`` < 0.
        """
        spec = self.spec
        N, S, P = spec.n_games, spec.max_units, spec.n_players
        live_games = ~self.done                                  # [N]
        dt = spec.ticks_per_obs / TICKS_PER_SECOND

        dist = self._pairwise_dist()
        a_type = np.where(
            actions["type"] < 0, ACTION_NOOP, actions["type"]
        ).astype(np.int32).copy()
        move_x = actions["move_x"].astype(np.int32).copy()
        move_y = actions["move_y"].astype(np.int32).copy()
        target = actions["target_slot"].astype(np.int64).copy()
        ability = actions["ability"].astype(np.int32).copy()

        scripted = self.control_modes != CONTROL_AGENT        # [N, P]
        if scripted.any():
            sa = scripted_actions_vec(self, dist)
            for name, dst in (
                ("type", a_type), ("move_x", move_x), ("move_y", move_y),
                ("target_slot", target), ("ability", ability),
            ):
                np.copyto(dst, sa[name], where=scripted)

        pslots = np.arange(P)
        hero_alive = self.alive[:, :P] & live_games[:, None]     # [N, P]
        target = np.clip(target, 0, S - 1)

        # 1. movement
        half = (spec.move_bins - 1) / 2.0
        moving = hero_alive & (a_type == ACTION_MOVE)
        mdx = (move_x - half) / max(half, 1.0)
        mdy = (move_y - half) / max(half, 1.0)
        norm = np.hypot(mdx, mdy)
        ok = moving & (norm > 1e-6)
        scale = np.where(ok, self.move_speed[:, :P] * dt / np.maximum(norm, 1e-9), 0.0)
        self.x[:, :P] = np.where(
            ok,
            np.clip(self.x[:, :P] + mdx * scale, -LANE_HALF_LENGTH, LANE_HALF_LENGTH),
            self.x[:, :P],
        )
        self.y[:, :P] = np.where(
            ok, np.clip(self.y[:, :P] + mdy * scale, -400.0, 400.0), self.y[:, :P]
        )

        # 2. hero attacks / casts (phase A: heroes resolve before AI units,
        # as in the scalar sim's step ordering)
        tgt_dist = dist[np.arange(N)[:, None], pslots[None, :], target]  # [N, P]
        t_alive = self.alive[np.arange(N)[:, None], target]
        t_team = self.team[np.arange(N)[:, None], target]
        t_type = self.unit_type[np.arange(N)[:, None], target]
        t_hp = self.health[np.arange(N)[:, None], target]
        t_hpmax = self.health_max[np.arange(N)[:, None], target]
        my_team = self.team[:, :P]

        is_deny = (t_team == my_team) & (t_type == UNIT_LANE_CREEP) & (
            t_hp < 0.5 * t_hpmax
        )
        attack_ok = (
            hero_alive
            & (a_type == ACTION_ATTACK_UNIT)
            & t_alive
            & ((t_team != my_team) | is_deny)
            & (tgt_dist <= self.attack_range[:, :P] + 50.0)
            & (self.attack_cd[:, :P] <= 0.0)
        )
        cast_ok = (
            hero_alive
            & (a_type == ACTION_CAST)
            & (ability == NUKE_SLOT)
            & t_alive
            & (t_team != my_team)
            & (tgt_dist <= NUKE_RANGE)
            & (self.ability_cd[:, :P] <= 0.0)
            & (self.mana[:, :P] >= NUKE_MANA)
        )
        self.attack_cd[:, :P] = np.where(
            attack_ok, 1.0 / ATTACKS_PER_SECOND, self.attack_cd[:, :P]
        )
        self.mana[:, :P] = np.where(cast_ok, self.mana[:, :P] - NUKE_MANA, self.mana[:, :P])
        self.ability_cd[:, :P] = np.where(cast_ok, NUKE_COOLDOWN, self.ability_cd[:, :P])

        raw = np.where(attack_ok, self.damage[:, :P], 0.0) + np.where(
            cast_ok,
            NUKE_BASE_DAMAGE + NUKE_DAMAGE_PER_LEVEL * self.level[:, :P],
            0.0,
        )
        dmg = np.zeros((N, S), np.float32)
        hit = attack_ok | cast_ok
        t_armor_mult = _armor_mult(self.armor[np.arange(N)[:, None], target])
        np.add.at(dmg, (np.nonzero(hit)[0], target[hit]), (raw * t_armor_mult)[hit])
        self._resolve_deaths(dmg, hit, target, is_deny & attack_ok, dist)

        # 3. creeps and towers act (phase B)
        self._step_ai(dist, dt, live_games)

        # 4. clocks, regen, respawn, waves, win/timeout
        self._step_clocks(dt, live_games)

    # -- internals ---------------------------------------------------------

    def _resolve_deaths(
        self,
        dmg: np.ndarray,               # accumulated damage [N, S]
        hero_hit: Optional[np.ndarray],    # [N, P] attacks that landed
        hero_target: Optional[np.ndarray], # [N, P] their sim-slot targets
        hero_deny: Optional[np.ndarray],   # [N, P] deny-attacks that landed
        dist: np.ndarray,              # [N, S, S]
    ) -> None:
        """Apply accumulated damage, then process deaths: credit, gold/XP,
        respawn timers, tower game-over."""
        spec = self.spec
        N, S, P = spec.n_games, spec.max_units, spec.n_players
        pre_alive = self.alive.copy()
        self.health = np.where(pre_alive, self.health - dmg, self.health).astype(np.float32)
        died = pre_alive & (self.health <= 0.0)
        if not died.any():
            return
        self.health = np.where(died, 0.0, self.health)
        self.alive &= ~died

        died_creep = died & (self.unit_type == UNIT_LANE_CREEP)
        died_hero = died & (self.unit_type == UNIT_HERO)
        died_tower = died & (self.unit_type == UNIT_TOWER)

        # Kill credit (hero attackers only): lowest player index whose landed
        # attack targeted the dead unit this phase.
        if hero_hit is not None and (died_creep.any() or died_hero.any()):
            # landed[n, p] targeting slot s that died
            t_died = died[np.arange(N)[:, None], hero_target] & hero_hit  # [N, P]
            # For each dead unit slot, find min p among attackers of that slot.
            cn, cp = np.nonzero(t_died)
            cs = hero_target[cn, cp]
            # iterate only over landed kill credits (rare)
            seen = set()
            for n_, p_, s_ in zip(cn, cp, cs):
                if (n_, s_) in seen:
                    continue  # lowest p wins (np.nonzero is row-major sorted)
                seen.add((n_, s_))
                if self.unit_type[n_, s_] == UNIT_LANE_CREEP:
                    if hero_deny is not None and hero_deny[n_, p_] and (
                        hero_target[n_, p_] == s_
                    ):
                        self.denies[n_, p_] += 1
                        # deny marker: enemies get reduced XP (handled below
                        # via denied mask)
                        self._denied_flag[n_, s_] = True
                    else:
                        self.last_hits[n_, p_] += 1
                        self.gold[n_, p_] += GOLD_PER_LASTHIT
                elif self.unit_type[n_, s_] == UNIT_HERO:
                    self.kills[n_, p_] += 1
                    self.gold[n_, p_] += GOLD_PER_HERO_KILL
                    self._grant_xp_slots(
                        np.array([n_]), np.array([p_]),
                        np.array([XP_PER_HERO_KILL], np.float32),
                    )

        # Creep XP: enemy heroes within XP_RADIUS of the dying creep split it.
        if died_creep.any():
            dn, dslot = np.nonzero(died_creep)
            denied = self._denied_flag[dn, dslot]
            xp_each = np.where(denied, CREEP_XP * DENY_XP_FACTOR, CREEP_XP)
            hero_d = dist[dn, :, dslot][:, :P]                   # [D, P]
            hero_ok = (
                self.alive[dn, :P]
                & (self.team[dn, :P] != self.team[dn, dslot][:, None])
                & (hero_d <= XP_RADIUS)
            )
            n_share = hero_ok.sum(axis=1)
            share = xp_each / np.maximum(n_share, 1)
            rn, rp = np.nonzero(hero_ok)
            self._grant_xp_slots(dn[rn], rp, share[rn].astype(np.float32))
            self._denied_flag[dn, dslot] = False

        # Hero deaths: respawn timer.
        if died_hero.any():
            hn, hslot = np.nonzero(died_hero)
            self.deaths[hn, hslot] += 1
            self.respawn_at[hn, hslot] = self.dota_time[hn] + (
                RESPAWN_BASE_SECONDS
                + RESPAWN_PER_LEVEL_SECONDS * self.level[hn, hslot]
            )

        # Tower death ends the game.
        if died_tower.any():
            tn, tslot = np.nonzero(died_tower)
            self.done[tn] = True
            self.winning_team[tn] = np.where(
                self.team[tn, tslot] == TEAM_DIRE, TEAM_RADIANT, TEAM_DIRE
            )

    def _grant_xp_slots(
        self, games: np.ndarray, players: np.ndarray, xp: np.ndarray
    ) -> None:
        """Accumulate XP on hero slots and apply level-ups (vector form of the
        scalar sim's ``_grant_xp`` while-loop: level = 1 + floor(xp/220),
        capped; each level grants +40 maxHP/+heal, +20 maxMana, +4 damage)."""
        np.add.at(self.xp, (games, players), xp)
        # Level-ups are computed on UNIQUE (game, player) pairs from total XP
        # — with duplicates in one call (two creeps dying at once), per-entry
        # deltas would each see the same full XP jump and double-apply.
        S = self.spec.max_units
        uniq = np.unique(games.astype(np.int64) * S + players)
        gu, pu = uniq // S, uniq % S
        cur = self.level[gu, pu]
        new = np.minimum(
            MAX_LEVEL, (self.xp[gu, pu] // XP_PER_LEVEL).astype(np.int32) + 1
        )
        gained = np.maximum(new - cur, 0)
        if not gained.any():
            return
        g = gained.astype(np.float32)
        self.level[gu, pu] = np.maximum(cur, new)
        self.health_max[gu, pu] += 40.0 * g
        self.health[gu, pu] = np.minimum(
            self.health[gu, pu] + 40.0 * g, self.health_max[gu, pu]
        )
        self.mana_max[gu, pu] += 20.0 * g
        self.damage[gu, pu] += 4.0 * g

    def _step_ai(self, dist: np.ndarray, dt: float, live: np.ndarray) -> None:
        """Creeps attack/march, towers attack (phase-start world)."""
        spec = self.spec
        N, S, P = spec.n_games, spec.max_units, spec.n_players
        alive = self.alive & live[:, None]
        enemy = (
            alive[:, :, None]
            & alive[:, None, :]
            & (self.team[:, :, None] != self.team[:, None, :])
        )                                                       # [N, S, S]
        d_masked = np.where(enemy, dist, _BIG)

        is_creep = (self.unit_type == UNIT_LANE_CREEP) & alive
        is_tower = (self.unit_type == UNIT_TOWER) & alive

        # creeps: nearest enemy within range+20 → attack; else march in x
        nearest = d_masked.argmin(axis=2)                        # [N, S]
        nearest_d = np.take_along_axis(d_masked, nearest[:, :, None], 2)[:, :, 0]
        can_attack = is_creep & (nearest_d <= self.attack_range + 20.0)
        attacking = can_attack & (self.attack_cd <= 0.0)
        # towers: among IN-RANGE enemies, prefer creeps over heroes, then
        # nearest (the scalar sim filters to range first — an out-of-range
        # creep must not shadow an in-range hero)
        in_tower_range = d_masked <= self.attack_range[:, :, None]
        t_pref = np.where(
            in_tower_range,
            d_masked
            + np.where(self.unit_type[:, None, :] == UNIT_HERO, 1e6, 0.0),
            _BIG * 2.0,
        )
        t_near = t_pref.argmin(axis=2)
        t_has_target = t_pref.min(axis=2) < _BIG
        t_attacking = is_tower & t_has_target & (self.attack_cd <= 0.0)

        atk = attacking | t_attacking
        tgt = np.where(t_attacking, t_near, nearest)
        self.attack_cd = np.where(atk, 1.0 / ATTACKS_PER_SECOND, self.attack_cd)
        dmg = np.zeros((N, S), np.float32)
        an, aslot = np.nonzero(atk)
        at = tgt[an, aslot]
        np.add.at(
            dmg, (an, at),
            self.damage[an, aslot] * _armor_mult(self.armor[an, at]),
        )
        self._resolve_deaths(dmg, None, None, None, dist)

        # march: creeps not in attack range move toward enemy tower (x only)
        marching = is_creep & ~can_attack & self.alive
        goal_x = np.where(self.team == TEAM_RADIANT, TOWER_X[TEAM_DIRE], TOWER_X[TEAM_RADIANT])
        step = self.move_speed * dt
        delta = goal_x - self.x
        self.x = np.where(
            marching,
            self.x + np.sign(delta) * np.minimum(step, np.abs(delta)),
            self.x,
        ).astype(np.float32)

    def _step_clocks(self, dt: float, live: np.ndarray) -> None:
        spec = self.spec
        P = spec.n_players
        self.dota_time = np.where(live, self.dota_time + dt, self.dota_time)
        self.tick = np.where(live, self.tick + spec.ticks_per_obs, self.tick)
        self.attack_cd = np.maximum(0.0, self.attack_cd - dt * live[:, None]).astype(np.float32)
        self.ability_cd = np.maximum(0.0, self.ability_cd - dt * live[:, None]).astype(np.float32)

        hero_alive = (self.unit_type == UNIT_HERO) & self.alive & live[:, None]
        self.gold = np.where(hero_alive, self.gold + GOLD_PASSIVE_PER_SEC * dt, self.gold)
        self.health = np.where(
            hero_alive, np.minimum(self.health + 1.5 * dt, self.health_max), self.health
        ).astype(np.float32)
        self.mana = np.where(
            hero_alive, np.minimum(self.mana + 1.0 * dt, self.mana_max), self.mana
        ).astype(np.float32)

        # respawns
        hero_dead = (
            (self.unit_type == UNIT_HERO) & ~self.alive & live[:, None]
            & (self.respawn_at >= 0.0)
            & (self.respawn_at <= self.dota_time[:, None])
        )
        if hero_dead.any():
            rn, rp = np.nonzero(hero_dead)
            self.alive[rn, rp] = True
            self.health[rn, rp] = self.health_max[rn, rp]
            self.mana[rn, rp] = self.mana_max[rn, rp]
            team_r = self.team[rn, rp]
            side = np.where(team_r == TEAM_RADIANT, -1.0, 1.0)
            self.x[rn, rp] = side * (LANE_HALF_LENGTH - 300.0)
            self.y[rn, rp] = 60.0 * (rp % 5)
            self.respawn_at[rn, rp] = -1.0

        # waves
        wave_due = live & ~self.done & (self.dota_time >= self._next_wave_at)
        if wave_due.any():
            games = np.nonzero(wave_due)[0]
            self._spawn_waves(games)
            self._next_wave_at[games] = self.dota_time[games] + CREEP_WAVE_PERIOD

        # timeout adjudication: (tower hp, team kills, team gold) lexicographic
        timed_out = live & ~self.done & (self.dota_time >= spec.max_dota_time)
        if timed_out.any():
            g = np.nonzero(timed_out)[0]
            self.done[g] = True
            r_slot, d_slot = self.tower_slot(TEAM_RADIANT), self.tower_slot(TEAM_DIRE)
            team_row = self.team[g, :P]
            is_rad = team_row == TEAM_RADIANT

            def team_sum(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
                h = arr[g, :P].astype(np.float64)
                return (h * is_rad).sum(1), (h * ~is_rad).sum(1)

            rk, dk = team_sum(self.kills)
            rg, dg = team_sum(self.gold)
            rt = self.health[g, r_slot].astype(np.float64)
            dt_ = self.health[g, d_slot].astype(np.float64)
            r_wins = (rt > dt_) | ((rt == dt_) & ((rk > dk) | ((rk == dk) & (rg > dg))))
            d_wins = (dt_ > rt) | ((rt == dt_) & ((dk > rk) | ((rk == dk) & (dg > rg))))
            self.winning_team[g] = np.where(
                r_wins, TEAM_RADIANT, np.where(d_wins, TEAM_DIRE, 0)
            )

    # -- proto export (parity/debug boundary, not the hot path) ------------

    def world_state(self, game: int, team_id: int) -> pb.WorldState:
        """Export one game's view as a WorldState proto (same shape the
        scalar sim emits — used by parity tests and debugging)."""
        g = int(game)
        spec = self.spec
        ws = pb.WorldState(
            team_id=team_id,
            game_time=float(self.dota_time[g]),
            dota_time=float(self.dota_time[g]),
            tick=int(self.tick[g]),
            game_state=(
                GAME_STATE_POST_GAME if self.done[g] else GAME_STATE_IN_PROGRESS
            ),
            winning_team=int(self.winning_team[g]),
        )
        for s in range(spec.max_units):
            ut = int(self.unit_type[g, s])
            if ut == 0:
                continue
            if not self.alive[g, s] and ut != UNIT_HERO:
                continue
            u = ws.units.add(
                handle=s + 1, unit_type=ut, team_id=int(self.team[g, s]),
                player_id=s if s < spec.n_players else -1,
                hero_id=int(self.hero_ids[g, s]) if s < spec.n_players else 0,
                health=float(self.health[g, s]),
                health_max=float(self.health_max[g, s]),
                mana=float(self.mana[g, s]), mana_max=float(self.mana_max[g, s]),
                is_alive=bool(self.alive[g, s]), level=int(self.level[g, s]),
                attack_damage=float(self.damage[g, s]),
                attack_range=float(self.attack_range[g, s]),
                armor=float(self.armor[g, s]),
                movement_speed=float(self.move_speed[g, s]),
                last_hits=int(self.last_hits[g, s]), denies=int(self.denies[g, s]),
            )
            u.location.x = float(self.x[g, s])
            u.location.y = float(self.y[g, s])
            if ut == UNIT_HERO:
                u.abilities.add(
                    slot=NUKE_SLOT, ability_id=1,
                    cooldown_remaining=float(self.ability_cd[g, s]),
                    level=int(self.level[g, s]),
                    castable=bool(
                        self.ability_cd[g, s] <= 0.0 and self.mana[g, s] >= NUKE_MANA
                    ),
                    cast_range=NUKE_RANGE,
                )
        for p in range(spec.n_players):
            ws.players.add(
                player_id=p, team_id=int(self.team[g, p]),
                hero_id=int(self.hero_ids[g, p]), kills=int(self.kills[g, p]),
                deaths=int(self.deaths[g, p]), gold=float(self.gold[g, p]),
                xp=float(self.xp[g, p]),
            )
        return ws


# ---------------------------------------------------------------------------
# Vectorized scripted opponents (same decision rules as lane_sim.scripted_action)
# ---------------------------------------------------------------------------


def scripted_actions_vec(sim: VecLaneSim, dist: np.ndarray) -> Dict[str, np.ndarray]:
    """Compute scripted-bot actions for every player slot of every game.

    Vector form of ``lane_sim.scripted_action`` — EASY marches/attacks the
    nearest enemy; HARD adds low-HP retreat, nuke on the lowest-HP enemy hero
    in range, last-hit timing, and harass. Rows for CONTROL_AGENT players are
    computed too but ignored by the caller (cheaper than masking here).
    """
    spec = sim.spec
    N, S, P = spec.n_games, spec.max_units, spec.n_players
    pslots = np.arange(P)
    half = (spec.move_bins - 1) / 2.0

    my_team = sim.team[:, :P]                                    # [N, P]
    hard = sim.control_modes == CONTROL_SCRIPTED_HARD
    hero_alive = sim.alive[:, :P]
    hp_frac = sim.health[:, :P] / np.maximum(sim.health_max[:, :P], 1.0)

    enemy = (
        sim.alive[:, None, :]
        & (sim.team[:, None, :] != my_team[:, :, None])
    )                                                            # [N, P, S]
    pd = dist[:, :P, :]                                          # [N, P, S]
    d_enemy = np.where(enemy, pd, _BIG)

    is_hero_s = sim.unit_type == UNIT_HERO                    # [N, S]
    is_creep_s = sim.unit_type == UNIT_LANE_CREEP
    enemy_hero = enemy & is_hero_s[:, None, :]
    d_ehero = np.where(enemy_hero, pd, _BIG)

    out_type = np.full((N, P), ACTION_NOOP, np.int32)
    out_mx = np.zeros((N, P), np.int32)
    out_my = np.zeros((N, P), np.int32)
    out_tgt = np.zeros((N, P), np.int64)
    out_abl = np.zeros((N, P), np.int32)

    def set_move(mask: np.ndarray, gx: np.ndarray, gy: np.ndarray) -> None:
        """Discretized move-toward for masked (game, player) rows."""
        dx = gx - sim.x[:, :P]
        dy = gy - sim.y[:, :P]
        norm = np.hypot(dx, dy)
        ok = mask & (norm >= 1e-6)
        mx = np.clip(np.round(half + half * dx / np.maximum(norm, 1e-9)), 0, spec.move_bins - 1)
        my = np.clip(np.round(half + half * dy / np.maximum(norm, 1e-9)), 0, spec.move_bins - 1)
        out_type[ok] = ACTION_MOVE
        out_mx[ok] = mx[ok].astype(np.int32)
        out_my[ok] = my[ok].astype(np.int32)

    todo = hero_alive.copy()

    # HARD retreat: hp < 30% and an enemy hero within 900 → run to own tower.
    near_ehero = (d_ehero.min(axis=2) <= 900.0)
    retreat = todo & hard & (hp_frac < 0.3) & near_ehero
    own_tower_x = np.where(my_team == TEAM_RADIANT, TOWER_X[TEAM_RADIANT], TOWER_X[TEAM_DIRE])
    set_move(retreat, own_tower_x, np.zeros_like(own_tower_x))
    todo &= ~retreat

    # HARD nuke: castable and an enemy hero within NUKE_RANGE → lowest HP.
    castable = (sim.mana[:, :P] >= NUKE_MANA) & (sim.ability_cd[:, :P] <= 0.0)
    nukable = enemy_hero & (pd <= NUKE_RANGE)
    hp_key = np.where(nukable, sim.health[:, None, :], _BIG)
    nuke_tgt = hp_key.argmin(axis=2)
    can_nuke = todo & hard & castable & nukable.any(axis=2)
    out_type[can_nuke] = ACTION_CAST
    out_tgt[can_nuke] = nuke_tgt[can_nuke]
    out_abl[can_nuke] = NUKE_SLOT
    todo &= ~can_nuke

    in_range = enemy & (pd <= sim.attack_range[:, :P, None] + 50.0)  # [N,P,S]
    any_in_range = in_range.any(axis=2)

    # HARD last-hit: killable creep in range (health <= my damage after armor).
    eff_dmg = sim.damage[:, :P, None] * _armor_mult(sim.armor[:, None, :])
    killable = in_range & is_creep_s[:, None, :] & (sim.health[:, None, :] <= eff_dmg)
    kill_key = np.where(killable, sim.health[:, None, :], _BIG)
    kill_tgt = kill_key.argmin(axis=2)
    do_lh = todo & hard & killable.any(axis=2)
    out_type[do_lh] = ACTION_ATTACK_UNIT
    out_tgt[do_lh] = kill_tgt[do_lh]
    todo &= ~do_lh

    # HARD harass: enemy hero in range while healthy → lowest-HP one.
    heroes_in_range = in_range & is_hero_s[:, None, :]
    harass_key = np.where(heroes_in_range, sim.health[:, None, :], _BIG)
    harass_tgt = harass_key.argmin(axis=2)
    do_harass = todo & hard & heroes_in_range.any(axis=2) & (hp_frac >= 0.5)
    out_type[do_harass] = ACTION_ATTACK_UNIT
    out_tgt[do_harass] = harass_tgt[do_harass]
    todo &= ~do_harass

    # HARD pressure: lowest-HP creep in range.
    creeps_in_range = in_range & is_creep_s[:, None, :]
    press_key = np.where(creeps_in_range, sim.health[:, None, :], _BIG)
    press_tgt = press_key.argmin(axis=2)
    do_press = todo & hard & creeps_in_range.any(axis=2)
    out_type[do_press] = ACTION_ATTACK_UNIT
    out_tgt[do_press] = press_tgt[do_press]
    todo &= ~do_press

    # EASY (and HARD fallback): attack nearest enemy in range.
    near_key = np.where(in_range, pd, _BIG)
    near_tgt = near_key.argmin(axis=2)
    do_atk = todo & any_in_range
    out_type[do_atk] = ACTION_ATTACK_UNIT
    out_tgt[do_atk] = near_tgt[do_atk]
    todo &= ~do_atk

    # nothing in range: march toward nearest enemy (or mid if none).
    nearest_any = d_enemy.argmin(axis=2)
    has_enemy = d_enemy.min(axis=2) < _BIG
    gi = np.arange(N)[:, None]
    gx = np.where(has_enemy, sim.x[gi, nearest_any], 0.0)
    gy = np.where(has_enemy, sim.y[gi, nearest_any], 0.0)
    set_move(todo, gx, gy)

    return {
        "type": out_type, "move_x": out_mx, "move_y": out_my,
        "target_slot": out_tgt, "ability": out_abl,
    }

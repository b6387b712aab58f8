"""The lane game, its observations and its shaped reward, written out from
the rules.

A batch of N games, each a row of S unit slots: the players' heroes first
(Radiant's ``team_size`` then Dire's), the two towers, then each team's pool
of creep slots. One ``step`` is one observation interval (``ticks_per_obs``
ticks at 30 a second): heroes move, attack and cast; deaths are credited to
the lowest player index whose landed attack targeted the slot; creeps and
towers pick targets from the world as it stood before the heroes moved and
attack; then clocks, regeneration, respawns, the creep wave every 30 s and
the timeout verdict. A game ends when a tower falls or its time runs out.

Randomness is the creep wave's y-jitter alone, an input here. Scripted bots
are not written out: a configuration whose players are scripted is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

RADIANT, DIRE = 2, 3
UNIT_HERO, UNIT_CREEP, UNIT_TOWER = 1, 2, 3
NOOP, MOVE, ATTACK, CAST = 0, 1, 2, 3
TICKS_PER_SECOND = 30
HALF_LANE = 2000.0
TOWER_X = {RADIANT: -HALF_LANE, DIRE: HALF_LANE}
WAVE_PERIOD = 30.0
WAVE_SIZE = 4
MAX_LEVEL = 10
XP_PER_LEVEL = 220.0
XP_RADIUS = 1200.0
DENY_XP_FACTOR = 0.3
GOLD_LASTHIT, GOLD_PER_SEC, GOLD_HERO_KILL = 40.0, 1.7, 200.0
XP_HERO_KILL = 280.0
RESPAWN_BASE, RESPAWN_PER_LEVEL = 6.0, 2.0
NUKE_MANA, NUKE_COOLDOWN, NUKE_RANGE = 50.0, 10.0, 600.0
NUKE_BASE, NUKE_PER_LEVEL = 75.0, 25.0
# hero id -> (hp, mana, damage, range, speed, armor); unknown ids are generic
HEROES = {1: (550.0, 270.0, 52.0, 500.0, 310.0, 2.0),
          2: (480.0, 360.0, 48.0, 650.0, 295.0, 1.0),
          3: (500.0, 300.0, 45.0, 550.0, 290.0, 1.5)}
GENERIC = (520.0, 300.0, 48.0, 550.0, 300.0, 1.5)
CREEP = dict(hp=550.0, damage=20.0, range=110.0, speed=325.0, armor=2.0, xp=60.0)
TOWER = dict(hp=1800.0, damage=110.0, range=700.0, armor=10.0)
BIG = 1e9
# observation scales
POS, TIME, HP, GOLD, XP, DMG, RANGE, SPEED, ARMOR, LEVEL = (
    2000.0, 600.0, 2000.0, 3000.0, 2500.0, 150.0, 700.0, 400.0, 20.0, 10.0)

FLOATS = ("x", "y", "health", "health_max", "mana", "mana_max", "damage", "attack_range", "move_speed",
          "armor", "attack_cd", "ability_cd", "xp", "gold", "respawn_at")
INTS = ("unit_type", "team", "level", "last_hits", "denies", "kills", "deaths")


@dataclasses.dataclass(frozen=True)
class Layout:
    n_games: int
    team_size: int
    max_units: int
    ticks_per_obs: int
    max_dota_time: float
    move_bins: int

    @property
    def players(self) -> int:
        return 2 * self.team_size

    @property
    def tower0(self) -> int:
        return self.players

    @property
    def creep0(self) -> int:
        return self.players + 2

    @property
    def creeps(self) -> int:
        return (self.max_units - self.creep0) // 2

    @property
    def dt(self) -> float:
        return self.ticks_per_obs / TICKS_PER_SECOND


def draft(n_games: int, team_size: int, hero_pool: Sequence[int], seed: int) -> np.ndarray:
    """Hero ids [N, P]: each slot drawn uniformly from the pool by numpy's
    generator seeded with the run seed."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.asarray(hero_pool or (1,), np.int32), size=(n_games, 2 * team_size)).astype(np.int32)


def armor_mult(armor: torch.Tensor) -> torch.Tensor:
    return 1.0 - (0.06 * armor) / (1.0 + 0.06 * armor)


def onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def with_cols(arr: torch.Tensor, lo: int, hi: int, vals) -> torch.Tensor:
    out = arr.clone()
    out[:, lo:hi] = vals
    return out


class Game:
    """The rules over a batch of games; a state is a dict of [N, S] (or
    [N]) tensors, never written into."""

    def __init__(self, lay: Layout, hero_ids: torch.Tensor) -> None:
        self.lay = lay
        self.hero_ids = hero_ids.to(torch.int32)
        self.dev = hero_ids.device
        table = torch.tensor([HEROES.get(int(h), GENERIC) for h in range(max(HEROES) + 2)], dtype=torch.float32)
        self.stats = table.to(self.dev)[self.hero_ids.long().clamp(0, table.shape[0] - 1)]   # [N, P, 6]

    # -- a fresh game --------------------------------------------------------

    def fresh(self, jitter: torch.Tensor) -> Dict[str, torch.Tensor]:
        lay, dev = self.lay, self.dev
        N, S, P = lay.n_games, lay.max_units, lay.players
        f = lambda v=0.0: torch.full((N, S), v, dtype=torch.float32, device=dev)  # noqa: E731
        i = lambda v=0: torch.full((N, S), v, dtype=torch.int32, device=dev)  # noqa: E731
        s = {k: f() for k in FLOATS}
        s.update({k: i() for k in INTS})
        s["health_max"], s["level"], s["respawn_at"] = f(1.0), i(1), f(-1.0)
        s["alive"] = torch.zeros((N, S), dtype=torch.bool, device=dev)
        pl = torch.arange(P, device=dev)
        team = torch.where(pl < lay.team_size, RADIANT, DIRE).to(torch.int32)
        side = torch.where(team == RADIANT, -1.0, 1.0)
        st = self.stats
        s["unit_type"] = with_cols(s["unit_type"], 0, P, UNIT_HERO)
        s["team"] = with_cols(s["team"], 0, P, team.expand(N, P))
        s["x"] = with_cols(s["x"], 0, P, (side * (HALF_LANE - 300.0)).expand(N, P))
        s["y"] = with_cols(s["y"], 0, P, (60.0 * (pl % 5)).float().expand(N, P))
        for k, col in (("health", 0), ("health_max", 0), ("mana", 1), ("mana_max", 1), ("damage", 2),
                       ("attack_range", 3), ("move_speed", 4), ("armor", 5)):
            s[k] = with_cols(s[k], 0, P, st[..., col])
        s["alive"] = with_cols(s["alive"], 0, P, True)
        for k, tm in enumerate((RADIANT, DIRE)):
            t = lay.tower0 + k
            for key, v in (("unit_type", UNIT_TOWER), ("team", tm), ("x", TOWER_X[tm]), ("health", TOWER["hp"]),
                           ("health_max", TOWER["hp"]), ("damage", TOWER["damage"]),
                           ("attack_range", TOWER["range"]), ("armor", TOWER["armor"]), ("alive", True)):
                s[key] = with_cols(s[key], t, t + 1, v)
        s["dota_time"] = torch.zeros((N,), dtype=torch.float32, device=dev)
        s["tick"] = torch.zeros((N,), dtype=torch.int32, device=dev)
        s["done"] = torch.zeros((N,), dtype=torch.bool, device=dev)
        s["winner"] = torch.zeros((N,), dtype=torch.int32, device=dev)
        s = self._spawn(s, torch.ones((N,), dtype=torch.bool, device=dev), jitter)
        s["next_wave"] = torch.full((N,), WAVE_PERIOD, dtype=torch.float32, device=dev)
        return s

    def reset_where(self, s: Dict[str, torch.Tensor], mask: torch.Tensor, jitter: torch.Tensor):
        new = self.fresh(jitter)
        return {k: torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)), new[k], v) for k, v in s.items()}

    def _spawn(self, s, due: torch.Tensor, jitter: torch.Tensor):
        """One wave a team where ``due``, into the first free creep slots."""
        lay = self.lay
        C = lay.creeps
        s = dict(s)
        for k, tm in enumerate((RADIANT, DIRE)):
            lo, hi = lay.creep0 + k * C, lay.creep0 + (k + 1) * C
            sign = 1.0 if tm == RADIANT else -1.0
            free = ~s["alive"][:, lo:hi]
            order = torch.cumsum(free, dim=1) - 1
            take = free & (order < WAVE_SIZE) & due[:, None]
            pos = order.float()
            for key, v in (("unit_type", UNIT_CREEP), ("team", tm), ("x", TOWER_X[tm] + sign * (250.0 + 40.0 * pos)),
                           ("y", jitter[k]), ("health", CREEP["hp"]), ("health_max", CREEP["hp"]),
                           ("damage", CREEP["damage"]), ("attack_range", CREEP["range"]),
                           ("move_speed", CREEP["speed"]), ("armor", CREEP["armor"]), ("level", 1),
                           ("alive", True), ("attack_cd", 0.0)):
                s[key] = with_cols(s[key], lo, hi, torch.where(take, v, s[key][:, lo:hi]))
        return s

    # -- one interval --------------------------------------------------------

    def step(self, s: Mapping[str, torch.Tensor], act: Mapping[str, torch.Tensor], jitter: torch.Tensor):
        """``act``: type, move_x, move_y, target_slot, ability, each [N, P]
        (type < 0 is a no-op)."""
        lay = self.lay
        S, P = lay.max_units, lay.players
        s = dict(s)
        live = ~s["done"]
        dt = lay.dt
        dist = torch.hypot(s["x"][:, :, None] - s["x"][:, None, :], s["y"][:, :, None] - s["y"][:, None, :])
        a_type = torch.where(act["type"] < 0, NOOP, act["type"])
        target = act["target_slot"].clamp(0, S - 1).long()
        hero_alive = s["alive"][:, :P] & live[:, None]

        # movement
        half = (lay.move_bins - 1) / 2.0
        mdx = (act["move_x"] - half) / max(half, 1.0)
        mdy = (act["move_y"] - half) / max(half, 1.0)
        norm = torch.hypot(mdx, mdy)
        ok = hero_alive & (a_type == MOVE) & (norm > 1e-6)
        scale = torch.where(ok, s["move_speed"][:, :P] * dt / torch.clamp(norm, min=1e-9), 0.0)
        hx = torch.clamp(s["x"][:, :P] + mdx * scale, -HALF_LANE, HALF_LANE)
        hy = torch.clamp(s["y"][:, :P] + mdy * scale, -400.0, 400.0)
        s["x"] = with_cols(s["x"], 0, P, torch.where(ok, hx, s["x"][:, :P]))
        s["y"] = with_cols(s["y"], 0, P, torch.where(ok, hy, s["y"][:, :P]))

        # hero attacks and casts, on the distances from before the move
        def at(key):
            return s[key].gather(1, target)

        t_dist = dist[:, :P, :].gather(2, target[..., None])[..., 0]
        mine = s["team"][:, :P]
        deny = (at("team") == mine) & (at("unit_type") == UNIT_CREEP) & (at("health") < 0.5 * at("health_max"))
        attack_ok = (hero_alive & (a_type == ATTACK) & at("alive") & ((at("team") != mine) | deny)
                     & (t_dist <= s["attack_range"][:, :P] + 50.0) & (s["attack_cd"][:, :P] <= 0.0))
        cast_ok = (hero_alive & (a_type == CAST) & (act["ability"] == 0) & at("alive") & (at("team") != mine)
                   & (t_dist <= NUKE_RANGE) & (s["ability_cd"][:, :P] <= 0.0) & (s["mana"][:, :P] >= NUKE_MANA))
        s["attack_cd"] = with_cols(s["attack_cd"], 0, P, torch.where(attack_ok, 1.0, s["attack_cd"][:, :P]))
        s["mana"] = with_cols(s["mana"], 0, P, torch.where(cast_ok, s["mana"][:, :P] - NUKE_MANA, s["mana"][:, :P]))
        s["ability_cd"] = with_cols(s["ability_cd"], 0, P, torch.where(cast_ok, NUKE_COOLDOWN, s["ability_cd"][:, :P]))
        raw = (torch.where(attack_ok, s["damage"][:, :P], 0.0)
               + torch.where(cast_ok, NUKE_BASE + NUKE_PER_LEVEL * s["level"][:, :P], 0.0))
        hit = attack_ok | cast_ok
        dmg = (torch.where(hit, raw * armor_mult(at("armor")), 0.0)[..., None] * onehot(target, S)).sum(dim=1)
        s = self._deaths(s, dmg, dist, hit, target, deny & attack_ok)

        # creeps and towers
        s = self._units_act(s, dist, live)
        return self._clocks(s, live, jitter)

    def _xp(self, s, gain: torch.Tensor):
        P = self.lay.players
        s = dict(s)
        xp = with_cols(s["xp"], 0, P, s["xp"][:, :P] + gain)
        cur = s["level"][:, :P]
        new = torch.clamp(torch.floor_divide(xp[:, :P], XP_PER_LEVEL).to(torch.int32) + 1, max=MAX_LEVEL)
        up = torch.clamp(new - cur, min=0).float()
        hp_max = with_cols(s["health_max"], 0, P, s["health_max"][:, :P] + 40.0 * up)
        s["xp"] = xp
        s["level"] = with_cols(s["level"], 0, P, torch.maximum(cur, new))
        s["health_max"] = hp_max
        s["health"] = with_cols(s["health"], 0, P, torch.minimum(s["health"][:, :P] + 40.0 * up, hp_max[:, :P]))
        s["mana_max"] = with_cols(s["mana_max"], 0, P, s["mana_max"][:, :P] + 20.0 * up)
        s["damage"] = with_cols(s["damage"], 0, P, s["damage"][:, :P] + 4.0 * up)
        return s

    def _deaths(self, s, dmg, dist, hit=None, target=None, denied_by=None):
        lay = self.lay
        N, S, P = lay.n_games, lay.max_units, lay.players
        s = dict(s)
        was = s["alive"]
        hp = torch.where(was, s["health"] - dmg, s["health"])
        died = was & (hp <= 0.0)
        s["health"] = torch.where(died, 0.0, hp)
        s["alive"] = was & ~died
        creep = s["unit_type"] == UNIT_CREEP
        died_creep = died & creep
        died_hero = died & (s["unit_type"] == UNIT_HERO)
        died_tower = died & (s["unit_type"] == UNIT_TOWER)
        denied = torch.zeros((N, S), dtype=torch.bool, device=dmg.device)
        if hit is not None:
            credit = hit[:, :, None] & (target[:, :, None] == torch.arange(S, device=dmg.device))   # [N, P, S]
            by_hero = died & credit.any(dim=1)
            first = torch.argmax(credit.to(torch.int32), dim=1)                                    # [N, S]
            deny_credit = denied_by.gather(1, first)
            denied = by_hero & creep & deny_credit
            lasthit = by_hero & creep & ~deny_credit
            hero_kill = by_hero & (s["unit_type"] == UNIT_HERO)
            to_player = onehot(first, S)

            def credit_to(v):
                return (v.float()[..., None] * to_player).sum(dim=1)

            s["denies"] = s["denies"] + credit_to(denied).to(torch.int32)
            s["last_hits"] = s["last_hits"] + credit_to(lasthit).to(torch.int32)
            s["kills"] = s["kills"] + credit_to(hero_kill).to(torch.int32)
            s["gold"] = s["gold"] + credit_to(GOLD_LASTHIT * lasthit + GOLD_HERO_KILL * hero_kill)
            s = self._xp(s, credit_to(XP_HERO_KILL * hero_kill)[:, :P])
        # a dead creep's XP is split between the living enemy heroes in range
        each = torch.where(denied, CREEP["xp"] * DENY_XP_FACTOR, CREEP["xp"])
        near = (s["alive"][:, :P, None] & (s["team"][:, :P, None] != s["team"][:, None, :])
                & (dist[:, :P, :] <= XP_RADIUS) & died_creep[:, None, :])
        n_near = torch.clamp(near.sum(dim=1), min=1)
        s = self._xp(s, (near * (each / n_near)[:, None, :]).sum(dim=2))
        dead = died_hero[:, :P]
        s["deaths"] = with_cols(s["deaths"], 0, P, s["deaths"][:, :P] + dead.to(torch.int32))
        s["respawn_at"] = with_cols(s["respawn_at"], 0, P, torch.where(
            dead, s["dota_time"][:, None] + RESPAWN_BASE + RESPAWN_PER_LEVEL * s["level"][:, :P],
            s["respawn_at"][:, :P]))
        rad, dire = died_tower[:, lay.tower0], died_tower[:, lay.tower0 + 1]
        s["done"] = s["done"] | rad | dire
        s["winner"] = torch.where(dire, RADIANT, torch.where(rad, DIRE, s["winner"])).to(torch.int32)
        return s

    def _units_act(self, s, dist, live):
        S = self.lay.max_units
        s = dict(s)
        alive = s["alive"] & live[:, None]
        enemy = alive[:, :, None] & alive[:, None, :] & (s["team"][:, :, None] != s["team"][:, None, :])
        d = torch.where(enemy, dist, BIG)
        creep = (s["unit_type"] == UNIT_CREEP) & alive
        tower = (s["unit_type"] == UNIT_TOWER) & alive
        nearest = torch.argmin(d, dim=2)
        near_d = d.gather(2, nearest[:, :, None])[:, :, 0]
        in_reach = creep & (near_d <= s["attack_range"] + 20.0)
        creep_hits = in_reach & (s["attack_cd"] <= 0.0)
        # towers prefer the nearest non-hero in range
        pref = torch.where(d <= s["attack_range"][:, :, None],
                           d + torch.where(s["unit_type"][:, None, :] == UNIT_HERO, 1e6, 0.0), BIG * 2.0)
        t_pick = torch.argmin(pref, dim=2)
        tower_hits = tower & (pref.amin(dim=2) < BIG) & (s["attack_cd"] <= 0.0)
        hits = creep_hits | tower_hits
        tgt = torch.where(tower_hits, t_pick, nearest)
        s["attack_cd"] = torch.where(hits, 1.0, s["attack_cd"])
        dmg = (torch.where(hits, s["damage"] * armor_mult(s["armor"].gather(1, tgt)), 0.0)[..., None]
               * onehot(tgt, S)).sum(dim=1)
        s = self._deaths(s, dmg, dist)
        march = creep & ~in_reach & s["alive"]
        goal = torch.where(s["team"] == RADIANT, TOWER_X[DIRE], TOWER_X[RADIANT])
        stride = s["move_speed"] * self.lay.dt
        delta = goal - s["x"]
        s["x"] = torch.where(march, s["x"] + torch.sign(delta) * torch.minimum(stride, delta.abs()), s["x"])
        return s

    def _clocks(self, s, live, jitter):
        lay = self.lay
        P, dt = lay.players, lay.dt
        s = dict(s)
        livef = live.float()[:, None]
        s["dota_time"] = torch.where(live, s["dota_time"] + dt, s["dota_time"])
        s["tick"] = torch.where(live, s["tick"] + lay.ticks_per_obs, s["tick"])
        s["attack_cd"] = torch.clamp(s["attack_cd"] - dt * livef, min=0.0)
        s["ability_cd"] = torch.clamp(s["ability_cd"] - dt * livef, min=0.0)
        hero_up = (s["unit_type"] == UNIT_HERO) & s["alive"] & live[:, None]
        s["gold"] = torch.where(hero_up, s["gold"] + GOLD_PER_SEC * dt, s["gold"])
        s["health"] = torch.where(hero_up, torch.minimum(s["health"] + 1.5 * dt, s["health_max"]), s["health"])
        s["mana"] = torch.where(hero_up, torch.minimum(s["mana"] + 1.0 * dt, s["mana_max"]), s["mana"])
        back = ((s["unit_type"] == UNIT_HERO) & ~s["alive"] & live[:, None] & (s["respawn_at"] >= 0.0)
                & (s["respawn_at"] <= s["dota_time"][:, None]))[:, :P]
        pl = torch.arange(P, device=live.device)
        side = torch.where(s["team"][:, :P] == RADIANT, -1.0, 1.0)
        s["alive"] = with_cols(s["alive"], 0, P, s["alive"][:, :P] | back)
        s["health"] = with_cols(s["health"], 0, P, torch.where(back, s["health_max"][:, :P], s["health"][:, :P]))
        s["mana"] = with_cols(s["mana"], 0, P, torch.where(back, s["mana_max"][:, :P], s["mana"][:, :P]))
        s["x"] = with_cols(s["x"], 0, P, torch.where(back, side * (HALF_LANE - 300.0), s["x"][:, :P]))
        s["y"] = with_cols(s["y"], 0, P, torch.where(back, (60.0 * (pl % 5)).float(), s["y"][:, :P]))
        s["respawn_at"] = with_cols(s["respawn_at"], 0, P, torch.where(back, -1.0, s["respawn_at"][:, :P]))
        due = live & ~s["done"] & (s["dota_time"] >= s["next_wave"])
        s = self._spawn(s, due, jitter)
        s["next_wave"] = torch.where(due, s["dota_time"] + WAVE_PERIOD, s["next_wave"])
        over = live & ~s["done"] & (s["dota_time"] >= lay.max_dota_time)
        rad = s["team"][:, :P] == RADIANT
        rk = (s["kills"][:, :P] * rad).sum(dim=1).float()
        dk = (s["kills"][:, :P] * ~rad).sum(dim=1).float()
        rg = (s["gold"][:, :P] * rad).sum(dim=1)
        dg = (s["gold"][:, :P] * ~rad).sum(dim=1)
        rt, dt_ = s["health"][:, lay.tower0], s["health"][:, lay.tower0 + 1]
        r_wins = (rt > dt_) | ((rt == dt_) & ((rk > dk) | ((rk == dk) & (rg > dg))))
        d_wins = (dt_ > rt) | ((rt == dt_) & ((dk > rk) | ((rk == dk) & (dg > rg))))
        verdict = torch.where(r_wins, RADIANT, torch.where(d_wins, DIRE, 0))
        s["done"] = s["done"] | over
        s["winner"] = torch.where(over, verdict, s["winner"]).to(torch.int32)
        return s


# -- what one side sees, and what it is paid ----------------------------------


class Side:
    """A contiguous range of players seen as lanes (lane g * A + a is player
    ``players[a]`` of game g), with the unit order each lane sees: itself,
    the other players in order, the creep slots, then the towers."""

    def __init__(self, lay: Layout, players: Sequence[int], n_types: int, n_abilities: int, n_globals: int,
                 device) -> None:
        self.lay = lay
        self.players = list(players)
        self.lo, self.hi = self.players[0], self.players[-1] + 1
        S, P = lay.max_units, lay.players
        order = []
        for p in self.players:
            others = [q for q in range(P) if q != p]
            order.append([p] + others + list(range(lay.creep0, S)) + list(range(lay.tower0, lay.creep0)))
        self.order = torch.tensor(order, dtype=torch.long, device=device)          # [A, S]
        self.n_types, self.n_abilities, self.n_globals = n_types, n_abilities, n_globals
        self.mirror = torch.tensor([p >= lay.team_size for p in self.players], device=device)[None, :]

    @property
    def lanes(self) -> int:
        return self.lay.n_games * len(self.players)

    def observe(self, s: Mapping[str, torch.Tensor], hero_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        lay = self.lay
        N, P, S = lay.n_games, lay.players, lay.max_units
        A = len(self.players)
        me = slice(self.lo, self.hi)

        def seen(v):
            return v[:, self.order]                              # [N, A, S]

        kind, team, alive = seen(s["unit_type"]), seen(s["team"]), seen(s["alive"])
        x, y = seen(s["x"]), seen(s["y"])
        hp, hp_max, mana, mana_max = seen(s["health"]), seen(s["health_max"]), seen(s["mana"]), seen(s["mana_max"])
        castable_all = (s["unit_type"] == UNIT_HERO) & (s["ability_cd"] <= 0.0) & (s["mana"] >= NUKE_MANA)
        castable = seen(castable_all)
        my_team = s["team"][:, me][:, :, None]
        sign = torch.where(my_team == RADIANT, 1.0, -1.0)
        mx, my = s["x"][:, me][:, :, None], s["y"][:, me][:, :, None]
        me_alive = s["alive"][:, me]
        present = (kind != 0) & (alive | (kind == UNIT_HERO))
        hero, creep, tower = kind == UNIT_HERO, kind == UNIT_CREEP, kind == UNIT_TOWER
        ally = (team == my_team) & present
        itself = torch.zeros_like(present)
        itself[:, :, 0] = present[:, :, 0]
        dist = torch.hypot(x - mx, y - my)
        deniable = ally & ~itself & creep & (hp < 0.5 * hp_max)
        cols = (hero, creep, tower, ally, present & ~ally, itself,
                x * sign / POS, y / POS, (x - mx) * sign / POS, (y - my) / POS, dist / POS,
                hp / torch.clamp(hp_max, min=1.0), hp_max / HP, mana / torch.clamp(mana_max, min=1.0),
                seen(s["damage"]) / DMG, seen(s["attack_range"]) / RANGE, seen(s["move_speed"]) / SPEED,
                seen(s["armor"]) / ARMOR, seen(s["level"]) / LEVEL, alive, castable, deniable)
        units = torch.stack([c.float() for c in cols], dim=-1) * present[..., None]
        self_cast = castable[:, :, 0]
        enemy = present & (team != my_team)
        attackable = present & alive & (enemy | deniable) & ~itself & me_alive[:, :, None]
        cast_tgt = enemy & alive & (dist <= torch.where(self_cast, NUKE_RANGE, 0.0)[:, :, None]) & me_alive[:, :, None]
        m_type = torch.zeros((N, A, self.n_types), dtype=torch.bool, device=x.device)
        m_type[..., NOOP] = True
        m_type[..., MOVE] = me_alive
        m_type[..., ATTACK] = attackable.any(dim=-1)
        m_type[..., CAST] = self_cast & cast_tgt.any(dim=-1)
        m_abl = torch.zeros((N, A, self.n_abilities), dtype=torch.bool, device=x.device)
        m_abl[..., 0] = m_type[..., CAST]
        t0, t1 = lay.tower0, lay.tower0 + 1
        tw_r = s["health"][:, t0] / torch.clamp(s["health_max"][:, t0], min=1.0)
        tw_d = s["health"][:, t1] / torch.clamp(s["health_max"][:, t1], min=1.0)
        row = s["team"][:, :P]
        k_r = (s["kills"][:, :P] * (row == RADIANT)).sum(dim=1)
        k_d = (s["kills"][:, :P] * (row != RADIANT)).sum(dim=1)
        i_rad = my_team[:, :, 0] == RADIANT
        glob = torch.stack([
            (s["dota_time"] / TIME)[:, None].expand(N, A),
            torch.where(i_rad, 1.0, -1.0),
            s["gold"][:, me] / GOLD,
            s["xp"][:, me] / XP,
            s["level"][:, me] / LEVEL,
            torch.where(i_rad, (k_r - k_d)[:, None], (k_d - k_r)[:, None]).float() / 10.0,
            torch.where(i_rad, tw_r[:, None], tw_d[:, None]),
            torch.where(i_rad, tw_d[:, None], tw_r[:, None]),
        ], dim=-1).float()
        if self.n_globals > glob.shape[-1]:
            glob = torch.cat([glob, glob.new_zeros((N, A, self.n_globals - glob.shape[-1]))], dim=-1)
        L = N * A

        def flat(v):
            return v.reshape((L,) + v.shape[2:])

        return {
            "units": flat(units), "unit_mask": flat(present),
            "unit_handles": (self.order + 1).to(torch.int32)[None].expand(N, A, S).reshape(L, S),
            "globals": flat(glob), "hero_id": hero_ids[:, me].reshape(-1).to(torch.int32),
            "mask_action_type": flat(m_type), "mask_target_unit": flat(attackable),
            "mask_cast_target": flat(cast_tgt), "mask_ability": flat(m_abl),
        }

    def to_game(self, acts: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-lane head indices -> [N, P] game actions for these players
        (others -1 / 0). Dire lanes see the lane mirrored, so their move x
        bin is mirrored back."""
        lay = self.lay
        N, P, S = lay.n_games, lay.players, lay.max_units
        A = len(self.players)

        def lanes(h):
            return acts[h].reshape(N, A).to(torch.int32)

        slot = self.order[None].expand(N, A, S).gather(2, lanes("target_unit").clamp(0, S - 1).long()[..., None])[..., 0]
        mx = torch.where(self.mirror, lay.move_bins - 1 - lanes("move_x"), lanes("move_x"))

        def fill(col, v):
            out = torch.full((N, P), v, dtype=torch.int32, device=col.device)
            out[:, self.lo:self.hi] = col.to(torch.int32)
            return out

        return {"type": fill(lanes("action_type"), -1), "move_x": fill(mx, 0), "move_y": fill(lanes("move_y"), 0),
                "target_slot": fill(slot, 0), "ability": fill(lanes("ability"), 0)}

    def reward(self, prev: Mapping[str, torch.Tensor], cur: Mapping[str, torch.Tensor],
               weights: Mapping[str, float]) -> torch.Tensor:
        """The shaped reward of each lane over one interval: the weighted
        terms summed in the order xp, gold, hp, enemy hp, last hits, denies,
        kills, deaths, tower damage, own tower, win."""
        lay = self.lay
        P = lay.players
        me = slice(self.lo, self.hi)

        def hp_frac(s):
            return torch.where(s["alive"][:, :P], s["health"][:, :P] / torch.clamp(s["health_max"][:, :P], min=1.0), 0.0)

        def towers(s):
            t0, t1 = lay.tower0, lay.tower0 + 1
            frac = torch.stack([s["health"][:, t0] / torch.clamp(s["health_max"][:, t0], min=1.0),
                                s["health"][:, t1] / torch.clamp(s["health_max"][:, t1], min=1.0)], dim=1)
            return torch.where(torch.stack([s["alive"][:, t0], s["alive"][:, t1]], dim=1), frac, 0.0)

        rad = cur["team"][:, :P] == RADIANT

        def team_hp(s):
            hp = hp_frac(s)
            return ((hp * rad).sum(dim=1) / torch.clamp(rad.sum(dim=1), min=1),
                    (hp * ~rad).sum(dim=1) / torch.clamp((~rad).sum(dim=1), min=1))

        r0, d0 = team_hp(prev)
        r1, d1 = team_hp(cur)
        tw0, tw1 = towers(prev), towers(cur)
        my_team = cur["team"][:, me]
        i_rad = my_team == RADIANT

        def pick(a, b):
            return torch.where(i_rad, a, b)

        def delta(k):
            return cur[k][:, me] - prev[k][:, me]

        ended = cur["done"] & ~prev["done"] & (cur["winner"] != 0)
        won = torch.where(cur["winner"][:, None] == my_team, 1.0, -1.0)
        W = weights
        terms: List[torch.Tensor] = [
            W["xp"] * delta("xp"),
            W["gold"] * delta("gold"),
            W["hp"] * (hp_frac(cur)[:, me] - hp_frac(prev)[:, me]),
            W["enemy_hp"] * -(pick(d1[:, None], r1[:, None]) - pick(d0[:, None], r0[:, None])),
            W["last_hits"] * delta("last_hits"),
            W["denies"] * delta("denies"),
            W["kills"] * delta("kills"),
            W["deaths"] * delta("deaths"),
            W["tower_damage"] * (pick(tw0[:, 1:2], tw0[:, 0:1]) - pick(tw1[:, 1:2], tw1[:, 0:1])),
            W["own_tower"] * (pick(tw1[:, 0:1], tw1[:, 1:2]) - pick(tw0[:, 0:1], tw0[:, 1:2])),
            W["win"] * won * ended[:, None],
        ]
        total = None
        for t in terms:
            t = t.reshape(-1).float()
            total = t if total is None else total + t
        return total

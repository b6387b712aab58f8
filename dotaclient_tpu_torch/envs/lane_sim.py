"""Rule constants of the lane game: constants only.

A copy of the constants of ``dotaclient_tpu/envs/lane_sim.py`` that the
device simulator (``envs/torch_lane_sim.py``) reads, with the protocol's
enum values (``UNIT_*``, ``ACTION_*``, ``CONTROL_*``, ``GAME_STATE_*``) as
plain ints, so the port needs no protobuf. The scalar, proto-exporting
simulator of that module is not ported.
"""

from __future__ import annotations

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

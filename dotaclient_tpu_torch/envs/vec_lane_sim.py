"""Game drafting and the batch layout of the lane simulator.

A copy of three names of ``dotaclient_tpu/envs/vec_lane_sim.py``, numpy
only: ``draft_games`` (hero picks and control modes), ``apply_anchor_games``
(league anchor games) and ``VecSimSpec`` (the static slot layout). The
numpy simulator of that module is not ported; the device simulator is
``envs/torch_lane_sim.py``.

Layout of one game's ``max_units`` slots: heroes in ``[0, P)`` (slot ==
player id, P = 2 x team_size), the two towers (Radiant, Dire) in
``[P, P+2)``, and the creep pools after them, Radiant's half first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from dotaclient_tpu_torch.envs.lane_sim import (
    CONTROL_AGENT,
    CONTROL_SCRIPTED_EASY,
    CONTROL_SCRIPTED_HARD,
)

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

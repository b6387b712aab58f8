"""Windowed episode stats of the host actor pool.

A copy of ``dotaclient_tpu/actor/window_stats.py``. ``DeviceActor`` keeps
its window on the card and drains it in one read; a host pool keeps its
episode counters on the host, so its window is a delta against the counters
at the previous drain. Same cadence, same ``*_recent`` keys, which is what
the learner's best-model rotation reads in every actor mode.
``record_episode_outcome`` lands one finished episode in the ``outcome/``
counters.
"""

from __future__ import annotations

from typing import Dict, Optional

from dotaclient_tpu_torch.outcome import records as outcome_records
from dotaclient_tpu_torch.utils import telemetry


class WindowedStatsMixin:
    """Over a pool with ``episodes_done`` and ``wins`` counters and an
    append-only ``episode_rewards`` list: ``drain_stats()`` and the windowed
    entries ``stats()`` merges in through ``windowed_entries()``."""

    # class defaults, so the order of a pool's __init__ does not matter
    _win_base_eps = 0
    _win_base_wins = 0
    _win_base_ret_idx = 0

    def record_episode_outcome(self, bucket: str, won: bool, ep_len_steps: float, side: str = "radiant",
                               registry: Optional[telemetry.Registry] = None) -> None:
        """One finished episode into the ``outcome/`` counters (call once a
        game, where ``episodes_done`` and ``wins`` move)."""
        outcome_records.record_episode(registry if registry is not None else telemetry.get_registry(),
                                       bucket, won, ep_len_steps, side)

    def drain_stats(self) -> Dict[str, float]:
        """Close the window since the previous drain and return ``stats()``
        with it in the ``*_recent`` keys."""
        self._recent_window = {
            "episodes": float(self.episodes_done - self._win_base_eps),
            "wins": float(self.wins - self._win_base_wins),
            "ep_return_sum": float(sum(self.episode_rewards[self._win_base_ret_idx:])),
        }
        self._win_base_eps = self.episodes_done
        self._win_base_wins = self.wins
        self._win_base_ret_idx = len(self.episode_rewards)
        return self.stats()

    def windowed_entries(self) -> Dict[str, float]:
        recent = getattr(self, "_recent_window", None) or {}
        r_eps = recent.get("episodes", 0.0)
        return {
            "episodes_recent": r_eps,
            "win_rate_recent": recent.get("wins", 0.0) / r_eps if r_eps else 0.0,
            "ep_reward_recent": recent.get("ep_return_sum", 0.0) / r_eps if r_eps else 0.0,
        }

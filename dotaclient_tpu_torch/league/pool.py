"""Frozen-opponent pool for league self-play.

Counterpart of ``dotaclient_tpu/league/pool.py``. Every ``snapshot_every``
learner steps the live params are snapshotted into a bounded ring of
``pool_size`` frozen opponents: a dict of on-device ``detach().clone()``s
of the policy's ``state_dict()``, never moved to the host, so the learner's
in-place optimizer steps cannot reach them. Each draw plays the live policy
(mirror self-play) with probability ``selfplay_prob``, otherwise a
snapshot, chosen uniformly (``matchmaking="uniform"``) or by prioritized
fictitious self-play (``"pfsp"``): weights ``(1 - w)^pfsp_power`` of the
learner's win rate ``w`` against each snapshot, floored at 0.05, so hard
opponents come back until they are beaten.

The draws make the same ``np.random.default_rng(seed)`` calls in the same
order as the reference, so for one seed, the same snapshots and the same
``report`` calls, both pools draw the same uid sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.config import LeagueConfig

LIVE = -1  # the uid of the live (mirror self-play) draw


@dataclasses.dataclass
class Snapshot:
    params: Dict[str, torch.Tensor]
    version: int
    step: int
    uid: int = 0               # stable id: survives ring eviction
    # PFSP bookkeeping: the learner's games and wins against this snapshot
    games: float = 0.0
    wins: float = 0.0

    @property
    def win_rate(self) -> float:
        """The learner's win rate against this snapshot (0.5 until played)."""
        return self.wins / self.games if self.games > 0 else 0.5


class OpponentPool:
    """Bounded ring of frozen policy snapshots and the opponent draw."""

    def __init__(self, config: LeagueConfig, seed: int = 0) -> None:
        if config.matchmaking not in ("uniform", "pfsp"):
            raise ValueError(
                f"unknown matchmaking {config.matchmaking!r} (expected 'uniform' or 'pfsp')"
            )
        self.config = config
        self.snapshots: List[Snapshot] = []
        self._rng = np.random.default_rng(seed)
        self._last_snapshot_step: Optional[int] = None
        self._next_uid = 0

    def __len__(self) -> int:
        return len(self.snapshots)

    def maybe_snapshot(self, params: Mapping[str, torch.Tensor], version: int, step: int) -> bool:
        """Snapshot ``params`` (a state dict) if ``snapshot_every`` steps
        have passed since the last snapshot; the first call always does.
        The copy stays on the params' device."""
        if (
            self._last_snapshot_step is not None
            and step - self._last_snapshot_step < self.config.snapshot_every
        ):
            return False
        frozen = {k: v.detach().clone() for k, v in params.items()}
        self.snapshots.append(Snapshot(frozen, version, step, uid=self._next_uid))
        self._next_uid += 1
        if len(self.snapshots) > self.config.pool_size:
            self.snapshots.pop(0)
        self._last_snapshot_step = step
        return True

    def _pfsp_weights(self) -> np.ndarray:
        """``(1 - win_rate)^power`` per snapshot, floored at 0.05 so a
        beaten opponent stays in rotation, normalised."""
        w = np.asarray([(1.0 - s.win_rate) ** self.config.pfsp_power for s in self.snapshots])
        w = np.maximum(w, 0.05)
        return w / w.sum()

    def sample_indexed(self, live_params: Any, live_version: int) -> Tuple[Any, int, int]:
        """Draw the opponent of the next rollouts: ``(params, version,
        uid)``. ``uid`` is ``LIVE`` for the mirror draw (``live_params``
        come back as given), else the snapshot's stable id, for
        :meth:`report`."""
        if not self.snapshots or self._rng.random() < self.config.selfplay_prob:
            return live_params, live_version, LIVE
        if self.config.matchmaking == "pfsp":
            idx = int(self._rng.choice(len(self.snapshots), p=self._pfsp_weights()))
        else:
            idx = int(self._rng.integers(len(self.snapshots)))
        snap = self.snapshots[idx]
        return snap.params, snap.version, snap.uid

    def report(self, uid: int, wins: float, games: float) -> None:
        """Credit ``games`` outcomes (``wins`` of them the learner's) to the
        snapshot with stable id ``uid``. A no-op for ``LIVE`` and for a
        snapshot evicted since the draw."""
        if uid == LIVE or games <= 0:
            return
        for s in self.snapshots:
            if s.uid == uid:
                s.games += games
                s.wins += wins
                return

    def win_rates(self) -> List[float]:
        """The learner's win rate against each snapshot."""
        return [s.win_rate for s in self.snapshots]

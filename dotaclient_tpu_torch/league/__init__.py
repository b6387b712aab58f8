"""League self-play: the frozen-opponent pool and win-rate evaluation.

Counterpart of ``dotaclient_tpu/league``: opponent pools with periodic
snapshots, mixed self-play and frozen-past draws (uniform or PFSP), and the
evaluation the headline win rate is measured with.
"""

from dotaclient_tpu_torch.league.evaluation import evaluate, evaluate_served
from dotaclient_tpu_torch.league.pool import LIVE, OpponentPool, Snapshot

__all__ = ["LIVE", "OpponentPool", "Snapshot", "evaluate", "evaluate_served"]

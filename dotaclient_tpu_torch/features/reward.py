"""The shaped reward's weights and its one summation order.

A copy of two names of ``dotaclient_tpu/features/reward.py``: ``WEIGHTS``
(the defaults of ``RewardConfig``) and ``fold_terms``. The proto reward
functions of that module are not ported.
"""

from __future__ import annotations

from typing import Dict

from dotaclient_tpu_torch.config import RewardConfig

WEIGHTS: Dict[str, float] = dict(RewardConfig().as_dict())


def fold_terms(weighted: Dict[str, object]):
    """Left-fold a weighted per-term breakdown in table (insertion) order.
    This order is the contract: every producer of the scalar reward folds
    through this one helper, so the reward is bit-identical to the
    reference's sum of the same terms. Works on any ``+``-able values."""
    total = None
    for arr in weighted.values():
        total = arr if total is None else total + arr
    return total

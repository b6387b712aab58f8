"""Capacity-limited top-1 (Switch) routing, the math ``models/moe.py`` runs.

Counterpart of ``expert_capacity`` and ``route_top1`` of
``dotaclient_tpu/parallel/expert.py``. The reference's ``moe_shard`` and
``make_expert_dispatch`` (a ``shard_map`` with two ``all_to_all`` exchanges
a layer) spread the experts over several devices; on one card every expert
is local, so they wait for the multi-GPU item (ROADMAP queue 1, item 7).

The routing reads nothing on the host: a token's slot in its expert's queue
is a ``cumsum`` of one-hot rows over the batch axis, so the tokens that
overflow ``capacity`` are the last ones in batch order, and the dispatch
mask is a comparison against ``arange(capacity)`` (an out-of-range slot
compares false, the reference's one-hot of an out-of-range index: a zero
row).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def expert_capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Token slots an expert takes a routing call: ``ceil(tokens / E x cf)``,
    at least 1."""
    return max(1, math.ceil(n_tokens / n_experts * capacity_factor))


def route_top1(
    x: torch.Tensor, gate_w: torch.Tensor, n_experts: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 routing of tokens ``x [B, D]`` by the gate ``[D, E]`` in f32.

    Returns (dispatch ``[B, E, C]`` 0/1, combine ``[B, E, C]`` = dispatch x
    the chosen expert's gate probability, probs ``[B, E]``: the whole gate
    softmax before any drop, for the load-balancing loss). A token past an
    expert's ``capacity`` is dropped: its dispatch and combine rows are 0."""
    logits = x.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                 # the first maximum, as jnp.argmax
    prob = torch.gather(probs, 1, expert[:, None])[:, 0]
    # a comparison, not F.one_hot, which reads the indices' range on the host
    onehot = (expert[:, None] == torch.arange(n_experts, device=x.device)).to(torch.float32)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot   # the token's place in its expert's queue
    keep = (pos < capacity).to(torch.float32)
    slot = (pos.to(torch.int64)[..., None] == torch.arange(capacity, device=x.device)).to(torch.float32)
    dispatch = onehot[..., None] * keep[..., None] * slot
    combine = dispatch * prob[:, None, None]
    return dispatch, combine, probs

"""Mixture-of-experts MLP: Switch-style top-1 routing with capacity.

Counterpart of ``dotaclient_tpu/models/moe.py``'s ``MoEMLP``. The params are
expert-major, as the reference's: ``gate [D, E]``, ``expert_w1 [E, D, F]``,
``expert_b1 [E, F]``, ``expert_w2 [E, F, D]``, ``expert_b2 [E, D]`` with
``F = 4 x hidden_dim``, all f32 and cast to the compute dtype at use. A call
routes its B tokens (``parallel/expert.py``: ``C = ceil(B / E x
capacity_factor)`` slots an expert, overflow dropped in batch order), then
runs the same dispatch -> expert FFN (tanh GELU) -> combine einsums. A
dropped token's FFN output is 0, so its residual passes through the gate.

Flax ``sow``s the per-token routing statistics into a ``losses``
collection; the port has none, so ``forward`` returns them: ``probs [B, E]``
(the whole gate softmax) and ``frac [B, E]`` (1 at the expert that took the
token, 0 where it was dropped), which ``train/ppo.py``'s ``_moe_aux_loss``
masks and averages.

On a data-parallel world the call takes the batch group (``group``): the
routing is then the global batch's, as the reference's MoE layer sees it
(``parallel/expert.py``). Every caller that holds a rank's share of a
batch passes it: the lane-sharded rollout, the update, the advantage pass.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dotaclient_tpu_torch.parallel.collectives import Group
from dotaclient_tpu_torch.parallel.expert import expert_capacity, route_top1


class MoEMLP(nn.Module):
    """Top-1 routed MLP ``[B, D] -> [B, D]`` over ``n_experts`` experts."""

    def __init__(self, dim: int, n_experts: int, capacity_factor: float, device: torch.device) -> None:
        super().__init__()
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        E, D, Fh = n_experts, dim, 4 * dim
        self.gate = nn.Parameter(torch.zeros(D, E, device=device))
        self.expert_w1 = nn.Parameter(torch.zeros(E, D, Fh, device=device))
        self.expert_b1 = nn.Parameter(torch.zeros(E, Fh, device=device))
        self.expert_w2 = nn.Parameter(torch.zeros(E, Fh, D, device=device))
        self.expert_b2 = nn.Parameter(torch.zeros(E, D, device=device))

    def forward(self, x: torch.Tensor, group: Group = None) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x ``[B, D]`` in the compute dtype (with ``group``, this rank's
        block of the global batch) -> (y ``[B, D]`` in that dtype, (probs,
        frac) ``[B, E]`` each, f32)."""
        dtype = x.dtype
        C = expert_capacity(x.shape[0], self.n_experts, self.capacity_factor, group)
        dispatch, combine, probs = route_top1(x, self.gate, self.n_experts, C, group)     # [B, E, C]
        xin = torch.einsum("bec,bd->ecd", dispatch.to(dtype), x)
        h = torch.einsum("ecd,edf->ecf", xin, self.expert_w1.to(dtype)) + self.expert_b1[:, None].to(dtype)
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("ecf,efd->ecd", h, self.expert_w2.to(dtype)) + self.expert_b2[:, None].to(dtype)
        y = torch.einsum("bec,ecd->bd", combine.to(dtype), out)
        return y.to(dtype), (probs, dispatch.sum(dim=2))

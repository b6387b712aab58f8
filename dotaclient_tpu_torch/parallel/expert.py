"""Expert parallelism: capacity-limited top-1 (Switch) routing, and the
explicit expert dispatch over a mesh axis.

Counterpart of ``dotaclient_tpu/parallel/expert.py``. ``expert_capacity``
and ``route_top1`` are the routing math ``models/moe.py`` runs.
``moe_shard`` and ``make_expert_dispatch`` are the GShard/Switch plan with
the experts spread over the ranks of one axis: tokens cut over the axis
(each rank ``B/n``), experts cut over the same axis (each rank ``E/n`` whole
expert FFNs), and the dispatched token blocks cross the axis twice a layer
with ``all_to_all`` (token shard to expert shard, and back). A token past
its expert's capacity is dropped: its output row is zeros. The learner's
MoE core keeps every expert whole on each rank for compute; on a model
axis the ``"expert"`` rule cuts the experts' master params and Adam
moments on axis 0 (``parallel/sharding.py``), gathered after each
optimizer step, so the learner never needs this primitive's
``all_to_all`` (which gloo has no CUDA form of).

Routing over a data-parallel group (``group``): the reference's MoE layer
sees the global batch, so its capacity comes from the global token count
and a token's slot is its rank in a ``cumsum`` over every token in batch
order. A rank holds a contiguous block of that order, so its tokens' slots
are its local ``cumsum`` plus the tokens routed to the same expert on the
lower ranks: one all-reduce of a zero-filled ``[n, E]`` count table in
which each rank wrote its row. Drops are then world 1's, token for token.

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
import torch.distributed as dist
import torch.nn.functional as F

from dotaclient_tpu_torch.parallel.collectives import Group, all_gather_rows, all_to_all, group_rank, group_size
from dotaclient_tpu_torch.parallel.mesh import Mesh, axis_group

AXIS = "data"


def expert_capacity(n_tokens: int, n_experts: int, capacity_factor: float, group: Group = None) -> int:
    """Token slots an expert takes a routing call: ``ceil(tokens / E x cf)``,
    at least 1; with a ``group``, ``n_tokens`` is a rank's share of the
    global batch (equal on every rank) and the count is the global one."""
    n_tokens *= group_size(group)
    return max(1, math.ceil(n_tokens / n_experts * capacity_factor))


def lower_rank_counts(onehot: torch.Tensor, group: Group) -> torch.Tensor:
    """``[E]``: the tokens routed to each expert on the group's lower ranks
    (0 without a group). One all-reduce of an ``[n, E]`` table."""
    n = group_size(group)
    if n == 1:
        return torch.zeros(onehot.shape[1], dtype=onehot.dtype, device=onehot.device)
    me = group_rank(group)
    table = torch.zeros((n, onehot.shape[1]), dtype=onehot.dtype, device=onehot.device)
    table[me] = onehot.sum(dim=0)
    dist.all_reduce(table, group=group)
    return table[:me].sum(dim=0)


def route_top1(
    x: torch.Tensor, gate_w: torch.Tensor, n_experts: int, capacity: int, group: Group = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 routing of tokens ``x [B, D]`` by the gate ``[D, E]`` in f32.

    Returns (dispatch ``[B, E, C]`` 0/1, combine ``[B, E, C]`` = dispatch x
    the chosen expert's gate probability, probs ``[B, E]``: the whole gate
    softmax before any drop, for the load-balancing loss). A token past an
    expert's ``capacity`` is dropped: its dispatch and combine rows are 0.
    With a ``group``, ``x`` is this rank's block of the global batch and a
    token's place counts the lower ranks' tokens first."""
    logits = x.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                 # the first maximum, as jnp.argmax
    prob = torch.gather(probs, 1, expert[:, None])[:, 0]
    # a comparison, not F.one_hot, which reads the indices' range on the host
    onehot = (expert[:, None] == torch.arange(n_experts, device=x.device)).to(torch.float32)
    # the token's place in its expert's queue (after the lower ranks')
    pos = (torch.cumsum(onehot, dim=0) - 1.0 + lower_rank_counts(onehot, group)) * onehot
    keep = (pos < capacity).to(torch.float32)
    slot = (pos.to(torch.int64)[..., None] == torch.arange(capacity, device=x.device)).to(torch.float32)
    dispatch = onehot[..., None] * keep[..., None] * slot
    combine = dispatch * prob[:, None, None]
    return dispatch, combine, probs


def moe_shard(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, group: Group = None, capacity_factor: float = 2.0) -> torch.Tensor:
    """One rank's MoE layer: ``x`` its token shard ``[Bl, D]``, ``gate_w``
    ``[D, E]`` whole, ``w1 [El, D, F]``, ``b1 [El, F]``, ``w2 [El, F, D]``,
    ``b2 [El, D]`` its expert shard (El = E / n). Returns ``[Bl, D]``: each
    token's chosen expert's output times its gate probability, zeros for a
    dropped token."""
    n = group_size(group)
    Bl, D = x.shape
    El = w1.shape[0]
    E = El * n
    capacity = expert_capacity(Bl, E, capacity_factor)
    dispatch, combine, _ = route_top1(x, gate_w, E, capacity)
    # this rank's contribution to every expert's queue [E, C, D]
    xin = torch.einsum("bec,bd->ecd", dispatch, x.to(torch.float32))
    # token shard -> expert shard: expert group j to rank j; the queues from
    # every rank concatenated along C in rank order: [El, n*C, D]
    got = all_to_all(xin.reshape(n, El, capacity, D), group)
    xin = got.permute(1, 0, 2, 3).reshape(El, n * capacity, D)
    h = torch.einsum("ecd,edf->ecf", xin, w1.to(torch.float32)) + b1.to(torch.float32)[:, None]
    h = F.gelu(h, approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, w2.to(torch.float32)) + b2.to(torch.float32)[:, None]
    # expert shard -> token shard: the inverse exchange, back to [E, C, D]
    back = all_to_all(out.reshape(El, n, capacity, D).permute(1, 0, 2, 3), group)
    out = back.reshape(E, capacity, D)
    return torch.einsum("bec,ecd->bd", combine, out).to(x.dtype)


def make_expert_dispatch(mesh: Mesh, axis: str = AXIS, capacity_factor: float = 2.0, gather: bool = False):
    """The MoE layer over ``axis``: ``(x [B, D], gate_w [D, E], w1 [E, D, F],
    b1 [E, F], w2 [E, F, D], b2 [E, D])``, each whole on every rank, ->
    this rank's ``[B/n, D]`` (the whole ``[B, D]`` with ``gather``); tokens
    and experts cut over the same axis."""
    group, n, me = axis_group(mesh, axis)

    def local(t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % n:
            raise ValueError(f"leading axis {t.shape[0]} not divisible by the {axis!r} axis size {n}")
        per = t.shape[0] // n
        return t[me * per:(me + 1) * per]

    def layer(x, gate_w, w1, b1, w2, b2) -> torch.Tensor:
        y = moe_shard(local(x), gate_w, local(w1), local(b1), local(w2), local(b2), group=group,
                      capacity_factor=capacity_factor)
        return all_gather_rows(y, group) if gather else y

    return layer

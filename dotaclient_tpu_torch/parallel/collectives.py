"""The collective steps the parallel modules are made of, over one process
group (None: a world of one, where each is the identity).

Each is the torch form of a collective the reference emits inside
``shard_map``: ``psum``, ``ring_shift`` (a ``ppermute`` one step round the
ring, as ``dist.batch_isend_irecv``), ``all_to_all`` (the tiled
``all_to_all``, as ``dist.all_to_all_single``) and ``all_gather_rows``
(gathering a leading axis, as the reference's out-sharding to
replicated).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor; ``x`` itself
    when the group is None)."""
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` sent to the next rank of the group's ring; returns what the
    previous rank sent (the reference's ``ppermute`` with ``i -> i + 1``)."""
    n = group_size(group)
    if n == 1:
        return x
    me = group_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n) if group is not None else (me + 1) % n
    prv = dist.get_global_rank(group, (me - 1) % n) if group is not None else (me - 1) % n
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, nxt, group=group), dist.P2POp(dist.irecv, out, prv, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` ``[n, ...]``: block ``j`` goes to rank ``j``; returns ``[n,
    ...]`` whose block ``i`` came from rank ``i``."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)

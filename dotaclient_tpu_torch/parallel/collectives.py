"""The collective steps the parallel modules are made of, over one process
group (None: a world of one, where each is the identity).

Each is the torch form of a collective the reference emits inside
``shard_map``: ``psum``, ``ring_shift`` (a ``ppermute`` one step round the
ring, as ``dist.batch_isend_irecv``), ``all_to_all`` (the tiled
``all_to_all``, as ``dist.all_to_all_single``) and ``all_gather_rows``
(gathering a leading axis, as the reference's out-sharding to
replicated); ``gather_cut`` (the tensor-parallel layout's gather of each
rank's slices into whole tensors, GSPMD's all-gather of a cut leaf).

``broadcast_host``, ``scatter_host`` and ``exchange_host`` move host
tensors over a gloo group, rank to rank: the single door of the host-fed
ring (``buffer/trajectory_buffer.py``) sends its decisions and its rows with
them.

gloo takes CUDA tensors only in ``broadcast`` and ``all_reduce``, so every
primitive here that takes a device tensor is one of those two: on a world
of two ranks sharing one card (gloo, as NCCL refuses two ranks on one
device) and on NCCL alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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


def gather_cut(parts: Sequence[torch.Tensor], dims: Sequence[int], group: Group) -> List[torch.Tensor]:
    """Each rank's slice ``parts[i]`` of a tensor cut along ``dims[i]`` into
    equal blocks in group-rank order -> the whole tensors, on every rank of
    the group. One all-reduce (SUM) of a zero-filled buffer into which each
    rank wrote its slices (``x + 0`` is exact), which gloo takes on CUDA
    tensors too. The parts share one dtype and device."""
    n = group_size(group)
    if n == 1:
        return list(parts)
    me = group_rank(group)
    shapes = []
    for p, d in zip(parts, dims):
        s = list(p.shape)
        s[d] *= n
        shapes.append(s)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=parts[0].dtype, device=parts[0].device)
    wholes = [chunk.view(s) for chunk, s in zip(flat.split(sizes), shapes)]
    for w, p, d in zip(wholes, parts, dims):
        w.narrow(d, me * p.shape[d], p.shape[d]).copy_(p)
    dist.all_reduce(flat, group=group)
    return wholes


def broadcast_host(x: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """``x`` (a CPU tensor, of the same shape and dtype on every rank) from
    global rank ``src`` to every rank of the group, in place."""
    if group_size(group) > 1:
        dist.broadcast(x, src=src, group=group)
    return x


def scatter_host(parts: Optional[List[torch.Tensor]], shape: Tuple[int, ...], dtype: torch.dtype, group: Group,
                 src: int = 0) -> torch.Tensor:
    """Group rank ``i`` receives ``parts[i]`` (CPU tensors of ``shape``
    and ``dtype``, given on global rank ``src`` alone; None elsewhere)."""
    if group_size(group) == 1:
        return parts[0]
    out = torch.empty(shape, dtype=dtype)
    dist.scatter(out, parts if dist.get_rank() == src else None, src=src, group=group)
    return out


def exchange_host(moves: Sequence[Tuple[int, int, int]], sends: Dict[int, torch.Tensor],
                  recv_like: Dict[int, Tuple[Tuple[int, ...], torch.dtype]], group: Group) -> Dict[int, torch.Tensor]:
    """Point-to-point moves of CPU tensors: ``moves`` is the same list on
    every rank, ``(key, src, dst)`` global ranks. This rank sends
    ``sends[key]`` where it is ``src`` and receives a tensor of
    ``recv_like[key]``'s shape and dtype where it is ``dst``; returns the
    received ones by key. Each rank takes its moves in list order, so the
    earliest unfinished move always has both ends waiting on it: no
    cycle, no deadlock."""
    me = dist.get_rank() if group_size(group) > 1 else 0
    got: Dict[int, torch.Tensor] = {}
    for key, src, dst in moves:
        if src == me:
            dist.send(sends[key].contiguous(), dst=dst, group=group)
        elif dst == me:
            shape, dtype = recv_like[key]
            got[key] = torch.empty(shape, dtype=dtype)
            dist.recv(got[key], src=src, group=group)
    return got

"""Pipeline parallelism: GPipe microbatches through stages over a mesh axis.

Counterpart of ``dotaclient_tpu/parallel/pipeline.py``. A layer stack cut
into S stages, one a rank of the ``axis``; M microbatches stream through it
in M + S - 1 ticks (fill and drain, bubble (S - 1) / (M + S - 1)). Each tick
every rank runs its stage on what it holds and hands the activation to the
next stage with one ``batch_isend_irecv`` round the ring (the reference's
``ppermute``; the last stage's hop back to stage 0 is discarded, stage 0
reading fresh input). At the end the last stage's outputs are made whole
on every rank by an all-reduce of one-hot contributions, as the
reference's ``psum``.

Contract (held by ``tests/test_torch_parallel.py``): the same output as the
S stages applied in sequence on one device.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from dotaclient_tpu_torch.parallel.collectives import psum, ring_shift
from dotaclient_tpu_torch.parallel.mesh import Mesh, axis_group
from dotaclient_tpu_torch.utils.tree import tree_map

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def make_pipeline(stage_fn: StageFn, mesh: Mesh, axis: str, n_microbatches: int):
    """``pipe(stacked_params, x) -> out``: ``stage_fn(stage_params, x)`` must
    keep ``x``'s shape; ``stacked_params`` is a tree whose leaves have a
    leading stage axis ``[S, ...]``; ``x`` ``[B, ...]`` is whole on every
    rank, with B divisible by ``n_microbatches``; ``out`` ``[B, ...]`` is the
    last stage's output, whole on every rank."""
    group, S, s = axis_group(mesh, axis)
    M = n_microbatches

    def pipe(stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} not divisible by n_microbatches {M}")
        params = tree_map(lambda p: p[s], stacked_params)
        xm = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        out = torch.zeros_like(xm)
        recv = torch.zeros_like(xm[0])
        for t in range(M + S - 1):
            idx = t - s                           # this stage's microbatch this tick
            valid = 0 <= idx < M
            if valid:
                act = stage_fn(params, xm[idx] if s == 0 else recv)
                if s == S - 1:
                    out[idx] = act
            else:
                act = torch.zeros_like(recv)
            recv = ring_shift(act, group)
        if S > 1 and s != S - 1:
            out = torch.zeros_like(out)
        return psum(out, group).reshape(x.shape)

    return pipe


def stack_stage_params(params_list: List[Any]) -> Any:
    """Per-stage trees -> one tree with a leading stage axis."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)

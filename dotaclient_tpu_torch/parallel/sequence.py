"""Sequence parallelism: ring attention and Ulysses attention.

Counterpart of ``dotaclient_tpu/parallel/sequence.py``. The sequence axis
is cut over one mesh axis; each rank holds ``T / n`` positions of q, k, v
``[B, T_local, h, d]``.

* **Ring attention**: the k/v blocks go round the axis's ring (one
  ``batch_isend_irecv`` hop a turn, the reference's ``ppermute``) while each
  rank folds every block into its queries' attention with an online
  log-sum-exp softmax: exact, not approximate, O(T/n) memory a rank.
* **Ulysses**: one ``all_to_all`` trades sequence for heads
  (``[B, T/n, h, d] -> [B, T, h/n, d]``), dense attention runs on whole
  sequences of the local heads, and a second ``all_to_all`` trades back.

Both are per-shard functions over a process group; ``make_ring_attention``
and ``make_ulysses_attention`` take global ``[B, T, h, d]`` tensors (whole on
every rank), run the rank's shard and return it, or the gathered output
with ``gather=True``. Compute is f32 and the result takes q's dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from dotaclient_tpu_torch.parallel.collectives import Group, all_gather_rows, all_to_all, group_rank, group_size, ring_shift
from dotaclient_tpu_torch.parallel.mesh import Mesh, axis_group

AXIS = "data"  # default mesh axis to cut the sequence over


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Plain softmax attention, the one-device oracle: ``[B, T, h, d]`` in
    and out."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
        s = torch.where(mask[None, None], s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _block_attend(q, k, v, bias):
    """Unnormalised block attention with its running max: (o, m, l) with
    o = sum_j exp(s - m) v_j ``[B, Tq, h, d]``, m = the row max and l = the
    row sum of exp(s - m), each ``[B, h, Tq]``."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    s = s + bias
    m = s.amax(dim=-1)
    # a row masked whole (causal: a block in the future) has m = -inf;
    # a finite baseline there makes exp(-inf - 0) = 0 instead of NaN
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m, p.sum(dim=-1)


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Group = None,
                         causal: bool = False) -> torch.Tensor:
    """One rank's ring attention: q, k, v are its sequence shard ``[B,
    T_local, h, d]`` (the global sequence is the shards in rank order)."""
    n, my = group_size(group), group_rank(group)
    B, Tl, h, d = q.shape
    q32, kb, vb = (x.to(torch.float32) for x in (q, k, v))
    q_pos = my * Tl + torch.arange(Tl, device=q.device)

    def bias_for(owner: int) -> torch.Tensor:
        if not causal:
            return torch.zeros((1, 1, Tl, Tl), dtype=torch.float32, device=q.device)
        k_pos = owner * Tl + torch.arange(Tl, device=q.device)
        allowed = q_pos[:, None] >= k_pos[None, :]
        return torch.where(allowed, 0.0, float("-inf"))[None, None]

    acc_o = torch.zeros((B, Tl, h, d), dtype=torch.float32, device=q.device)
    acc_m = torch.full((B, h, Tl), float("-inf"), dtype=torch.float32, device=q.device)
    acc_l = torch.zeros((B, h, Tl), dtype=torch.float32, device=q.device)
    for i in range(n):
        owner = (my - i) % n                       # whose block this rank holds
        o, m, l = _block_attend(q32, kb, vb, bias_for(owner))
        new_m = torch.maximum(acc_m, m)
        # where both maxima are -inf the block added nothing: scale 0
        sc_old = torch.where(torch.isneginf(acc_m), 0.0, torch.exp(acc_m - new_m))
        sc_new = torch.where(torch.isneginf(m), 0.0, torch.exp(m - new_m))
        acc_o = acc_o * sc_old.transpose(1, 2)[..., None] + o * sc_new.transpose(1, 2)[..., None]
        acc_l = acc_l * sc_old + l * sc_new
        acc_m = new_m
        if i < n - 1:
            kb, vb = ring_shift(kb, group), ring_shift(vb, group)
    denom = torch.clamp(acc_l, min=1e-30).transpose(1, 2)[..., None]
    return (acc_o / denom).to(q.dtype)


def _to_seq(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``[B, T/n, h, d]`` -> ``[B, T, h/n, d]``: head block j to rank j, the
    sequence blocks concatenated in rank order."""
    n = group_size(group)
    B, Tl, h, d = x.shape
    blocks = x.reshape(B, Tl, n, h // n, d).permute(2, 0, 1, 3, 4)          # [n, B, Tl, h/n, d]
    got = all_to_all(blocks, group)                                          # block i: rank i's positions
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, h // n, d)


def _to_heads(y: torch.Tensor, group: Group) -> torch.Tensor:
    """The inverse of :func:`_to_seq`."""
    n = group_size(group)
    B, T, hl, d = y.shape
    blocks = y.reshape(B, n, T // n, hl, d).permute(1, 0, 2, 3, 4)           # [n, B, Tl, h/n, d]
    got = all_to_all(blocks, group)                                          # block i: rank i's heads
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * hl, d)


def ulysses_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Group = None,
                            causal: bool = False) -> torch.Tensor:
    """One rank's Ulysses attention: q, k, v its sequence shard ``[B,
    T_local, h, d]``, h divisible by the group's size."""
    n = group_size(group)
    if q.shape[2] % n:
        raise ValueError(f"Ulysses attention needs heads ({q.shape[2]}) divisible by the axis size {n}")
    qs, ks, vs = (_to_seq(x.to(torch.float32), group) for x in (q, k, v))
    out = reference_attention(qs, ks, vs, causal=causal)
    return _to_heads(out, group).to(q.dtype)


def _make_sp(fn, mesh: Mesh, axis: str, causal: bool, gather: bool) -> Callable[..., torch.Tensor]:
    group, n, me = axis_group(mesh, axis)

    def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        T = q.shape[1]
        if T % n:
            raise ValueError(f"sequence length {T} not divisible by the {axis!r} axis size {n}")
        lo, hi = me * (T // n), (me + 1) * (T // n)
        out = fn(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], group=group, causal=causal)
        if not gather:
            return out
        return all_gather_rows(out.transpose(0, 1).contiguous(), group).transpose(0, 1)

    return run


def make_ring_attention(mesh: Mesh, axis: str = AXIS, causal: bool = False,
                        gather: bool = False) -> Callable[..., torch.Tensor]:
    """Ring attention over ``axis``: global ``[B, T, h, d]`` in, this rank's
    ``[B, T/n, h, d]`` out (the whole ``[B, T, h, d]`` with ``gather``)."""
    return _make_sp(ring_attention_shard, mesh, axis, causal, gather)


def make_ulysses_attention(mesh: Mesh, axis: str = AXIS, causal: bool = False,
                           gather: bool = False) -> Callable[..., torch.Tensor]:
    """Ulysses attention over ``axis`` (h must divide by its size)."""
    return _make_sp(ulysses_attention_shard, mesh, axis, causal, gather)


__all__ = ["make_ring_attention", "make_ulysses_attention", "reference_attention", "ring_attention_shard",
           "ulysses_attention_shard"]

"""Whole-sequence LSTM: the hand-written Hopper kernel and its plain version.

Counterpart of ``dotaclient_tpu/ops/pallas/lstm.py`` with the same contract
and shapes (batch-major, f32)::

    x [B, T, D], h0 [B, H], c0 [B, H], wx [D, 4H], wh [H, 4H], b [4H],
    resets [B, T]  ->  (hs [B, T, H], (hT [B, H], cT [B, H]))

Cell math, gate order i, f, g, o, the reset applied BEFORE the step::

    (h, c) <- (h, c) * (1 - reset_t)
    gates = x_t @ wx + h @ wh + b
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')

``lstm_sequence_reference`` is the plain PyTorch version: a Python loop over
T, and the spec the kernels are held against. ``lstm_sequence_kernel``
launches one of the two kernels of ``csrc/lstm_seq.cu``, one launch for all T
steps, with the numbers of ``kernel_plan``: the cluster kernel (one
thread-block cluster per tile of batch rows, the weights resident in the
cluster's shared memory) for every shape whose weight slice fits one block
at a cluster of 8 or less, and the grid-wide kernel (one cooperative launch
over the card, the hidden units split over its blocks) for every other
non-empty shape. It counts its launches in ``lstm_sequence_kernel.launches``
and, by plan, in ``lstm_sequence_kernel.launches_by_plan``.

``LSTMSequenceFunction`` gives the kernel its gradient, as the JAX package's
``lstm_sequence_pallas`` custom VJP does: the forward runs the
implementation it is handed and saves its inputs; the backward re-runs the
plain version under autograd on them and returns the gradients of x, h0,
c0, wx, wh and b (none for resets). No kernel is written for the backward.

``lstm_sequence`` dispatches on where the tensors lie: the plain version for
CPU tensors or when ``use_kernel=False``; for CUDA tensors the kernel, through
``LSTMSequenceFunction`` whenever autograd is recording and an input needs a
gradient, directly otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from dotaclient_tpu_torch.ops import build

LSTMOut = Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _cell(x_t, h, c, wx, wh, b, reset_t):
    keep = (1.0 - reset_t)[:, None]
    h = h * keep
    c = c * keep
    gates = x_t @ wx + h @ wh + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_sequence_reference(x, h0, c0, wx, wh, b, resets) -> LSTMOut:
    """Plain PyTorch version (the spec): returns (hs [B, T, H], (hT, cT))."""
    h, c = h0, c0
    hs = []
    for t in range(x.shape[1]):
        h, c = _cell(x[:, t], h, c, wx, wh, b, resets[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)


ROWS_PER_TILE = 4           # batch rows per cluster (kRows in the source)
CLUSTER_SIZES = (8, 4, 2, 1)  # portable cluster sizes, largest first
TARGET_THREADS = 256        # per block: column groups x K-slices
MAX_SMEM_BYTES = 232_448    # shared memory one block may use on Hopper (227 KB)
# the grid-wide kernel's: blocks at most (one an SM of an H100 SXM, so the
# cooperative launch is co-resident), rows per batch tile (by B, the
# smallest that holds B, up to 8: at 16 the accumulators spill and a launch
# takes longer), threads per block at most (column threads x K-slices),
# K-slices at most, and the chunk of the K = D+H axis staged at once
GRID_BLOCKS = 132
GRID_ROWS = (1, 2, 4, 8)
GRID_THREADS = 512          # kGridMaxThreads in the source (its launch bound)
GRID_KSLICES = 32
GRID_KCHUNK = 1024


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Launch numbers for one shape: ``kind`` names the kernel. A cluster
    plan (``cluster`` blocks a cluster, one cluster a tile of ``rows``
    batch rows) or a grid plan (``cluster`` 1; ``grid`` blocks, each owning
    ``units`` hidden units, walking the batch in tiles of ``rows``, staging
    ``kchunk`` of the padded D+H axis at once, its weight slice in shared
    memory when ``resident``)."""

    cluster: int      # blocks per cluster; block r owns hidden units [r*U, (r+1)*U)
    rows: int         # batch rows per tile; one cluster per tile
    grid: int         # blocks in all: cluster x tiles
    threads: int      # per block: U column groups (of the 4U columns) x kslices
    kslices: int      # the K axis is cut into this many slices of 4-deep chunks
    smem_bytes: int   # dynamic shared memory per block
    kind: str = "cluster"
    units: int = 0    # hidden units per block (grid plan)
    kchunk: int = 0   # floats of the padded K axis staged at once (grid plan)
    resident: bool = True  # the weight slice kept in shared memory (grid plan)


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _cluster_plan(B: int, T: int, D: int, H: int):
    """The cluster kernel's launch, or None where its buffers exceed one
    block's shared memory (or threads) at the largest portable cluster size
    that divides H."""
    cluster = next(c for c in CLUSTER_SIZES if H % c == 0)
    units = H // cluster
    rows = ROWS_PER_TILE
    kslices = max(rows, min(32, TARGET_THREADS // units))
    threads = units * kslices
    cols, Dp, Hp = 4 * units, _round4(D), _round4(H)
    # mbarriers, weights, x and h (two buffers each), partial sums, gate
    # pre-activations, bias, the tile's resets (smem_floats in the source)
    floats = (4 + (Dp + Hp) * cols + 2 * rows * (Dp + Hp) + kslices * rows * cols + rows * cols
              + cols + _round4(rows * T))
    smem = 4 * floats
    if smem > MAX_SMEM_BYTES or threads > 1024:
        return None
    tiles = -(-B // rows)
    return KernelPlan(cluster, rows, cluster * tiles, threads, kslices, smem, units=units)


def _grid_plan(B: int, D: int, H: int) -> KernelPlan:
    """The grid-wide kernel's launch: H split over at most GRID_BLOCKS
    blocks; the weight slice resident where it fits beside the buffers, read
    from global memory each step where it does not (then fewer rows a tile
    where even the buffers do not fit)."""
    units = -(-H // GRID_BLOCKS)
    blocks = -(-H // units)
    cols = 4 * units
    col_threads = min(cols, GRID_THREADS)
    kslices = max(1, min(GRID_KSLICES, GRID_THREADS // col_threads))
    Kp = _round4(D) + _round4(H)
    kchunk = min(Kp, GRID_KCHUNK)
    top = next(r for r in GRID_ROWS if r >= min(B, GRID_ROWS[-1]))

    def smem(rows, resident):  # grid_smem_floats in the source, in bytes
        return 4 * ((Kp * cols if resident else 0) + rows * kchunk + kslices * rows * cols + rows * cols + cols)

    tries = [(top, True)] + [(r, False) for r in reversed(GRID_ROWS) if r <= top]
    for rows, resident in tries:
        if smem(rows, resident) <= MAX_SMEM_BYTES:
            return KernelPlan(1, rows, blocks, col_threads * kslices, kslices, smem(rows, resident), kind="grid",
                              units=units, kchunk=kchunk, resident=resident)
    raise ValueError(f"lstm kernel plan: H={H} needs {smem(1, False)} bytes of shared memory a block even "
                     f"with one row a tile (limit {MAX_SMEM_BYTES}); its weights exceed any card's memory")


def kernel_plan(B: int, T: int, D: int, H: int) -> KernelPlan:
    """The launch for ``x [B, T, D]`` and hidden width H. Pure Python. The
    cluster kernel's plan wherever its weight slice and buffers fit one
    block's shared memory at the largest portable cluster size that divides
    H; the grid-wide kernel's plan for every other shape. Raises
    ``ValueError`` for an empty shape (and for widths whose weights no card
    could hold)."""
    if min(B, T, D, H) < 1:
        raise ValueError(f"lstm kernel plan: empty shape B={B} T={T} D={D} H={H}")
    return _cluster_plan(B, T, D, H) or _grid_plan(B, D, H)


def lstm_sequence_kernel(x, h0, c0, wx, wh, b, resets) -> LSTMOut:
    """Launch the Hopper kernel that ``kernel_plan`` names on the current
    stream. Takes contiguous f32 CUDA tensors of the contract's non-empty
    shapes and raises on anything else; never runs the plain version."""
    B, T, D = x.shape
    H = h0.shape[-1]
    expected = {
        "x": (x, (B, T, D)), "h0": (h0, (B, H)), "c0": (c0, (B, H)),
        "wx": (wx, (D, 4 * H)), "wh": (wh, (H, 4 * H)), "b": (b, (4 * H,)),
        "resets": (resets, (B, T)),
    }
    for name, (t, shape) in expected.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"lstm kernel: {name} is on {t.device}, not {x.device} (CUDA)")
        if t.dtype != torch.float32:
            raise ValueError(f"lstm kernel: {name} is {t.dtype}, expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"lstm kernel: {name} is not contiguous")
    plan = kernel_plan(B, T, D, H)
    hs = torch.empty((B, T, H), dtype=torch.float32, device=x.device)
    hT = torch.empty((B, H), dtype=torch.float32, device=x.device)
    cT = torch.empty((B, H), dtype=torch.float32, device=x.device)
    lib = build.kernel_library()
    err = ctypes.create_string_buffer(512)
    tensors = (x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
               resets.data_ptr(), hs.data_ptr(), hT.data_ptr(), cT.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kind == "cluster":
            status = lib.dota_lstm_seq_forward(
                *tensors, B, T, D, H, plan.cluster, plan.rows, plan.grid, plan.threads, plan.smem_bytes,
                stream, err, len(err),
            )
        else:
            status = lib.dota_lstm_seq_grid_forward(
                *tensors, B, T, D, H, plan.rows, plan.grid, plan.threads, plan.units, plan.kslices,
                plan.kchunk, int(plan.resident), plan.smem_bytes, stream, err, len(err),
            )
    build.check(status, err, f"lstm_seq {plan.kind} kernel launch")
    lstm_sequence_kernel.launches += 1
    lstm_sequence_kernel.launches_by_plan[plan.kind] += 1
    return hs, (hT, cT)


lstm_sequence_kernel.launches = 0
lstm_sequence_kernel.launches_by_plan = {"cluster": 0, "grid": 0}


class LSTMSequenceFunction(torch.autograd.Function):
    """The recompute backward: ``apply(forward_impl, x, h0, c0, wx, wh, b,
    resets) -> (hs, hT, cT)``. ``forward_impl`` (the kernel on the card; a
    CPU test passes the plain version) computes the outputs; the backward
    re-runs ``lstm_sequence_reference`` under autograd and returns its
    gradients, so backpropagation through time costs one plain forward and
    its backward, as in the JAX package's ``_bwd``."""

    @staticmethod
    def forward(ctx, forward_impl, x, h0, c0, wx, wh, b, resets):
        hs, (hT, cT) = forward_impl(x, h0, c0, wx, wh, b, resets)
        ctx.save_for_backward(x, h0, c0, wx, wh, b, resets)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, g_hs, g_hT, g_cT):
        x, h0, c0, wx, wh, b, resets = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (x, h0, c0, wx, wh, b)]
            hs, (hT, cT) = lstm_sequence_reference(*inputs, resets)
            grads = torch.autograd.grad((hs, hT, cT), inputs, (g_hs, g_hT, g_cT))
        return (None, *grads, None)


def lstm_sequence(x, h0, c0, wx, wh, b, resets, use_kernel: bool = True) -> LSTMOut:
    """Dispatch: the plain version for CPU tensors or when
    ``use_kernel=False`` forces it; the kernel for CUDA tensors, through
    ``LSTMSequenceFunction`` when a gradient is wanted."""
    if not use_kernel or x.device.type == "cpu":
        return lstm_sequence_reference(x, h0, c0, wx, wh, b, resets)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, h0, c0, wx, wh, b)):
        hs, hT, cT = LSTMSequenceFunction.apply(lstm_sequence_kernel, x, h0, c0, wx, wh, b, resets)
        return hs, (hT, cT)
    return lstm_sequence_kernel(x, h0, c0, wx, wh, b, resets)

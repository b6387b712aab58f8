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
at a cluster of 8 or less, and the grid-wide kernel for every other
non-empty shape. The grid-wide kernel runs one block an SM at most (the
plan takes the card's SM count, ``sms``; the wrapper passes the device's):
the batch cut into up to 4 parts of 32 rows or more, the hidden units into
groups, one block a (group, part), its weight slice in shared memory where
it fits (streamed once a step where it does not). Each block takes its
part's rows in one pass of the K axis, each thread a register tile of rows
x 4 gate columns at one of a few K-slices, the input chunks staged through
a ring of ``cp.async`` copies while the previous chunk is multiplied. Its
sum order is a function of (D, H, sms) alone, so a row's bits depend
neither on B nor on T. A launch over T > 1 steps is cooperative, with one
grid-wide barrier a step. It counts its launches in
``lstm_sequence_kernel.launches`` and, by plan, in
``lstm_sequence_kernel.launches_by_plan``.

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
# the grid-wide kernel's: the SMs it plans for when the caller names none
# (an H100 SXM's; the wrapper passes the device's own count), threads a
# block at most (kGridMaxThreads in the source, its launch bound), the
# threads of one row group at one part (ceil(H / sms) units x K-slices, so
# KS = 32 // ceil(H / sms)), the rows a thread may hold (the fewest that put
# a part in one pass, up to 8), the cells a thread may update a pass
# (kCellItems), the ring's stages (kStages), and the chunk depth below
# which the weight slice is not kept resident at the most rows a pass
GRID_SMS = 132
GRID_THREADS = 512
GRID_SLICE_THREADS = 32
GRID_THREAD_ROWS = (1, 2, 4, 8)
GRID_CELL_ITEMS = 4
GRID_STAGES = 2
GRID_MIN_RESIDENT_KCHUNK = 32
# the batch is cut into parts of at least GRID_PART_ROWS rows, at most
# GRID_MAX_PARTS (2 where the weight slice streams), each under all the
# units: a block reads only its part of a step's input, which every block
# of the other parts would read too (all at once, from the same lines of
# L2: what bounds a step at large B)
GRID_PART_ROWS = 32
GRID_MAX_PARTS = 4
# from this many steps on, a step's latency chain outweighs the one copy of
# the weight slice, and the grid takes the fewest row groups (at least
# GRID_MIN_ROW_GROUPS) that hold a part's rows one a thread: fewer warps
# meet at each of a step's barriers
GRID_LONG_STEPS = 32
GRID_MIN_ROW_GROUPS = 4


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Launch numbers for one shape: ``kind`` names the kernel. A cluster
    plan (``cluster`` blocks a cluster, one cluster a tile of ``rows``
    batch rows) or a grid plan (``cluster`` 1; the batch cut into
    ``parts``, ``grid`` blocks, each owning ``units`` hidden units of one
    part; ``rows`` batch rows a pass, ``thread_rows`` of them a thread;
    ``kslices`` K-slices; chunks of ``kchunk`` of the padded D+H axis
    through a ring of GRID_STAGES; its weight slice in shared memory when
    ``resident``). A grid plan's sum order is ``kslices``, a function of
    (D, H, sms) alone."""

    cluster: int      # blocks per cluster; block r owns hidden units [r*U, (r+1)*U)
    rows: int         # batch rows per tile (cluster) or per pass (grid)
    grid: int         # blocks in all
    threads: int      # per block
    kslices: int      # the K axis is cut into 4-deep groups dealt round-robin to this many slices
    smem_bytes: int   # dynamic shared memory per block
    kind: str = "cluster"
    units: int = 0    # hidden units per block (grid plan)
    kchunk: int = 0   # floats of the padded K axis staged at once (grid plan)
    resident: bool = True  # the weight slice kept in shared memory (grid plan)
    thread_rows: int = 0   # batch rows in one thread's register tile (grid plan)
    parts: int = 1         # the batch's parts; grid / parts blocks share each part's units (grid plan)


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


def _grid_ldi(kchunk: int) -> int:
    """A staged input row's stride in floats (grid_ldi in the source): an
    odd number of 16-byte units."""
    return -(-kchunk // 8) * 8 + 4


def grid_smem_bytes(D: int, H: int, rows: int, units: int, kslices: int, kchunk: int, resident: bool) -> int:
    """The grid kernel's dynamic shared memory (grid_smem_floats in the
    source, in bytes): the resident weight slice, the bias slice, the
    pass's resets, and the ring (inputs [rows][ldi] a stage, plus the
    weights' [kchunk][4U] when not resident), which the K-slices' partial
    sums alias."""
    cols, Kp = 4 * units, _round4(D) + _round4(H)
    stage = rows * _grid_ldi(kchunk) + (0 if resident else kchunk * cols)
    return 4 * ((Kp * cols if resident else 0) + cols + _round4(rows)
                + max(GRID_STAGES * stage, kslices * rows * cols))


def _grid_plan(B: int, T: int, D: int, H: int, sms: int, parts: int) -> KernelPlan:
    """The grid-wide kernel's launch with the batch cut into ``parts``: H
    into unit groups of ``parts * ceil(H / sms)``, one block a (group,
    part). The K-slices follow (D, H, sms) alone (32 // ceil(H / sms)); the
    weights' residency (where the slice fits at the most rows a pass with
    chunks of at least GRID_MIN_RESIDENT_KCHUNK), the rows a thread holds,
    and with them the rows a pass, the chunk (the deepest that fits, a whole
    part of K at most) and the shared memory, follow the part's rows."""
    base = -(-H // sms)
    kslices = max(1, GRID_SLICE_THREADS // base)
    units = base * parts
    blocks = -(-H // units) * parts
    row_groups = GRID_THREADS // (units * kslices)
    if T >= GRID_LONG_STEPS:
        row_groups = min(row_groups, max(GRID_MIN_ROW_GROUPS, -(-B // parts)))
    if row_groups < 1:
        raise ValueError(f"lstm kernel plan: H={H} needs {units} units a block on {sms} SMs, more than a block's "
                         f"{GRID_THREADS} threads hold; its weights exceed any card's memory")
    thread_rows = [r for r in GRID_THREAD_ROWS if -(-r // kslices) <= GRID_CELL_ITEMS]
    kpart = max(_round4(D), _round4(H))  # the longer of K's two parts (x, h): a chunk's most
    kchunks = [kpart] + [k for k in (1024, 512, 256, 128, 64, 32, 16, 8, 4) if k < kpart]
    top = row_groups * thread_rows[-1]
    resident = grid_smem_bytes(D, H, top, units, kslices, min(kpart, GRID_MIN_RESIDENT_KCHUNK), True) \
        <= MAX_SMEM_BYTES
    rt = next(r for r in thread_rows if r * row_groups >= min(-(-B // parts), top))
    rows = rt * row_groups
    kchunk = next((k for k in kchunks if grid_smem_bytes(D, H, rows, units, kslices, k, resident) <= MAX_SMEM_BYTES),
                  None)
    if kchunk is None:
        raise ValueError(f"lstm kernel plan: H={H} D={D} fits no grid plan in {MAX_SMEM_BYTES} bytes of shared "
                         f"memory a block")
    return KernelPlan(1, rows, blocks, row_groups * units * kslices, kslices,
                      grid_smem_bytes(D, H, rows, units, kslices, kchunk, resident), kind="grid", units=units,
                      kchunk=kchunk, resident=resident, thread_rows=rt, parts=parts)


def _grid_parts(B: int, T: int, D: int, H: int, sms: int) -> KernelPlan:
    """The grid plan at the most parts (1, 2 or 4) of GRID_PART_ROWS rows
    or more, up to GRID_MAX_PARTS (2 where the weight slice does not stay
    resident in one part's blocks), whose blocks still fit one an SM."""
    plan = _grid_plan(B, T, D, H, sms, 1)
    most = GRID_MAX_PARTS if plan.resident else 2
    for parts in (2, 4):
        if parts <= most and B >= parts * GRID_PART_ROWS:
            wider = _grid_plan(B, T, D, H, sms, parts)
            if wider.grid <= sms:
                plan = wider
    return plan


def kernel_plan(B: int, T: int, D: int, H: int, sms: int = GRID_SMS) -> KernelPlan:
    """The launch for ``x [B, T, D]`` and hidden width H on a card of
    ``sms`` SMs. Pure Python. The cluster kernel's plan wherever its weight
    slice and buffers fit one block's shared memory at the largest portable
    cluster size that divides H; the grid-wide kernel's plan, at most
    ``sms`` blocks, for every other shape. Raises ``ValueError`` for an
    empty shape (and for widths whose weights no card could hold)."""
    if min(B, T, D, H, sms) < 1:
        raise ValueError(f"lstm kernel plan: empty shape B={B} T={T} D={D} H={H} (sms={sms})")
    return _cluster_plan(B, T, D, H) or _grid_parts(B, T, D, H, sms)


def device_sms(device: torch.device) -> int:
    """The multiprocessor count of a CUDA device, which its grid plans take."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    plan = kernel_plan(B, T, D, H, device_sms(x.device))
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
                *tensors, B, T, D, H, plan.rows, plan.thread_rows, plan.grid, plan.threads, plan.units,
                plan.kslices, plan.kchunk, int(plan.resident), plan.smem_bytes, stream, err, len(err),
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

"""The port's whole-sequence LSTM held against the JAX package's.

The port's plain version (``lstm_sequence_reference``) must equal the JAX
spec and the Pallas kernel (in interpret mode, as tests/test_pallas.py runs
it) on the same numpy inputs, at f32 with atol 1e-5 (both sides accumulate
the gate products in f32, in different orders). The kernels' launch plan is
pure Python and is checked here: the cluster plan for every shape it took
before, the grid-wide plan for every other non-empty shape. The CUDA
kernels themselves are compared with the plain version in the ``cuda``
cases, which need a card (``python -m pytest tests/test_torch_lstm.py -m
cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LSTM_SHAPES
from dotaclient_tpu.ops.pallas import lstm_sequence as jax_lstm_sequence
from dotaclient_tpu.ops.pallas import lstm_sequence_reference as jax_lstm_reference
from dotaclient_tpu_torch.ops import lstm as port

ATOL = 1e-5


@pytest.fixture
def cuda_device():
    """The card; decided when the test runs, never at import. (This file
    needs only jax and torch, so its card cases run on a machine without
    flax.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def inputs(B=8, T=6, D=16, H=32, seed=0, reset_p=0.2):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    return (
        f(B, T, D), f(B, H), f(B, H),
        f(D, 4 * H), f(H, 4 * H), f(4 * H),
        (rng.random((B, T)) < reset_p).astype(np.float32),
    )


def to_torch(args, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in args)


def to_jax(args):
    return tuple(jnp.asarray(a) for a in args)


def flat(out):
    hs, (hT, cT) = out
    return [np.asarray(hs), np.asarray(hT), np.asarray(cT)]


# (B, T): T=1 is the serving step, B=5 leaves a partial row tile
SHAPES = [(8, 6), (5, 1), (3, 8)]


@pytest.mark.parametrize("B,T", SHAPES)
def test_plain_matches_jax_reference(B, T):
    args = inputs(B=B, T=T, seed=B + T)
    want = flat(jax_lstm_reference(*to_jax(args)))
    got = flat(port.lstm_sequence_reference(*to_torch(args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,T", SHAPES)
def test_plain_matches_pallas_interpret(B, T):
    args = inputs(B=B, T=T, seed=10 + B + T)
    want = flat(jax_lstm_sequence(*to_jax(args), interpret_ok=True))
    got = flat(port.lstm_sequence(*to_torch(args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,T", [(3, 2), (2, 4)])
def test_plain_matches_pallas_interpret_at_a_grid_width(B, T):
    """At H=256, a width only the grid plan takes on the card, the port's
    plain version against ``lstm_sequence_pallas(..., interpret=True)``:
    at K = D+H = 512 each gate sums twice the products of the narrow cases,
    in another order on each side, so the tolerance is ATOL x sqrt(2)."""
    from dotaclient_tpu.ops.pallas.lstm import lstm_sequence_pallas

    args = inputs(B=B, T=T, D=256, H=256, seed=40 + B + T)
    want = flat(lstm_sequence_pallas(*to_jax(args), True))
    got = flat(port.lstm_sequence(*to_torch(args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * np.sqrt(2))


def test_resets_cut_state():
    """A reset at step t makes steps >= t independent of the carry."""
    x, h0, c0, wx, wh, b, _ = to_torch(inputs(reset_p=0.0))
    resets = torch.zeros(x.shape[:2])
    resets[:, 3] = 1.0
    hs_a, _ = port.lstm_sequence(x, h0, c0, wx, wh, b, resets)
    hs_b, _ = port.lstm_sequence(x, 17.0 + h0, c0 - 5.0, wx, wh, b, resets)
    assert not torch.allclose(hs_a[:, 0], hs_b[:, 0])
    torch.testing.assert_close(hs_a[:, 3:], hs_b[:, 3:], rtol=0, atol=1e-6)


def test_use_kernel_false_is_plain_version():
    args = to_torch(inputs(seed=5))
    before = port.lstm_sequence_kernel.launches
    a = flat(port.lstm_sequence(*args, use_kernel=False))
    b = flat(port.lstm_sequence_reference(*args))
    c = flat(port.lstm_sequence(*args))  # CPU tensors: the plain version
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert port.lstm_sequence_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error."""
    with pytest.raises(ValueError, match="CUDA"):
        port.lstm_sequence_kernel(*to_torch(inputs(seed=6)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(64, 1, 128, 128), (32, 16, 128, 128), (5, 3, 16, 32)])
def test_kernel_matches_plain_on_cuda(cuda_device, B, T, D, H):
    args = to_torch(inputs(B=B, T=T, D=D, H=H, seed=B * T), device=cuda_device)
    before = port.lstm_sequence_kernel.launches
    got = port.lstm_sequence(*args)
    torch.cuda.synchronize()
    assert port.lstm_sequence_kernel.launches == before + 1
    want = port.lstm_sequence_reference(*args)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


# every shape the port's tests, configs and scripts give the kernel: the
# serving step, the learner's sequence, the small test shape, a batch that
# leaves one partial tile, and the width scripts/serve_loadgen.py runs
PLAN_SHAPES = [(64, 1, 128, 128), (32, 16, 128, 128), (5, 3, 16, 32), (65, 2, 128, 128), (1, 4, 8, 8)]


@pytest.mark.parametrize("B,T,D,H", PLAN_SHAPES)
def test_kernel_plan_fits_one_block(B, T, D, H):
    plan = port.kernel_plan(B, T, D, H)
    assert plan.smem_bytes <= 232_448
    assert 1 <= plan.cluster <= 8
    assert H % plan.cluster == 0  # the hidden units divide evenly over the cluster
    units = H // plan.cluster
    assert plan.threads == units * plan.kslices <= 1024
    assert plan.kslices >= plan.rows  # enough threads for the (row, unit) cell updates
    tiles = -(-B // plan.rows)
    assert plan.grid == plan.cluster * tiles and (tiles - 1) * plan.rows < B


def cluster_plan_before(B, T, D, H):
    """The cluster plan as ``kernel_plan`` computed it when it took no other
    kernel: (cluster, rows, grid, threads, kslices, smem_bytes), or None
    for a shape it refused."""
    cluster = next(c for c in (8, 4, 2, 1) if H % c == 0)
    units = H // cluster
    kslices = max(4, min(32, 256 // units))
    threads = units * kslices
    cols, Dp, Hp = 4 * units, -(-D // 4) * 4, -(-H // 4) * 4
    floats = (4 + (Dp + Hp) * cols + 2 * 4 * (Dp + Hp) + kslices * 4 * cols + 4 * cols + cols
              + -(-4 * T // 4) * 4)
    if 4 * floats > 232_448 or threads > 1024:
        return None
    return cluster, 4, cluster * -(-B // 4), threads, kslices, 4 * floats


def assert_valid_plan(plan, B, T, D, H):
    """Shared memory within one block's 227 KB, at most 1,024 threads, a
    grid the card holds co-resident, and the numbers the kernels check."""
    assert plan.smem_bytes <= 232_448 and 1 <= plan.threads <= 1024
    if plan.kind == "cluster":
        assert plan == port._cluster_plan(B, T, D, H)
        assert (plan.cluster, plan.rows, plan.grid, plan.threads, plan.kslices, plan.smem_bytes) == \
            cluster_plan_before(B, T, D, H)
        return
    assert plan.kind == "grid" and cluster_plan_before(B, T, D, H) is None and plan.cluster == 1
    assert plan.threads <= port.GRID_THREADS  # the kernel's launch bound
    # at most one block an SM of the card's 132, each owning `units` hidden
    # units, every unit owned once
    assert 1 <= plan.grid <= 132 and (plan.grid - 1) * plan.units < H <= plan.grid * plan.units
    assert plan.threads % plan.kslices == 0 and plan.threads // plan.kslices <= 4 * plan.units
    assert plan.rows in port.GRID_ROWS and (plan.rows >= min(B, port.GRID_ROWS[-1]) or not plan.resident)
    Kp = -(-D // 4) * 4 + -(-H // 4) * 4
    assert plan.kchunk % 4 == 0 and 4 <= plan.kchunk <= Kp
    cols = 4 * plan.units
    floats = ((Kp * cols if plan.resident else 0) + plan.rows * plan.kchunk + plan.kslices * plan.rows * cols
              + plan.rows * cols + cols)  # grid_smem_floats in the source
    assert plan.smem_bytes == 4 * floats


# widths at D = H: the ones the cluster plan takes (up to 216, even, with a
# large enough portable cluster), every odd width from 79 up, the even ones
# whose largest portable cluster is small (114-130), and the wide ones up to
# 1,024, where the weight slice no longer fits a block even over the grid
PLAN_WIDTHS = [1, 2, 3, 7, 8, 16, 32, 64, 78, 79, 80, 113, 114, 118, 122, 126, 128, 129, 130, 131, 132, 133, 200,
               216, 217, 218, 255, 256, 257, 264, 300, 384, 500, 511, 512, 513, 640, 768, 900, 950, 951, 1000, 1023,
               1024]


@pytest.mark.parametrize("H", PLAN_WIDTHS)
def test_kernel_plan_takes_every_width(H):
    """A valid plan at D = H and at D != H (narrow and wide inputs), from
    one row to the league's 1,280, from T=1 to T=20,000."""
    for B, T, D in [(1, 1, H), (5, 3, H), (64, 1, H), (128, 17, H), (1280, 17, H), (4, 10_000, H), (2, 20_000, H),
                    (64, 1, 7), (8, 4, 4096)]:
        assert_valid_plan(port.kernel_plan(B, T, D, H), B, T, D, H)


def test_kernel_plan_covers_widths_1_to_1024():
    """Every width from 1 to 1,024 at D = H (B=64, T=17): the cluster plan
    for the 114 it took before, 216 the widest, and the grid plan for the
    other 910; at H=128 the grid plan past the cluster's T (its tile's
    resets sit whole in shared memory)."""
    kinds = {}
    for H in range(1, 1025):
        plan = port.kernel_plan(64, 17, H, H)
        assert_valid_plan(plan, 64, 17, H, H)
        kinds.setdefault(plan.kind, []).append(H)
    assert len(kinds["cluster"]) == 114 and max(kinds["cluster"]) == 216 and len(kinds["grid"]) == 910
    assert port.kernel_plan(4, 8_000, 128, 128).kind == "cluster"
    assert port.kernel_plan(4, 10_000, 128, 128).kind == "grid"


@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_kernel_plan_keeps_the_cluster_plan_of_every_path_shape(shape):
    """Every shape the port's paths launch (``chip_smoke.LSTM_SHAPES``)
    keeps the cluster plan it had, number for number."""
    plan = port.kernel_plan(*shape)
    assert plan.kind == "cluster"
    assert (plan.cluster, plan.rows, plan.grid, plan.threads, plan.kslices, plan.smem_bytes) == \
        cluster_plan_before(*shape)


@pytest.mark.parametrize("B,T,D,H", [(0, 1, 8, 8), (1, 0, 8, 8), (1, 1, 0, 8), (1, 1, 8, 0)])
def test_kernel_plan_refuses_empty_shapes(B, T, D, H):
    with pytest.raises(ValueError, match="empty"):
        port.kernel_plan(B, T, D, H)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 128), (5, 128), (63, 128), (65, 128), (5, 8)])
def test_kernel_matches_plain_across_tiles(cuda_device, B, H):
    """Batches that fill no tile, part of a tile and one row past a whole
    number of tiles, and the narrowest width a script runs."""
    args = to_torch(inputs(B=B, T=3, D=H, H=H, seed=B + H), device=cuda_device)
    got = port.lstm_sequence_kernel(*args)
    torch.cuda.synchronize()
    want = port.lstm_sequence_reference(*args)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 1), (32, 16)])
def test_kernel_is_deterministic(cuda_device, B, T):
    """Two launches on the same inputs give the same bits."""
    args = to_torch(inputs(B=B, T=T, D=128, H=128, seed=7), device=cuda_device)
    a = port.lstm_sequence_kernel(*args)
    b = port.lstm_sequence_kernel(*args)
    torch.cuda.synchronize()
    for x, y in zip((a[0], *a[1]), (b[0], *b[1])):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 1), (32, 16), (5, 3)])
def test_kernel_rows_are_independent(cuda_device, B, T):
    """Row 0's outputs have the same bits whether rows 1..B-1 hold zeros or
    random values: the serve engine's replay pads its batches differently."""
    x, h0, c0, wx, wh, b, r = to_torch(inputs(B=B, T=T, D=128, H=128, seed=8), device=cuda_device)
    quiet = [torch.zeros_like(t) for t in (x, h0, c0, r)]
    for q, t in zip(quiet, (x, h0, c0, r)):
        q[0] = t[0]
    a = port.lstm_sequence_kernel(x, h0, c0, wx, wh, b, r)
    z = port.lstm_sequence_kernel(quiet[0], quiet[1], quiet[2], wx, wh, b, quiet[3])
    torch.cuda.synchronize()
    for u, v in zip((a[0], *a[1]), (z[0], *z[1])):
        assert torch.equal(u[0], v[0])


def wide_atol(args, want):
    """The tolerance of the kernel against the plain version where K = D+H
    exceeds 256 (no cluster shape of the port's paths does): ATOL, or twice
    the plain version's own distance from the same function in f64 on the
    same inputs, whichever is larger. Both f32 evaluations sum 512-2,048
    products a gate in different orders, and at these inputs (weights of
    std 0.3, 6.8x the policy's lecun scale at H=512) each step of the
    recurrence amplifies the rounding of the steps before; the plain
    version's own error measures that amplification."""
    exact = port.lstm_sequence_reference(*(a.double() for a in args))
    own = max(float((a.double() - b).abs().max()) for a, b in zip((want[0], *want[1]), (exact[0], *exact[1])))
    return max(ATOL, 2 * own)


# grid-plan shapes: an odd width, the policy's H=512 at the serving step,
# the rollout step and the update, H=1,024 (the weight slice read from L2
# each step), the narrowest width the cluster refuses, H=128 past the
# cluster's T, and narrow inputs to a wide core
GRID_SHAPES = [(5, 3, 255, 255), (64, 1, 512, 512), (128, 1, 512, 512), (128, 17, 512, 512), (64, 1, 1024, 1024),
               (2, 1, 79, 79), (4, 10_000, 128, 128), (3, 4, 7, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", GRID_SHAPES)
def test_grid_kernel_matches_plain_on_cuda(cuda_device, B, T, D, H):
    """For CUDA tensors a shape the cluster plan cannot take launches the
    grid-wide kernel once (never the plain version), within ``wide_atol``
    of the plain version (ATOL where K <= 256)."""
    assert port.kernel_plan(B, T, D, H).kind == "grid"
    args = to_torch(inputs(B=B, T=T, D=D, H=H, seed=B + H), device=cuda_device)
    before = dict(port.lstm_sequence_kernel.launches_by_plan)
    got = port.lstm_sequence(*args)
    torch.cuda.synchronize()
    assert port.lstm_sequence_kernel.launches_by_plan["grid"] == before["grid"] + 1
    assert port.lstm_sequence_kernel.launches_by_plan["cluster"] == before["cluster"]
    want = port.lstm_sequence_reference(*args)
    atol = ATOL if D + H <= 256 else wide_atol(args, want)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        torch.testing.assert_close(g, w, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(64, 1, 512, 512), (128, 17, 512, 512), (5, 3, 255, 255), (16, 2, 1024, 1024)])
def test_grid_kernel_is_deterministic_and_rows_independent(cuda_device, B, T, D, H):
    """Two launches give the same bits, and row 0's bits do not depend on
    what rows 1..B-1 hold, nor on B: the serve engine's replay relies on
    both."""
    x, h0, c0, wx, wh, b, r = to_torch(inputs(B=B, T=T, D=D, H=H, seed=8), device=cuda_device)
    a = port.lstm_sequence_kernel(x, h0, c0, wx, wh, b, r)
    a2 = port.lstm_sequence_kernel(x, h0, c0, wx, wh, b, r)
    quiet = [torch.zeros_like(t) for t in (x, h0, c0, r)]
    for q, t in zip(quiet, (x, h0, c0, r)):
        q[0] = t[0]
    z = port.lstm_sequence_kernel(quiet[0], quiet[1], quiet[2], wx, wh, b, quiet[3])
    one = port.lstm_sequence_kernel(x[:1].contiguous(), h0[:1].contiguous(), c0[:1].contiguous(), wx, wh, b,
                                    r[:1].contiguous())
    torch.cuda.synchronize()
    for u, v, q, o in zip((a[0], *a[1]), (a2[0], *a2[1]), (z[0], *z[1]), (one[0], *one[1])):
        assert torch.equal(u, v)
        assert torch.equal(u[0], q[0]) and torch.equal(u[0], o[0])


# -- the recompute backward ---------------------------------------------------


def jax_grads(args, cotangents):
    """Gradients of x, h0, c0, wx, wh and b through the Pallas kernel's
    custom VJP (interpret mode) under one cotangent of (hs, hT, cT)."""
    import jax

    from dotaclient_tpu.ops.pallas.lstm import lstm_sequence_pallas

    x, h0, c0, wx, wh, b, r = to_jax(args)
    g_hs, g_hT, g_cT = (jnp.asarray(c) for c in cotangents)

    def loss(*diff):
        hs, (hT, cT) = lstm_sequence_pallas(*diff, r, True)
        return (hs * g_hs).sum() + (hT * g_hT).sum() + (cT * g_cT).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(x, h0, c0, wx, wh, b)]


def cotangents_for(B, T, H, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in ((B, T, H), (B, H), (B, H))]


def function_grads(args, cotangents, forward_impl, device="cpu"):
    """Gradients of the six differentiable inputs through
    ``LSTMSequenceFunction`` with ``forward_impl`` under the cotangent."""
    ts = to_torch(args, device)
    diff = [t.requires_grad_(True) for t in ts[:6]]
    hs, hT, cT = port.LSTMSequenceFunction.apply(forward_impl, *diff, ts[6])
    outs = (hs, hT, cT)
    grads = torch.autograd.grad(outs, diff, [torch.from_numpy(c).to(device) for c in cotangents])
    return outs, grads


@pytest.mark.parametrize("B,T", [(4, 5), (3, 1)])
def test_function_grads_match_jax_grad_through_pallas(B, T):
    """The Function on the CPU, its plain forward passed explicitly, against
    jax.grad through lstm_sequence_pallas(..., interpret=True): f32, atol
    1e-5 on every gradient."""
    args = inputs(B=B, T=T, D=8, H=16, seed=20 + B + T)
    cot = cotangents_for(B, T, 16, seed=B * T)
    _, got = function_grads(args, cot, port.lstm_sequence_reference)
    for g, w, name in zip(got, jax_grads(args, cot), ("x", "h0", "c0", "wx", "wh", "b")):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL, err_msg=name)


def test_function_grads_equal_autograd_through_plain_version():
    """On the same inputs the Function's gradients are those of autograd
    through the plain version (the recompute is that backward, bitwise)."""
    args = inputs(B=5, T=4, D=8, H=16, seed=31)
    cot = cotangents_for(5, 4, 16, seed=32)
    outs, got = function_grads(args, cot, port.lstm_sequence_reference)
    ts = to_torch(args)
    diff = [t.requires_grad_(True) for t in ts[:6]]
    hs, (hT, cT) = port.lstm_sequence_reference(*diff, ts[6])
    want = torch.autograd.grad((hs, hT, cT), diff, [torch.from_numpy(c) for c in cot])
    for o, w in zip(outs, (hs, hT, cT)):
        assert torch.equal(o, w)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dispatch_on_cpu_keeps_autograd_through_plain_version():
    """CPU tensors that need a gradient take the plain version, and the
    gradient reaches the weights."""
    ts = to_torch(inputs(seed=33))
    wx = ts[3].requires_grad_(True)
    hs, _ = port.lstm_sequence(ts[0], ts[1], ts[2], wx, ts[4], ts[5], ts[6])
    hs.sum().backward()
    assert wx.grad is not None and wx.grad.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(32, 17), (128, 17), (5, 3)])
def test_function_with_kernel_matches_plain_autograd_on_cuda(cuda_device, B, T):
    """On the card: lstm_sequence with a gradient wanted routes through the
    Function and launches the kernel once; outputs within 1e-5 of the plain
    version and every gradient within 1e-5 of its largest magnitude."""
    D = H = 128 if B > 5 else 32
    args = inputs(B=B, T=T, D=D, H=H, seed=B + T)
    cot = [torch.from_numpy(c).to(cuda_device) for c in cotangents_for(B, T, H, seed=B)]
    ts = to_torch(args, cuda_device)
    diff = [t.clone().requires_grad_(True) for t in ts[:6]]
    before = port.lstm_sequence_kernel.launches
    hs, (hT, cT) = port.lstm_sequence(*diff, ts[6])
    got = torch.autograd.grad((hs, hT, cT), diff, cot)
    assert port.lstm_sequence_kernel.launches == before + 1
    ref = [t.clone().requires_grad_(True) for t in ts[:6]]
    rhs, (rhT, rcT) = port.lstm_sequence_reference(*ref, ts[6])
    want = torch.autograd.grad((rhs, rhT, rcT), ref, cot)
    for o, w in zip((hs, hT, cT), (rhs, rhT, rcT)):
        torch.testing.assert_close(o, w, rtol=0, atol=ATOL)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
def test_train_step_with_kernel_matches_plain_on_cuda(cuda_device):
    """One PPO update on a chunk from the port's own device rollout, from the
    same state with the kernel and with ``use_kernel=False``, at f32
    compute: loss within 1e-5, each gradient within 1e-4 of its largest
    magnitude, and the kernel launched once in the update's forward (the
    recompute backward launches none)."""
    import dataclasses

    from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
    from dotaclient_tpu_torch.config import ModelConfig, RunConfig
    from dotaclient_tpu_torch.models.policy import init_params, make_policy
    from dotaclient_tpu_torch.train import ppo

    cfg = RunConfig()
    cfg = dataclasses.replace(
        cfg, model=ModelConfig(dtype="float32"),
        env=dataclasses.replace(cfg.env, n_envs=16, max_dota_time=1.0),
    )
    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device=cuda_device)
    init_params(policy, torch.Generator().manual_seed(0))
    actor = DeviceActor(cfg, policy, seed=0, device=cuda_device)
    with torch.no_grad():
        _, chunk, _ = actor._rollout_impl(policy, actor.state)
    state = ppo.init_train_state(policy, cfg.ppo)
    out = {}
    for use_kernel in (True, False):
        s = state.clone()
        before = port.lstm_sequence_kernel.launches
        loss, _ = ppo.ppo_loss(s.policy, chunk, cfg.ppo, step=0, use_kernel=use_kernel)
        named = list(s.policy.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        assert port.lstm_sequence_kernel.launches - before == (1 if use_kernel else 0)
        out[use_kernel] = (loss.detach(), {n: g for (n, _), g in zip(named, grads)})
    (lk, gk), (lp, gp) = out[True], out[False]
    assert abs(float(lk) - float(lp)) <= 1e-5
    assert gk["core.wx"].abs().max() > 0
    for name, g in gk.items():
        assert (g - gp[name]).abs().max() <= 1e-4 * gp[name].abs().max(), name

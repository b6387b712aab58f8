"""The port's whole-sequence LSTM held against the JAX package's.

The port's plain version (``lstm_sequence_reference``) must equal the JAX
spec and the Pallas kernel (in interpret mode, as tests/test_pallas.py runs
it) on the same numpy inputs, at f32 with atol 1e-5 (both sides accumulate
the gate products in f32, in different orders). The kernel's launch plan is
pure Python and is checked here; the CUDA kernel itself is compared with the
plain version in the ``cuda`` cases, which need a card
(``python -m pytest tests/test_torch_lstm.py -m cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("D,H", [(512, 512), (128, 1024), (4096, 128)])
def test_kernel_plan_refuses_shapes_past_the_limit(D, H):
    with pytest.raises(ValueError, match="shared memory"):
        port.kernel_plan(8, 4, D, H)


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


@pytest.mark.cuda
def test_kernel_refuses_shapes_past_the_plan(cuda_device):
    """For CUDA tensors a shape the plan refuses raises; it never falls back
    to the plain version."""
    args = to_torch(inputs(B=2, T=1, D=512, H=512, seed=9), device=cuda_device)
    before = port.lstm_sequence_kernel.launches
    with pytest.raises(ValueError, match="shared memory"):
        port.lstm_sequence(*args)
    assert port.lstm_sequence_kernel.launches == before


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

"""The port's policy held against the flax ``Policy`` on the same params.

At ``dtype="float32"`` both sides compute in f32 and agree to 1e-5. At the
default bf16 compute dtype they round at different places: flax casts the
LSTM weights and gates to bf16, while the port runs the LSTM kernel in f32
and converts at its boundary, and the two frameworks round bf16 sums and
products in their own order. The largest values compared are the cell
state c, in [2, 4), where one bf16 ulp is 1/64; the worst deviation seen
over 8 seeds of these tests was 0.0156, one such ulp. The bf16 cases allow
atol 0.03, two ulps, on logits, value and carry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu_torch.models import convert, flax_param_shapes
from dotaclient_tpu_torch.models.policy import mask_carry
from dotaclient_tpu_torch.ops.lstm import kernel_plan
from tests.test_torch_common import (
    flax_params,
    flax_shapes,
    jax_policy,
    np32,
    port_policy,
    random_obs,
    small_configs,
    to_jax,
    to_torch,
)

TOL = {"float32": 1e-5, "bfloat16": 0.03}
B, T = 4, 5


def random_carry(H, seed):
    """A nonzero carry with c != h, in flax's (c, h) order."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H)).astype(np.float32), (rng.normal(size=(B, H)) * 0.5).astype(np.float32))


def jax_carry(carry, dtype):
    return tuple(jnp.asarray(c).astype(dtype) for c in carry)


def torch_carry(carry, dtype):
    return tuple(torch.from_numpy(c).to(dtype) for c in carry)


def _dtypes(name):
    return {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[name]


def test_convert_matches_init_params():
    jcfg, pcfg = small_configs()
    params = flax_params(jcfg)
    p = params["params"]
    state = convert(params)
    policy = port_policy(pcfg, params)
    assert set(state) == set(policy.state_dict())
    np.testing.assert_array_equal(
        state["unit_encoder.dense1.weight"].numpy(), p["unit_encoder"]["Dense_1"]["kernel"].T
    )
    np.testing.assert_array_equal(state["hero_embed.weight"].numpy(), p["hero_embed"]["embedding"])
    H = pcfg.model.hidden_dim
    for gi, g in enumerate("ifgo"):
        cols = slice(gi * H, (gi + 1) * H)
        np.testing.assert_array_equal(state["core.wx"][:, cols].numpy(), p["core"][f"i{g}"]["kernel"])
        np.testing.assert_array_equal(state["core.wh"][:, cols].numpy(), p["core"][f"h{g}"]["kernel"])
        np.testing.assert_array_equal(state["core.b"][cols].numpy(), p["core"][f"h{g}"]["bias"])
    # the slim (serving) tree converts without head_value
    slim = flax_params(jcfg, value_head=False)
    assert set(convert(slim)) == set(port_policy(pcfg, slim, value_head=False).state_dict())


@pytest.mark.parametrize("value_head", [True, False])
def test_flax_param_shapes_match_init(value_head):
    jcfg, pcfg = small_configs()
    want = jax.tree.map(lambda a: tuple(a.shape), flax_shapes(jcfg, value_head))
    got = flax_param_shapes(pcfg, value_head=value_head)
    assert jax.tree_util.tree_structure(got, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree_util.tree_structure(want, is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple))


def assert_outputs_close(jax_out, port_out, tol):
    (lj, vj, cj), (lp, vp, cp) = jax_out, port_out
    assert set(lj) == set(lp)
    for head in lj:
        np.testing.assert_allclose(np32(lp[head]), np32(lj[head]), rtol=0, atol=tol, err_msg=head)
    np.testing.assert_allclose(np32(vp), np32(vj), rtol=0, atol=tol)
    for a, b in zip(cp, cj):  # (c, h) on both sides
        np.testing.assert_allclose(np32(a), np32(b), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_matches_flax(dtype):
    jcfg, pcfg = small_configs(dtype)
    params = flax_params(jcfg, seed=1)
    jdt, tdt = _dtypes(dtype)
    obs = random_obs(pcfg, (B,), seed=2)
    carry = random_carry(pcfg.model.hidden_dim, seed=3)
    want = jax_policy(jcfg)[1](params, to_jax(obs), jax_carry(carry, jdt))
    with torch.no_grad():
        got = port_policy(pcfg, params).step(to_torch(obs), torch_carry(carry, tdt))
    assert got[2][0].dtype == tdt and got[2][0].shape == (B, pcfg.model.hidden_dim)
    assert_outputs_close(want, got, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequence_matches_flax(dtype):
    jcfg, pcfg = small_configs(dtype)
    params = flax_params(jcfg, seed=4)
    jdt, tdt = _dtypes(dtype)
    obs = random_obs(pcfg, (B, T), seed=5)
    carry = random_carry(pcfg.model.hidden_dim, seed=6)
    dones = (np.random.default_rng(7).random((B, T)) < 0.3).astype(np.float32)
    want = jax_policy(jcfg)[2](params, to_jax(obs), jax_carry(carry, jdt), jnp.asarray(dones))
    with torch.no_grad():
        got = port_policy(pcfg, params).sequence(
            to_torch(obs), torch_carry(carry, tdt), torch.from_numpy(dones)
        )
    assert got[0]["move_x"].shape == (B, T, pcfg.actions.move_bins)
    assert_outputs_close(want, got, TOL[dtype])


def test_sequence_matches_flax_at_a_grid_width():
    """At hidden_dim 130 (even, but its largest portable cluster is 2, so
    on the card only the grid plan takes it) the port's policy sequence
    against flax's at f32, as at the small config's width."""
    jcfg, pcfg = (dataclasses.replace(c, model=dataclasses.replace(c.model, hidden_dim=130)) for c in small_configs())
    assert kernel_plan(B, T, 130, 130).kind == "grid"
    params = flax_params(jcfg, seed=21)
    obs = random_obs(pcfg, (B, T), seed=22)
    carry = random_carry(130, seed=23)
    dones = (np.random.default_rng(24).random((B, T)) < 0.3).astype(np.float32)
    want = jax_policy(jcfg)[2](params, to_jax(obs), jax_carry(carry, jnp.float32), jnp.asarray(dones))
    with torch.no_grad():
        got = port_policy(pcfg, params).sequence(
            to_torch(obs), torch_carry(carry, torch.float32), torch.from_numpy(dones)
        )
    assert got[2][0].shape == (B, 130)
    assert_outputs_close(want, got, TOL["float32"])


def test_sequence_equals_steps_with_resets():
    """sequence() over T steps == T calls of step() with the carry masked
    wherever the previous step ended an episode."""
    _, pcfg = small_configs()
    jcfg, _ = small_configs()
    policy = port_policy(pcfg, flax_params(jcfg, seed=8))
    obs = to_torch(random_obs(pcfg, (B, T), seed=9))
    dones = torch.from_numpy((np.random.default_rng(10).random((B, T)) < 0.4).astype(np.float32))
    carry0 = torch_carry(random_carry(pcfg.model.hidden_dim, seed=11), torch.float32)
    with torch.no_grad():
        seq_logits, seq_value, seq_carry = policy.sequence(obs, carry0, dones)
        carry = carry0
        for t in range(T):
            if t > 0:
                carry = mask_carry(carry, 1.0 - dones[:, t - 1])
            logits, value, carry = policy.step({k: v[:, t] for k, v in obs.items()}, carry)
            for head in logits:
                torch.testing.assert_close(logits[head], seq_logits[head][:, t], rtol=0, atol=1e-6)
            torch.testing.assert_close(value, seq_value[:, t], rtol=0, atol=1e-6)
    for a, b in zip(carry, seq_carry):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_carry_order_is_flax_c_h():
    """The port's carry is (c, h) like flax's OptimizedLSTMCell, while the
    kernel takes (h0, c0): the step must match flax with c != h, and the
    swapped carry must NOT (the test has teeth against a swap)."""
    jcfg, pcfg = small_configs()
    params = flax_params(jcfg, seed=12)
    obs = random_obs(pcfg, (B,), seed=13)
    c, h = random_carry(pcfg.model.hidden_dim, seed=14)
    want_logits, _, (want_c, want_h) = jax_policy(jcfg)[1](
        params, to_jax(obs), (jnp.asarray(c), jnp.asarray(h))
    )
    policy = port_policy(pcfg, params)
    with torch.no_grad():
        logits, _, (got_c, got_h) = policy.step(to_torch(obs), (torch.from_numpy(c), torch.from_numpy(h)))
        swapped, _, _ = policy.step(to_torch(obs), (torch.from_numpy(h), torch.from_numpy(c)))
    np.testing.assert_allclose(np32(got_c), np.asarray(want_c), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np32(got_h), np.asarray(want_h), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np32(logits["action_type"]), np.asarray(want_logits["action_type"]), atol=1e-5)
    assert np.abs(np32(swapped["action_type"]) - np.asarray(want_logits["action_type"])).max() > 1e-3


def test_slim_policy_logits_match_full_value_zero():
    jcfg, pcfg = small_configs()
    params = flax_params(jcfg, seed=15)
    obs = to_torch(random_obs(pcfg, (B,), seed=16))
    full, slim = port_policy(pcfg, params), port_policy(pcfg, params, value_head=False)
    with torch.no_grad():
        lf, _, cf = full.step(obs, full.initial_state(B))
        ls, vs, cs = slim.step(obs, slim.initial_state(B))
    for head in lf:
        torch.testing.assert_close(lf[head], ls[head], rtol=0, atol=0)
    assert torch.count_nonzero(vs) == 0


def test_dummy_obs_batch_matches_jax_layout():
    from dotaclient_tpu.models.policy import dummy_obs_batch as jax_dummy
    from dotaclient_tpu_torch.models.policy import dummy_obs_batch

    jcfg, pcfg = small_configs()
    for time_ in (None, 3):
        want = jax_dummy(2, jcfg.obs, jcfg.actions, time=time_)
        got = dummy_obs_batch(2, pcfg.obs, pcfg.actions, time=time_, device="cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k

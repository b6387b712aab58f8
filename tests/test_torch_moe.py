"""The port's MoE against the JAX package's, on the CPU at f32.

* ``parallel/expert.py``: ``expert_capacity`` and ``route_top1`` give the
  JAX package's dispatch bit for bit (ties aside, a 0/1 tensor), its
  combine and its gate softmax within 1e-6, with and without tokens dropped
  at capacity; a token's routing never depends on the rows after it, and
  with room for every token not on the other rows at all.
* ``models/moe.py``: ``MoEMLP`` against the Flax module on the same params
  (atol 1e-5), its returned routing stats against the sown ones.
* ``train/ppo.py``: ``_moe_aux_loss`` against the JAX package's on the same
  stats with a ``valid`` mask (atol 1e-6); the dense and LSTM cores' term
  is 0, as ``tests/test_moe.py`` holds for the reference.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu import config as jax_config
from dotaclient_tpu.models.moe import MoEMLP as FlaxMoEMLP
from dotaclient_tpu.parallel import expert as jexpert
from dotaclient_tpu.train.ppo import _moe_aux_loss as jax_moe_aux_loss
from dotaclient_tpu_torch import config as port_config
from dotaclient_tpu_torch.models.moe import MoEMLP
from dotaclient_tpu_torch.parallel import expert as pexpert
from dotaclient_tpu_torch.train.ppo import _moe_aux_loss, example_batch, ppo_loss

E, D = 4, 32


def gate_inputs(B, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)).astype(np.float32)
    gate = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    return x, gate


@pytest.mark.parametrize("B,cf", [(8, 2.0), (16, 1.0), (13, 0.5), (5, 8.0)])
def test_expert_capacity_matches_jax(B, cf):
    assert pexpert.expert_capacity(B, E, cf) == jexpert.expert_capacity(B, E, cf)


@pytest.mark.parametrize("B,cf", [(16, 2.0), (16, 0.5), (33, 1.0)])
def test_route_top1_matches_jax(B, cf):
    x, gate = gate_inputs(B, seed=B)
    C = jexpert.expert_capacity(B, E, cf)
    jd, jc, jp = (np.asarray(a) for a in jexpert.route_top1(jnp.asarray(x), jnp.asarray(gate), E, C))
    pd, pc, pp = (t.numpy() for t in pexpert.route_top1(torch.from_numpy(x), torch.from_numpy(gate), E, C))
    assert pd.shape == jd.shape == (B, E, C)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-6)
    kept = pd.sum(axis=(1, 2))
    if cf < 1.0:
        # the drop case: some tokens found their expert full
        assert (kept == 0).any()
    # a kept token sits in exactly one slot; no slot holds two tokens
    assert set(np.unique(kept)) <= {0.0, 1.0} and pd.sum(axis=0).max() <= 1.0


def test_a_tokens_routing_is_its_own_up_to_capacity():
    """A token's expert and weight do not change with the other rows: row 0
    (first in batch order) even at capacity 1, and every row when each
    expert has room for all B tokens."""
    B = 12
    x, gate = gate_inputs(B, seed=5)
    other, _ = gate_inputs(B, seed=6)

    def weights(rows, C):
        _, combine, _ = pexpert.route_top1(torch.from_numpy(rows), torch.from_numpy(gate), E, C)
        return combine.sum(dim=2)                      # [B, E]: the kept token's expert and gate weight

    for C, rows in ((1, [0]), (B, range(B))):
        alone = weights(x, C)
        for r in rows:
            mixed = other.copy()
            mixed[r] = x[r]
            torch.testing.assert_close(weights(mixed, C)[r], alone[r], rtol=0, atol=0)


def test_moe_mlp_matches_flax():
    B, cf = 16, 1.0   # capacity 4 a expert: the FFN runs with drops too
    cfg = dataclasses.replace(jax_config.ModelConfig(), hidden_dim=D, moe_experts=E, moe_capacity_factor=cf,
                              dtype="float32", core="transformer")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, D)).astype(np.float32)
    params = {
        "gate": rng.standard_normal((D, E)) / np.sqrt(D),
        "expert_w1": rng.standard_normal((E, D, 4 * D)) / np.sqrt(D),
        "expert_b1": rng.standard_normal((E, 4 * D)) * 0.1,
        "expert_w2": rng.standard_normal((E, 4 * D, D)) / np.sqrt(4 * D),
        "expert_b2": rng.standard_normal((E, D)) * 0.1,
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    module = FlaxMoEMLP(cfg)
    jy, sown = module.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    port = MoEMLP(D, E, cf, torch.device("cpu"))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        py, (probs, frac) = port(torch.from_numpy(x))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(sown["losses"]["moe_probs"][0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(frac.numpy(), np.asarray(sown["losses"]["moe_frac"][0]))
    assert frac.sum() < B   # some tokens were dropped


def test_moe_aux_loss_matches_jax_with_a_valid_mask():
    rng = np.random.default_rng(3)
    B, T, layers = 6, 5, 2
    valid = (rng.random((B, T)) < 0.7).astype(np.float32)
    col, port_stats = {}, []
    for layer in range(layers):
        probs = rng.dirichlet(np.ones(E), size=(T + 1, B)).astype(np.float32)     # [T+1, B, E]
        frac = np.eye(E, dtype=np.float32)[rng.integers(0, E, size=(T + 1, B))]
        frac[rng.random((T + 1, B)) < 0.2] = 0.0                                   # dropped tokens
        col[f"block_{layer}"] = {"moe": {"moe_probs": (jnp.asarray(probs),), "moe_frac": (jnp.asarray(frac),)}}
        port_stats.append((torch.from_numpy(probs), torch.from_numpy(frac)))
    want = float(jax_moe_aux_loss({"core": col}, jnp.asarray(valid)))
    got = float(_moe_aux_loss(tuple(port_stats), torch.from_numpy(valid)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("core", ["lstm", "transformer"])
def test_dense_cores_have_zero_aux(core):
    from dotaclient_tpu_torch.models.policy import init_params, make_policy

    cfg = port_config.default_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, core=core, hidden_dim=16, n_heads=2,
                                                             context_window=4, dtype="float32"),
                              ppo=dataclasses.replace(cfg.ppo, rollout_len=4))
    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(0))
    _, metrics = ppo_loss(policy, example_batch(cfg, 2, device="cpu"), cfg.ppo)
    assert float(metrics["moe_aux"]) == 0.0

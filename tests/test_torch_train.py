"""The port's training math against the JAX package's (``train/gae.py``,
``train/ppo.py``, the Flax initializers).

Two PPO updates from the same (converted) params on the same batch must give
the same loss, metrics, pre-clip gradient norm and updated params, at f32
compute with rtol 1e-4 and atol 1e-6, for every lever of the loss and the
step. Two updates, so Adam's moments and bias correction count.

Adam's first update divides each gradient element by its own magnitude
(plus eps 1e-8), so an element whose exact value is 0 but which both sides
compute as cancellation noise (~1e-9, different on each side) moves by a
noise-set fraction of the learning rate: with batch seed 2, one element in
the warmup case ends 2.3e-5 apart, from gradients of -1.7e-9 and -2.3e-9.
So the updated params are compared outside the elements whose reference
gradient (as the optimizer sees it, after the warmup mask) was nonzero but
below NOISE_FLOOR of its leaf's largest in this or an earlier update: a
rule on the gradient, over several batch seeds, with the share it leaves
out bounded by MAX_EXCLUDED. Exact zeros stay in: they are structural (a
dead ReLU unit, a hero id no frame holds), zero on both sides, and Adam
leaves their params where they were.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dotaclient_tpu_torch.config import ModelConfig, RunConfig
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models import distributions as PD
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.train import gae as pgae
from dotaclient_tpu_torch.train import ppo as pppo
from tests.test_torch_common import flax_params, jax_policy, port_policy, random_obs, small_configs, to_torch

# the JAX package's train/__init__ re-exports functions under the module names
jgae = importlib.import_module("dotaclient_tpu.train.gae")
jppo = importlib.import_module("dotaclient_tpu.train.ppo")

RTOL, ATOL = 1e-4, 1e-6
B, T = 4, 5
NOISE_FLOOR = 1e-6    # of a leaf's largest gradient: below it, a direction set by rounding
MAX_EXCLUDED = 0.01   # share of all param elements the rule may leave out


def adv_inputs(seed, B=5, T=7):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(B, T)).astype(np.float32),
        rng.normal(size=(B, T + 1)).astype(np.float32),
        (rng.random((B, T)) < 0.25).astype(np.float32),
        (rng.normal(size=(B, T)) * 0.3 - 1.0).astype(np.float32),
        (rng.normal(size=(B, T)) * 0.3 - 1.0).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_matches_jax(seed):
    r, v, d, _, _ = adv_inputs(seed)
    want = jgae.gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), 0.99, 0.95)
    got = pgae.gae(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(d), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_jax(clips):
    r, v, d, blp, tlp = adv_inputs(7)
    want = jgae.vtrace(*(jnp.asarray(a) for a in (r, v, d, blp, tlp)), 0.99, *clips)
    got = pgae.vtrace(*(torch.from_numpy(a) for a in (r, v, d, blp, tlp)), 0.99, *clips)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the limit the gradient passes unchanged, above it scales to the
    limit, as optax's transform does (no epsilon)."""
    rng = np.random.default_rng(3)
    grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((4, 3), (7,))]
    want, _ = optax.clip_by_global_norm(0.5).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    tg = [torch.from_numpy(g) for g in grads]
    got = pppo.clip_by_global_norm(tg, 0.5, pppo.global_norm(tg))
    np.testing.assert_allclose(float(pppo.global_norm(tg)), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# -- init_params: Flax's distributions ----------------------------------------


def test_init_params_draws_flax_distributions():
    """At the default width, the distributions of Flax's initializers (their
    formulas, from ``jax.nn.initializers``): zero biases; Dense kernels and
    the LSTM input kernels lecun-normal, i.e. a normal truncated at 2
    standard deviations and rescaled to variance 1/fan_in (standard
    deviation within 8%, no value past the truncation); the embedding
    normal with variance 1/embed_dim (Flax's fan-in at out_axis=0); each
    [H, H] recurrent gate block orthogonal. Seeded."""
    cfg = RunConfig()
    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(0))
    state = policy.state_dict()
    H = cfg.model.hidden_dim
    for name, t in state.items():
        if name.endswith(".bias") or name == "core.b":
            assert not t.any(), name
            continue
        if name == "core.wh":
            for k in range(4):
                q = t[:, k * H:(k + 1) * H]
                torch.testing.assert_close(q.T @ q, torch.eye(H), rtol=0, atol=1e-5)
            continue
        if name == "hero_embed.weight":
            std = (1.0 / t.shape[1]) ** 0.5
        else:
            fan_in = t.shape[0] if name == "core.wx" else t.shape[1]   # Linear weight is [out, in]
            std = (1.0 / fan_in) ** 0.5
            assert float(t.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6, name
        if t.numel() >= 256:
            assert abs(float(t.std()) / std - 1.0) < 0.08, (name, float(t.std()), std)
    again = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    init_params(again, torch.Generator().manual_seed(0))
    for name, t in again.state_dict().items():
        assert torch.equal(t, state[name]), name


# -- two PPO updates against the JAX package ---------------------------------


LEVERS = {
    "default": {},
    "value_warmup": {"value_warmup_steps": 1},
    "kl_target": {"kl_target": 0.001},
    "adv_norm_floor": {"adv_norm_floor": 5.0},
    "vtrace": {"advantage": "vtrace"},
    "anchor_kl": {"anchor_kl_coef": 0.5},
}


def ppo_configs(lever):
    jcfg, pcfg = small_configs()
    over = dict(LEVERS[lever], rollout_len=T)
    return (dataclasses.replace(jcfg, ppo=dataclasses.replace(jcfg.ppo, **over)),
            dataclasses.replace(pcfg, ppo=dataclasses.replace(pcfg.ppo, **over)))


def make_batch(pcfg, params, seed=0):
    """A batch [B, T(+1)] of the kind the rollout makes: legal actions
    sampled from the policy, behaviour log-probs near the policy's own,
    episode ends inside the chunk, a nonzero initial carry."""
    rng = np.random.default_rng(seed)
    H = pcfg.model.hidden_dim
    obs = random_obs(pcfg, (B, T + 1), seed=seed)
    carry0 = ((rng.normal(size=(B, H)) * 0.5).astype(np.float32), (rng.normal(size=(B, H)) * 0.5).astype(np.float32))
    dones = (rng.random((B, T)) < 0.2).astype(np.float32)
    policy = port_policy(pcfg, params)
    tobs = to_torch(obs)
    with torch.no_grad():
        logits, _, _ = policy.sequence(tobs, tuple(torch.from_numpy(c) for c in carry0), torch.from_numpy(dones))
        logits_t = {k: v[:, :T] for k, v in logits.items()}
        obs_t = {k: v[:, :T] for k, v in tobs.items()}
        actions, logp = PD.sample(logits_t, obs_t, generator=torch.Generator().manual_seed(seed))
    return {
        "obs": obs,
        "actions": {k: v.numpy().astype(np.int32) for k, v in actions.items()},
        "behavior_logp": (logp.numpy() + rng.normal(size=(B, T)) * 0.3).astype(np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "dones": dones,
        "valid": np.ones((B, T), np.float32),
        "carry0": carry0,
    }


def batch_to(batch, fn):
    return {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else tuple(fn(c) for c in v) if isinstance(v, tuple) else fn(v))
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_train_step(jcfg):
    """The JAX package's update, jitted once per config, beside the gradient
    its optimizer sees (the loss's gradient with the warmup mask applied)."""
    policy = jax_policy(jcfg)[0]
    warm = jcfg.ppo.value_warmup_steps

    def step(state, batch, anchor):
        grads = jax.grad(lambda p: jppo.ppo_loss(policy, p, batch, jcfg.ppo, step=state.step,
                                                 anchor_params=anchor)[0])(state.params)
        if warm:
            on = (state.step >= warm).astype(jnp.float32)
            grads = jax.tree_util.tree_map_with_path(
                lambda path, g: g if any(getattr(k, "key", None) == "head_value" for k in path) else g * on, grads)
        return (*jppo._train_step(policy, jcfg.ppo, state, batch, anchor_params=anchor, probe=True), grads)

    return jax.jit(step)


def jax_inputs(jcfg, pcfg, lever, seed):
    """The converted-from params, the batch of ``seed`` and the JAX side's
    state, batch and anchor params."""
    params = flax_params(jcfg, seed=1)
    batch = make_batch(pcfg, params, seed=seed)
    anchor_params = flax_params(jcfg, seed=5) if lever == "anchor_kl" else None
    jstate = jppo.init_train_state(jax.tree.map(jnp.asarray, params), jcfg.ppo)
    janchor = jax.tree.map(jnp.asarray, anchor_params) if anchor_params is not None else None
    return params, batch, anchor_params, (jstate, batch_to(batch, jnp.asarray), janchor)


@pytest.fixture(scope="module", params=list(LEVERS))
def lever(request):
    """A lever of the loss or the step, its JAX update compiled once here."""
    jcfg, pcfg = ppo_configs(request.param)
    jax.block_until_ready(jax_train_step(jcfg)(*jax_inputs(jcfg, pcfg, request.param, 0)[3]))
    return request.param


@pytest.mark.parametrize("seed", [2, 4, 6])
def test_two_train_steps_match_jax(lever, seed):
    jcfg, pcfg = ppo_configs(lever)
    params, batch, anchor_params, (jstate, jbatch, janchor) = jax_inputs(jcfg, pcfg, lever, seed)
    step = jax_train_step(jcfg)
    pstate = pppo.init_train_state(port_policy(pcfg, params), pcfg.ppo)
    pbatch = batch_to(batch, lambda a: torch.from_numpy(np.array(a)))
    anchor = port_policy(pcfg, anchor_params).requires_grad_(False) if anchor_params is not None else None

    noisy = {}
    for i in range(2):
        jstate, jm, jgrads = step(jstate, jbatch, janchor)
        pstate, pm = pppo._train_step(pcfg.ppo, pstate, pbatch, anchor=anchor)
        assert set(pm) == set(jm), (lever, i, set(pm) ^ set(jm))
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{lever} seed {seed} step {i}: metric {k}")
        for name, g in convert(jax.tree.map(np.asarray, jgrads)).items():
            tiny = (g != 0) & (g.abs() < NOISE_FLOOR * g.abs().max())
            noisy[name] = noisy[name] | tiny if name in noisy else tiny
        want = convert(jax.tree.map(np.asarray, jstate.params))
        got = pstate.policy.state_dict()
        for name, w in want.items():
            keep = ~noisy[name]
            np.testing.assert_allclose(got[name][keep].numpy(), w[keep].numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{lever} seed {seed} step {i}: param {name}")
    excluded = sum(int(m.sum()) for m in noisy.values())
    assert excluded <= MAX_EXCLUDED * sum(m.numel() for m in noisy.values()), (lever, seed, excluded)
    assert pstate.step == 2 and int(jstate.step) == 2


def test_warmup_freezes_the_policy_and_trains_the_value_head():
    _, pcfg = ppo_configs("value_warmup")
    jcfg, _ = ppo_configs("value_warmup")
    params = flax_params(jcfg, seed=3)
    state = pppo.init_train_state(port_policy(pcfg, params), pcfg.ppo)
    before = {k: v.clone() for k, v in state.policy.state_dict().items()}
    state, m = pppo._train_step(pcfg.ppo, state, batch_to(make_batch(pcfg, params, 4),
                                                         lambda a: torch.from_numpy(np.array(a))))
    for name, t in state.policy.state_dict().items():
        moved = not torch.equal(t, before[name])
        assert moved == name.startswith("head_value"), name
    assert float(m["health_ok"]) == 1.0


def test_fold_scan_metrics_takes_last_and_and_folds_health():
    seq = [{"loss": torch.tensor(float(i)), "health_ok": torch.tensor(h)} for i, h in enumerate((1.0, 0.0, 1.0))]
    out = pppo.fold_scan_metrics(seq)
    assert float(out["loss"]) == 2.0 and float(out["health_ok"]) == 0.0


def test_model_config_default_is_the_full_width():
    m = ModelConfig()
    assert (m.hidden_dim, m.unit_embed_dim, m.dtype, m.param_dtype) == (128, 64, "bfloat16", "float32")

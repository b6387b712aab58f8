"""The port's transformer core, everywhere its carry goes, against the JAX package.

Both packages get the same params (``models.convert.random_flax_params``
from a seed, converted to each) and the same numpy inputs, at H 32, 4 heads,
2 layers and a window of 8, dense and with 4 Switch experts:

* ``Policy.step`` and ``Policy.sequence`` (with episode ends mid-chunk)
  against Flax at f32 within 1e-5, the MoE routing stats too; at bf16 (the
  dense core) within ``BF16_TOL`` = 0.1 on logits, value and carry: a few
  bf16 ulps at their size (|logit| up to ~4 here), where XLA and torch round
  the GTrXL gates' bf16 elementwise chains differently (one ulp apart on
  ~20% of a gate's outputs). The port's ``sequence`` equals its own step
  loop bit for bit; ``mask_carry`` zeroes every nested leaf.
* one ``_train_step``: loss and metrics within 1e-4, every gradient within
  rtol 1e-3, MoE aux included.
* one device-rollout chunk against ``_rollout_impl`` fed the JAX side's
  noise (4 games, T=4): actions and dones equal, the rest within 1e-5.
* the wire: a JAX vec-pool chunk goes into the port's ring, and a port
  vec-pool chunk decodes in the JAX package with the same names and shapes
  (``carry0/0``, ``carry0/1/<layer>/<0|1>``); the serve engine's shadow
  rows are named ``c0..c4`` in JAX's leaf order with JAX's values; the
  weights frame of ``to_flax`` is the JAX encoder's byte for byte.
* the CLIs: the learner (buffered and fused) and the demo with ``--core
  transformer`` (``--moe-experts 4``); the league's frozen snapshots and
  evaluation; the scalar pool still refuses the core and ``--moe-experts``
  without it raises ``ValueError``, as in the JAX package.
"""

import dataclasses
import importlib
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.actor.device_rollout import DeviceActor as JaxDeviceActor
from dotaclient_tpu.actor.vec_runtime import VecActorPool as JaxVecActorPool
from dotaclient_tpu.buffer import TrajectoryBuffer as JaxTrajectoryBuffer
from dotaclient_tpu.models import distributions as JD
from dotaclient_tpu.models.policy import init_params as jax_init_params
from dotaclient_tpu.parallel import make_mesh
from dotaclient_tpu.serve.engine import ServeEngine as JaxServeEngine
from dotaclient_tpu.serve.policy_path import make_inference_policy as jax_inference_policy
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu.utils.telemetry import Registry as JaxRegistry
from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
from dotaclient_tpu_torch.actor.runtime import ActorPool
from dotaclient_tpu_torch.actor.vec_runtime import VecActorPool
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.envs import torch_lane_sim as S
from dotaclient_tpu_torch.league import OpponentPool, evaluate
from dotaclient_tpu_torch.models.convert import convert, flax_param_shapes, random_flax_params, to_flax
from dotaclient_tpu_torch.models.policy import Policy, init_params, make_policy, mask_carry
from dotaclient_tpu_torch.serve import ServeEngine, make_inference_policy
from dotaclient_tpu_torch.serve.policy_path import slice_train_params
from dotaclient_tpu_torch.train import demo as pdemo
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.train import ppo as pppo
from dotaclient_tpu_torch.transport import serialize as PS
from dotaclient_tpu_torch.utils import telemetry
from dotaclient_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_common import jax_policy, np32, obs_row, random_obs, small_configs, to_jax, to_torch
from tests.test_torch_rollout import jax_randomness, to_np

jppo = importlib.import_module("dotaclient_tpu.train.ppo")

ATOL = 1e-5
BF16_TOL = 0.1
W = 8
B, T = 5, 6


def tf_configs(dtype="float32", moe=0, **serve):
    """(jax, port) configs of the small model with the transformer core."""
    return tuple(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, core="transformer", n_layers=2, n_heads=4, context_window=W, moe_experts=moe))
        for cfg in small_configs(dtype, **serve))


def port_policy(pcfg, params, value_head=True):
    policy = Policy(pcfg.model, pcfg.obs, pcfg.actions, value_head=value_head, device="cpu")
    sd = convert(params)
    policy.load_state_dict(sd if value_head else slice_train_params(sd))
    return policy


def random_carry(pcfg, n, seed):
    """A nonzero f32 carry (valid 0/1 with the newest slots set, k and v
    N(0, 0.5)) as numpy leaves in the carry's nested layout."""
    rng = np.random.default_rng(seed)
    H, L = pcfg.model.hidden_dim, pcfg.model.n_layers
    valid = (rng.random((n, W)) < 0.6).astype(np.float32)
    valid[:, -2:] = 1.0
    return (valid, tuple(((rng.normal(size=(n, W, H)) * 0.5).astype(np.float32),
                          (rng.normal(size=(n, W, H)) * 0.5).astype(np.float32)) for _ in range(L)))


def assert_leaves_close(got, want, atol, what):
    got, want = [np32(t) for t in tree_leaves(got)], [np.asarray(t, np.float32) for t in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} leaf {i}")


def jax_sequence(jcfg):
    """The Flax policy's sequence with its sown MoE stats, jitted once."""
    policy = jax_policy(jcfg)[0]
    return jax.jit(lambda p, o, c, d: policy.apply(p, o, c, d, method="sequence", mutable=["losses"]))


# -- the policy against Flax -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,moe", [("float32", 0), ("float32", 4), ("bfloat16", 0)])
def test_step_and_sequence_match_flax(dtype, moe):
    jcfg, pcfg = tf_configs(dtype, moe)
    tol = ATOL if dtype == "float32" else BF16_TOL
    params = random_flax_params(pcfg, seed=3)
    jparams = jax.tree.map(jnp.asarray, params)
    policy = port_policy(pcfg, params)
    obs = random_obs(pcfg, (B, T), seed=1)
    dones = np.zeros((B, T), np.float32)
    dones[1, 2] = dones[3, 0] = dones[0, 4] = 1.0
    carry0 = random_carry(pcfg, B, seed=2)

    (jl, jv, jc), mutated = jax_sequence(jcfg)(jparams, to_jax(obs), tree_map(jnp.asarray, carry0), jnp.asarray(dones))
    with torch.no_grad():
        pl, pv, pc, moe_stats = policy.sequence(to_torch(obs), tree_map(torch.from_numpy, carry0),
                                                torch.from_numpy(dones), return_moe=True)
    for head in jl:
        np.testing.assert_allclose(np32(pl[head]), np.asarray(jl[head], np.float32), rtol=0, atol=tol, err_msg=head)
    np.testing.assert_allclose(np32(pv), np.asarray(jv), rtol=0, atol=tol)
    assert_leaves_close(pc, jc, tol, "sequence carry")
    assert all(t.dtype == torch.float32 for t in tree_leaves(pc))
    if moe:
        sown = mutated["losses"]["core"]
        assert len(moe_stats) == 2
        for layer, (probs, frac) in enumerate(moe_stats):
            want = sown[f"block_{layer}"]["moe"]
            np.testing.assert_allclose(probs.numpy(), np.asarray(want["moe_probs"][0]), rtol=0, atol=ATOL)
            np.testing.assert_array_equal(frac.numpy(), np.asarray(want["moe_frac"][0]))
    else:
        assert moe_stats == () and not mutated.get("losses")

    # one step from the carry the sequence ended with
    jstep = jax_policy(jcfg)[1]
    ob = {k: v[:, 0] for k, v in obs.items()}
    jl1, jv1, jc1 = jstep(jparams, to_jax(ob), jc)
    with torch.no_grad():
        pl1, pv1, pc1 = policy.step(to_torch(ob), tree_map(lambda t: torch.from_numpy(np.array(t)), jc))
    for head in jl1:
        np.testing.assert_allclose(np32(pl1[head]), np.asarray(jl1[head], np.float32), rtol=0, atol=tol, err_msg=head)
    np.testing.assert_allclose(np32(pv1), np.asarray(jv1), rtol=0, atol=tol)
    assert_leaves_close(pc1, jc1, tol, "step carry")


@pytest.mark.parametrize("moe", [0, 4])
def test_sequence_equals_its_own_step_loop(moe):
    """``sequence`` is the cell stepped T times, the carry of rows whose
    episode ended zeroed before the next step, then the heads over the
    stacked outputs: bit for bit, MoE stats included."""
    _, pcfg = tf_configs("bfloat16", moe)
    policy = make_policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(4))
    obs = to_torch(random_obs(pcfg, (B, T), seed=6))
    dones = torch.zeros(B, T)
    dones[2, 1] = dones[4, 3] = 1.0
    carry = tree_map(torch.from_numpy, random_carry(pcfg, B, seed=7))
    with torch.no_grad():
        sl, sv, sc, smoe = policy.sequence(obs, carry, dones, return_moe=True)
        x, unit_emb = policy._trunk(obs)
        c, ys, stats = carry, [], []
        for t in range(T):
            if t:
                c = mask_carry(c, 1.0 - dones[:, t - 1])
            c, y, st = policy.core(c, x[:, t])
            ys.append(y)
            stats.append(st)
        logits, value = policy._heads(torch.stack(ys, dim=1), unit_emb)
    for head in logits:
        torch.testing.assert_close(logits[head], sl[head], rtol=0, atol=0)
    torch.testing.assert_close(value, sv, rtol=0, atol=0)
    for a, b in zip(tree_leaves(c), tree_leaves(sc)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(smoe) == (2 if moe else 0)
    for layer, (probs, frac) in enumerate(smoe):
        torch.testing.assert_close(probs, torch.stack([s[layer][0] for s in stats]), rtol=0, atol=0)
        torch.testing.assert_close(frac, torch.stack([s[layer][1] for s in stats]), rtol=0, atol=0)


def test_mask_carry_zeroes_every_nested_leaf():
    _, pcfg = tf_configs()
    carry = tree_map(torch.from_numpy, random_carry(pcfg, 4, seed=1))
    keep = torch.tensor([1.0, 0.0, 1.0, 0.0])
    out = mask_carry(carry, keep)
    assert len(tree_leaves(out)) == 1 + 2 * pcfg.model.n_layers
    for got, src in zip(tree_leaves(out), tree_leaves(carry)):
        assert not got[1].any() and not got[3].any()
        torch.testing.assert_close(got[0], src[0], rtol=0, atol=0)
        torch.testing.assert_close(got[2], src[2], rtol=0, atol=0)


def test_init_params_draws_the_reference_distributions():
    """The GTrXL gate bias at 2 (the near-identity start), zero position
    bias, LayerNorms at 1 and 0, and each expert lecun-normal at its own
    fan-in; the tree's paths and shapes are the JAX ``init_params``'s, in
    its order."""
    cfg = tf_configs(moe=4)[1]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hidden_dim=128, context_window=16))
    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(0))
    sd = policy.state_dict()
    for name, t in sd.items():
        if name.endswith(".bg"):
            assert torch.equal(t, torch.full_like(t, 2.0)), name
        elif name.endswith((".pos_bias", "expert_b1", "expert_b2")) or (".ln" in name or "out_ln" in name) \
                and name.endswith(".bias"):
            assert not t.any(), name
        elif name.endswith(".scale"):
            assert torch.equal(t, torch.ones_like(t)), name
        elif "expert_w" in name:
            std = t.shape[1] ** -0.5
            assert abs(float(t.std()) / std - 1.0) < 0.05, name
            assert float(t.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6, name


# -- one PPO update against JAX ------------------------------------------------------------------------


def tf_batch(pcfg, params, seed):
    rng = np.random.default_rng(seed)
    Tb = 5
    obs = random_obs(pcfg, (B, Tb + 1), seed=seed)
    dones = (rng.random((B, Tb)) < 0.2).astype(np.float32)
    policy = port_policy(pcfg, params)
    carry0 = random_carry(pcfg, B, seed=seed + 1)
    from dotaclient_tpu_torch.models import distributions as PD

    with torch.no_grad():
        logits, _, _ = policy.sequence(to_torch(obs), tree_map(torch.from_numpy, carry0), torch.from_numpy(dones))
        actions, logp = PD.sample({k: v[:, :Tb] for k, v in logits.items()},
                                  {k: v[:, :Tb] for k, v in to_torch(obs).items()},
                                  generator=torch.Generator().manual_seed(seed))
    return {
        "obs": obs,
        "actions": {k: v.numpy().astype(np.int32) for k, v in actions.items()},
        "behavior_logp": (logp.numpy() + rng.normal(size=(B, Tb)) * 0.3).astype(np.float32),
        "rewards": rng.normal(size=(B, Tb)).astype(np.float32),
        "dones": dones,
        "valid": (rng.random((B, Tb)) < 0.9).astype(np.float32),
        "carry0": carry0,
    }


@pytest.mark.parametrize("moe", [0, 4])
def test_train_step_matches_jax(moe):
    jcfg, pcfg = tf_configs("float32", moe)
    jcfg = dataclasses.replace(jcfg, ppo=dataclasses.replace(jcfg.ppo, rollout_len=5))
    pcfg = dataclasses.replace(pcfg, ppo=dataclasses.replace(pcfg.ppo, rollout_len=5))
    params = random_flax_params(pcfg, seed=8)
    batch = tf_batch(pcfg, params, seed=9)
    jpolicy = jax_policy(jcfg)[0]
    jbatch = tree_map(jnp.asarray, batch)
    jparams = jax.tree.map(jnp.asarray, params)

    def loss_and_grads(p):
        return jax.value_and_grad(lambda q: jppo.ppo_loss(jpolicy, q, jbatch, jcfg.ppo, step=0), has_aux=True)(p)

    (jloss, jm), jgrads = jax.jit(loss_and_grads)(jparams)

    pstate = pppo.init_train_state(port_policy(pcfg, params), pcfg.ppo)
    pbatch = tree_map(lambda a: torch.from_numpy(np.array(a)), batch)
    loss, pm = pppo.ppo_loss(pstate.policy, pbatch, pcfg.ppo, step=0)
    named = list(pstate.policy.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-4)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    if moe:
        assert float(pm["moe_aux"]) >= 0.99   # >= 1 for top-1 routing (Cauchy-Schwarz)
    want = convert(jax.tree.map(np.asarray, jgrads))
    for (name, _), g in zip(named, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-3 * max(float(np.abs(w).max()), 1e-6),
                                   err_msg=name)
    # the update itself: its pre-clip gradient norm is the reference's
    # global norm of these gradients
    pstate, pm2 = pppo._train_step(pcfg.ppo, pstate, pbatch)
    jnorm = float(np.sqrt(sum(float(np.sum(np.square(np.asarray(g)))) for g in jax.tree.leaves(jgrads))))
    np.testing.assert_allclose(float(pm2["grad_norm"]), jnorm, rtol=1e-4)
    assert float(pm2["health_ok"]) == 1.0 and pstate.step == 1


# -- the device rollout against JAX ------------------------------------------------------------------------


def test_rollout_chunk_matches_jax():
    jcfg, pcfg = (dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, rollout_len=4),
        env=dataclasses.replace(cfg.env, n_envs=4, opponent="scripted_easy", max_dota_time=0.4), log_every=1)
        for cfg in tf_configs())
    params = random_flax_params(pcfg, seed=3)
    jactor = JaxDeviceActor(jcfg, jax_policy(jcfg)[0], seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    js = jactor.state
    noise, _, jitter = jax_randomness(jcfg, jactor.n_lanes)(js.key, js.sim.key)
    j_new, j_chunk, _ = jax.jit(jactor._rollout_impl)(jparams, js, jparams)

    policy = port_policy(pcfg, params)
    actor = DeviceActor(pcfg, policy, seed=5, device="cpu")
    actor.state.sim = S.SimState(**{k: torch.from_numpy(np.array(getattr(js.sim, k))) for k in S.FIELDS})
    with torch.no_grad():
        p_new, p_chunk, _ = actor._rollout_impl(
            policy, actor.state, noise={h: torch.from_numpy(np.array(v)) for h, v in noise.items()},
            jitter={k: torch.from_numpy(np.array(v)) for k, v in jitter.items()})
    got, want = to_np(p_chunk), to_np(j_chunk)
    assert float(want["dones"].sum()) > 0
    for h in JD.HEADS:
        np.testing.assert_array_equal(got["actions"][h], want["actions"][h], err_msg=h)
    np.testing.assert_array_equal(got["dones"], want["dones"])
    for k in ("rewards", "behavior_logp"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)
    assert_leaves_close(p_chunk["carry0"], j_chunk["carry0"], 0.0, "carry0")
    assert_leaves_close(p_new.carry, j_new.carry, ATOL, "carry")
    assert [tuple(t.shape) for t in tree_leaves(p_chunk["carry0"])] == \
        [(actor.n_lanes, W)] + [(actor.n_lanes, W, pcfg.model.hidden_dim)] * 4


# -- the wire: chunks both ways, the serve shadow rows, the weights frame ----------------------------------


def vec_configs(moe=0):
    return tuple(dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, rollout_len=4, batch_rollouts=8),
        env=dataclasses.replace(cfg.env, n_envs=2, opponent="selfplay", max_dota_time=30.0),
        buffer=dataclasses.replace(cfg.buffer, capacity_rollouts=8, min_fill=2))
        for cfg in tf_configs(moe=moe))


def test_vec_pool_chunks_cross_the_wire_both_ways():
    jcfg, pcfg = vec_configs()
    params = random_flax_params(pcfg, seed=2)
    jout, pout = [], []
    jpool = JaxVecActorPool(jcfg, jax_policy(jcfg)[0], jax.tree.map(jnp.asarray, params), seed=1,
                            rollout_sink=jout.extend)
    jpool.run(4, refresh_every=0)
    policy = port_policy(pcfg, params)
    ppool = VecActorPool(pcfg, policy, dict(policy.state_dict()), seed=1, rollout_sink=pout.extend, device="cpu",
                         registry=telemetry.Registry())
    ppool.run(4, refresh_every=0)
    assert jout and pout
    H = pcfg.model.hidden_dim
    j_names = {n: np.shape(v) for n, v in J.flatten_tree(jout[0][1]).items()}
    assert j_names["carry0/0"] == (W,) and j_names["carry0/1/1/1"] == (W, H)
    # the JAX pool's chunks, through the JAX encoder, into the port's ring
    ring = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())
    rows = [PS.decode_rollout_bytes(J.encode_rollout(a, **m).SerializeToString()) for m, a in jout]
    assert ring.add(rows, current_version=0) == len(rows)
    assert ring.dropped_skew == 0 and ring.size == len(rows)
    # the port pool's chunks, through the port's encoder, decoded by JAX
    for meta, arrays in pout:
        jm, ja = J.decode_rollout_bytes(bytes(PS.encode_rollout_bytes(arrays, **meta)), native=False)
        assert jm == meta
        got = {n: np.shape(v) for n, v in J.flatten_tree(ja).items()}
        assert got == j_names
    # and the JAX ring admits them too
    jring = JaxTrajectoryBuffer(jcfg, make_mesh(jcfg.mesh), registry=JaxRegistry())
    assert jring.add([J.decode_rollout_bytes(bytes(PS.encode_rollout_bytes(a, **m)), native=False)
                      for m, a in pout], current_version=0) == len(pout)


def test_serve_engine_shadow_rows_are_jax_named_and_valued():
    jcfg, pcfg = tf_configs(max_batch=4, batch_window_ms=0.0, carry_shadow=True)
    params = random_flax_params(pcfg, seed=5, value_head=False)
    jengine = JaxServeEngine(jcfg, jax_inference_policy(jcfg), params)
    engine = ServeEngine(pcfg, make_inference_policy(pcfg, device="cpu"), convert(params), device="cpu",
                         registry=telemetry.Registry())
    replies = []
    try:
        obs = random_obs(pcfg, (2,), seed=8)
        for i in range(2):
            engine.submit(3 + i, obs_row(obs, i), reset=True,
                          reply=lambda *a, **kw: replies.append((a, kw)), request_id=i)
        deadline = time.time() + 30
        while len(replies) < 2 and time.time() < deadline:
            time.sleep(0.01)
        # one buffer a leaf: the JAX engine donates its store
        store = jax.tree.map(lambda c: jnp.asarray(np.array(c)), jengine._policy.initial_state(
            jcfg.serve.max_slots + 1))
        _, _, jcarries = jengine.reference_step([obs_row(obs, i) for i in range(2)], [3, 4], [1.0, 1.0], store, 0)
    finally:
        engine.stop()
        jengine.stop()
    assert len(replies) == 2
    for (args, kw) in replies:
        slot = 3 + args[3]
        want = jengine.carry_row_to_wire(jax.tree.map(lambda c: np.asarray(c[slot]), jcarries))
        got = kw["carry"]
        assert list(got) == list(want) == [f"c{i}" for i in range(5)]
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)
        # and the row goes back in through the port's own validation
        assert [a.shape for a in engine.wire_to_carry_row(got)] == [(W,)] + [(W, pcfg.model.hidden_dim)] * 4


def ordered_leaves(tree, path=()):
    """(path, leaf) in the dicts' own order (``jax.tree`` sorts keys)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from ordered_leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("moe", [0, 4])
def test_to_flax_is_the_inverse_and_the_frame_is_jaxs_bytes(moe):
    """``to_flax`` keeps the Flax tree's creation order (read here from the
    JAX ``init_params`` tree), so the weights frame is the JAX encoder's
    byte for byte (its map compared key-sorted); ``flax_param_shapes`` has
    the same paths and shapes."""
    jcfg, pcfg = tf_configs(moe=moe)
    jinit = jax_init_params(jax_policy(jcfg)[0], jax.random.PRNGKey(moe))
    jtree = {"params": dict(jinit["params"])}
    jleaves = list(ordered_leaves(jtree))
    policy = port_policy(pcfg, jtree)
    back = to_flax(policy.state_dict())
    pleaves = list(ordered_leaves(back))
    assert [p for p, _ in pleaves] == [p for p, _ in jleaves]   # the Flax creation order
    for (_, a), (_, b) in zip(pleaves, jleaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a protobuf map's wire order follows its hash table, not the insertion
    # order, so two maps of the same entries compare key-sorted
    port_frame, jax_frame = PS.encode_weights(back, 7), J.encode_weights(jtree, 7)
    assert list(PS.flatten_tree(back)) == list(J.flatten_tree(jtree))
    assert port_frame.SerializeToString(deterministic=True) == jax_frame.SerializeToString(deterministic=True)
    shapes = list(ordered_leaves(flax_param_shapes(pcfg)))
    assert sorted((p, tuple(s)) for p, s in shapes) == sorted((p, np.shape(v)) for p, v in jleaves)


# -- the CLIs, the league and what stays refused -----------------------------------------------------------


@pytest.mark.parametrize("actor", ["device", "fused"])
def test_learner_cli_trains_the_transformer(actor, capsys):
    argv = ["--core", "transformer", "--smoke", "--device", "cpu", "--steps", "2", "--actor", actor]
    assert plearner.main(argv) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    frames = 2 * 8 * (8 if actor == "device" else 4)
    assert last.startswith(f"done: 2 steps, {frames} frames, ") and last.endswith(" 0 lstm_seq launches")


def test_demo_trains_the_moe_transformer(capsys):
    assert pdemo.main(["--core", "transformer", "--moe-experts", "4", "--steps", "2", "--n-envs", "4",
                       "--eval-games", "2", "--max-dota-time", "2", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    summary = json.loads(line[len("DEMO_SUMMARY "):])
    assert summary["core"] == "transformer" and summary["steps"] == 2


def test_league_snapshots_and_evaluation_are_generic():
    _, pcfg = tf_configs()
    policy = make_policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(1))
    pool = OpponentPool(dataclasses.replace(pcfg.league, selfplay_prob=0.0), seed=0)
    assert pool.maybe_snapshot(policy.state_dict(), 1, 0)
    frozen = {k: v.clone() for k, v in policy.state_dict().items()}
    with torch.no_grad():
        for p in policy.parameters():
            p.add_(1.0)
    params, version, uid = pool.sample_indexed(policy.state_dict(), 2)
    assert uid == 0 and version == 1 and all(torch.equal(params[k], frozen[k]) for k in frozen)
    cfg = dataclasses.replace(pcfg, env=dataclasses.replace(pcfg.env, max_dota_time=2.0))
    out = evaluate(cfg, policy, frozen, "league", opponent_params=params, n_games=2, device="cpu")
    assert out["episodes"] >= 2 and 0.0 <= out["win_rate"] <= 1.0


def test_scalar_pool_still_refuses_the_transformer_and_moe_needs_it():
    _, pcfg = tf_configs()
    policy = make_policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    with pytest.raises(NotImplementedError, match="LSTM core only.*the vec and device actors run any core"):
        ActorPool(pcfg, policy, dict(policy.state_dict()), device="cpu")
    lstm_moe = dataclasses.replace(pcfg.model, core="lstm", moe_experts=4)
    with pytest.raises(ValueError, match="requires core='transformer'"):
        make_policy(lstm_moe, pcfg.obs, pcfg.actions, device="cpu")
    with pytest.raises(ValueError, match="requires core='transformer'"):
        plearner.main(["--moe-experts", "4", "--smoke", "--device", "cpu", "--steps", "1"])

"""The MoE core on a data group and tensor parallelism in the learner: the
port's against the JAX package's and its own world 1, in two spawned gloo
worlds (``tests/torch_world.py``) while the JAX references compile in this
process. Held, on a world of 2 (data 2):

* the MoE layer's routing over the global batch with tokens dropped: each
  rank's dispatch, combine and output rows, concatenated, JAX's
  ``route_top1`` and ``MoEMLP`` on a 2-device data mesh (dispatch bitwise,
  the rest within 1e-5); the drops a rank routing alone would make are
  others (the fault the group guards against);
* the Switch load-balancing term: its global value the world-1 term and
  JAX's, the ranks' loss terms summing to it;
* the MoE transformer's fused step: the first chunk and the first update
  world 1's, the ranks' params bitwise equal.

On a world of 4:

* ``tests/test_parallel.py``'s wide core (hidden 512, the CPU's plain
  LSTM) at data 1 x model 2, two steps, against JAX's tp2 result and the
  port's world 1 (rtol 2e-4, atol 2e-5), its ``trunk_proj`` master and Adam
  moments at the cut shape (the Flax kernel's ``(in, out/2)``);
* ``tests/test_fused.py``'s fused run at data 2 x model 2 against world 1;
* ``tests/test_moe.py``'s MoE transformer at data 2 x model 2: the
  experts cut on axis 0, ``moe_aux >= 0.99``, the loss world 1's;
* ``tests/test_dcn.py``'s dcn 2 x model 2 against data 2 x model 2;
* a learner's checkpoint saved at model 2 restored at model 1, and the
  reverse: the whole layout on disk, cut again at restore.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotaclient_tpu.config import MeshConfig as JaxMeshConfig
from dotaclient_tpu.models import init_params as jax_init_params
from dotaclient_tpu.models import make_policy as jax_make_policy
from dotaclient_tpu.models.moe import MoEMLP as FlaxMoEMLP
from dotaclient_tpu.parallel import expert as jexpert
from dotaclient_tpu.parallel import make_mesh as jax_make_mesh
from dotaclient_tpu.train import ppo as jppo
from dotaclient_tpu_torch import config as port_config
from dotaclient_tpu_torch.config import MeshConfig
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.train.ppo import _moe_aux_loss, example_batch
from tests.test_parallel import wide_batch, wide_config
from tests.test_torch_common import flax_params, tiny_configs
from tests.test_torch_data_parallel import assert_bitwise, assert_params_close, assert_tree_equal, concat_lanes
from tests.test_torch_train import make_batch
from tests.torch_world import run_world

TP_RTOL, TP_ATOL = 2e-4, 2e-5    # tests/test_parallel.py's tp2 tolerance
RTOL = 1e-4
E, D, B_TOKENS, CF = 4, 32, 16, 0.5


def port_np(jparams):
    return {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray, jparams)).items()}


def port_init(cfg, seed):
    import torch

    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(seed))
    return {k: v.numpy().copy() for k, v in policy.state_dict().items()}


def tiny(**model):
    _, pcfg = tiny_configs()
    return dataclasses.replace(
        pcfg, model=dataclasses.replace(pcfg.model, **model),
        env=dataclasses.replace(pcfg.env, n_envs=4, opponent="selfplay", max_dota_time=0.4),
        ppo=dataclasses.replace(pcfg.ppo, rollout_len=3, minibatches=1), log_every=1,
        checkpoint_every=1_000_000)


def layer_case():
    rng = np.random.default_rng(11)
    params = {
        "gate": rng.standard_normal((D, E)) / np.sqrt(D),
        "expert_w1": rng.standard_normal((E, D, 4 * D)) / np.sqrt(D),
        "expert_b1": rng.standard_normal((E, 4 * D)) * 0.1,
        "expert_w2": rng.standard_normal((E, 4 * D, D)) / np.sqrt(4 * D),
        "expert_b2": rng.standard_normal((E, D)) * 0.1,
    }
    return {"params": {k: v.astype(np.float32) for k, v in params.items()},
            "x": rng.standard_normal((B_TOKENS, D)).astype(np.float32), "E": E, "cf": CF,
            "mesh": MeshConfig(data_parallel=-1)}


def aux_case():
    rng = np.random.default_rng(3)
    B, T = 6, 5
    stats = []
    for _ in range(2):
        probs = rng.dirichlet(np.ones(E), size=(T + 1, B)).astype(np.float32)
        frac = np.eye(E, dtype=np.float32)[rng.integers(0, E, size=(T + 1, B))]
        frac[rng.random((T + 1, B)) < 0.2] = 0.0
        stats.append((probs, frac))
    return {"stats": stats, "valid": (rng.random((B, T)) < 0.7).astype(np.float32)}


def jax_layer(lay):
    """JAX's routing of the global tokens and ``MoEMLP`` with the tokens on
    a 2-device data mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dotaclient_tpu import config as jax_config

    cfg = dataclasses.replace(jax_config.ModelConfig(), hidden_dim=D, moe_experts=E, moe_capacity_factor=CF,
                              dtype="float32", core="transformer")
    mesh = jax_make_mesh(JaxMeshConfig(data_parallel=2), devices=jax.devices()[:2])
    x = jax.device_put(jnp.asarray(lay["x"]), NamedSharding(mesh, P("data")))
    y = jax.jit(lambda p, x: FlaxMoEMLP(cfg).apply({"params": p}, x, mutable=["losses"])[0])(lay["params"], x)
    C = jexpert.expert_capacity(B_TOKENS, E, CF)
    d, c, pr = jexpert.route_top1(jnp.asarray(lay["x"]), jnp.asarray(lay["params"]["gate"]), E, C)
    return {"C": C, "dispatch": np.asarray(d), "combine": np.asarray(c), "probs": np.asarray(pr), "y": np.asarray(y)}


def jax_aux(ax):
    from dotaclient_tpu.train.ppo import _moe_aux_loss as jax_moe_aux_loss

    col = {f"block_{i}": {"moe": {"moe_probs": (jnp.asarray(p),), "moe_frac": (jnp.asarray(f),)}}
           for i, (p, f) in enumerate(ax["stats"])}
    return float(jax_moe_aux_loss({"core": col}, jnp.asarray(ax["valid"])))


def jax_wide():
    """``tests/test_parallel.py``'s tp2 run: its params, batch and result."""
    base = wide_config()
    policy = jax_make_policy(base.model, base.obs, base.actions)
    params = jax_init_params(policy, jax.random.PRNGKey(0))
    batch = wide_batch(base, policy, params, batch=4, seed=3)
    host = {"params": port_np(params), "batch": jax.tree.map(np.asarray, batch)}

    def run():
        cfg = dataclasses.replace(base, mesh=JaxMeshConfig(data_parallel=1, model_parallel=2))
        mesh = jax_make_mesh(cfg.mesh, devices=jax.devices()[:2])
        state = jppo.init_train_state(params, cfg.ppo)
        step = jppo.make_train_step(policy, cfg, mesh)
        ms = []
        for _ in range(2):
            state, m = step(state, batch)
            ms.append({k: float(v) for k, v in m.items()})
        return {"metrics": ms, "params": port_np(state.params)}

    return host, run


def port_wide_config():
    cfg = port_config.default_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, hidden_dim=512, dtype="float32"),
        ppo=dataclasses.replace(cfg.ppo, rollout_len=4, batch_rollouts=4))


def moe_tf_config():
    cfg = port_config.default_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, core="transformer", n_layers=1, moe_experts=4, context_window=4,
                                       dtype="float32"),
        ppo=dataclasses.replace(cfg.ppo, rollout_len=4, batch_rollouts=4),
        mesh=MeshConfig(model_parallel=2, data_parallel=-1))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    lay, ax = layer_case(), aux_case()
    fcfg = dataclasses.replace(tiny(core="transformer", n_layers=1, moe_experts=2, moe_capacity_factor=0.5,
                                    context_window=4), mesh=MeshConfig(data_parallel=-1))
    payload = {"layer": lay, "aux": ax, "fused": {"cfg": fcfg, "params": port_init(fcfg, 7)}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, 2, "tests.torch_world:moe_data_ranks", payload,
                            tmp_path_factory.mktemp("moeworld"), timeout_s=120.0, deadline_s=300.0)
        side = {"layer": jax_layer(lay), "aux": jax_aux(ax), "lay": lay, "ax": ax, "fcfg": fcfg}
        return side, ranks.result()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    wide, jax_run = jax_wide()
    fcfg = dataclasses.replace(tiny(), mesh=MeshConfig(data_parallel=-1, model_parallel=2))
    mcfg = moe_tf_config()
    _, dcfg = tiny_configs()
    dcfg = dataclasses.replace(dcfg, ppo=dataclasses.replace(dcfg.ppo, rollout_len=5, batch_rollouts=4),
                               mesh=MeshConfig(data_parallel=-1))
    lcfg = dataclasses.replace(tiny(), env=dataclasses.replace(tiny().env, n_envs=12, max_dota_time=4.0),
                               ppo=dataclasses.replace(tiny().ppo, rollout_len=4, batch_rollouts=4, minibatches=2),
                               buffer=dataclasses.replace(tiny().buffer, capacity_rollouts=16, min_fill=4))
    payload = {
        "wide": {"cfg": port_wide_config(), **wide},
        "fused": {"cfg": fcfg, "params": port_init(fcfg, 5)},
        "moe": {"cfg": mcfg, "params": port_init(mcfg, 0),
                "batch": jax.tree.map(lambda t: t.numpy(), example_batch(mcfg, 4, device="cpu"))},
        "dcn": {"cfg": dcfg, "params": port_init(dcfg, 1),
                "batch": make_batch(dcfg, flax_params(tiny_configs()[0], seed=1), seed=6)},
        "learner": {"cfg": lcfg, "dir": str(tmp_path_factory.mktemp("tp_ck")), "steps": 4},
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, 4, "tests.torch_world:model_parallel_ranks", payload,
                            tmp_path_factory.mktemp("tpworld"), timeout_s=120.0, deadline_s=400.0)
        side = {"wide": jax_run(), "fcfg": fcfg, "lcfg": lcfg}
        return side, ranks.result()


# -- the MoE core over a data group ---------------------------------------------------------------------


def test_moe_routing_over_the_data_group_matches_jax_with_drops(world2):
    side, ranks = world2
    want = side["layer"]
    got = {k: np.concatenate([r["layer"][k] for r in ranks]) for k in ("dispatch", "combine", "probs", "y")}
    assert ranks[0]["layer"]["C"] == ranks[1]["layer"]["C"] == want["C"] == 2
    np.testing.assert_array_equal(got["dispatch"], want["dispatch"])
    for k in ("combine", "probs", "y"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    kept = want["dispatch"].sum(axis=(1, 2))
    assert (kept == 0).any()                                   # tokens were dropped
    # per expert: kept counts, and the ranks' frac the kept tokens' experts
    np.testing.assert_array_equal(np.concatenate([r["layer"]["frac"] for r in ranks]), want["dispatch"].sum(axis=2))
    # routing each rank's block alone drops other tokens
    local = np.concatenate([r["layer"]["y_local"] for r in ranks])
    assert not np.allclose(local, want["y"], atol=1e-5)


def test_moe_aux_term_over_the_data_group(world2):
    side, ranks = world2
    ax = side["ax"]
    import torch

    one = float(_moe_aux_loss(tuple((torch.from_numpy(p), torch.from_numpy(f)) for p, f in ax["stats"]),
                              torch.from_numpy(ax["valid"])))
    for r in ranks:
        np.testing.assert_allclose(r["aux"]["global"], one, rtol=1e-6)
    np.testing.assert_allclose(one, side["aux"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(sum(r["aux"]["local"] for r in ranks), one, rtol=1e-6)
    # a product of global means, not a mean of the ranks' own products
    alone = np.mean([r["aux"]["alone"] for r in ranks])
    assert abs(alone - one) > 1e-3 * one, (alone, one)


def test_moe_fused_step_at_world_2_matches_world_1(world2):
    side, ranks = world2
    w1 = ranks[0]["fused1"]
    a, b = ranks[0]["fused2"], ranks[1]["fused2"]
    assert a["lane_shards"] == 2 and w1["lane_shards"] == 1
    got = concat_lanes(a["chunk"], b["chunk"])
    for k in ("actions", "dones"):
        assert_tree_equal(got[k], w1["chunk"][k], k)
    for k in ("obs", "rewards", "behavior_logp", "carry0"):
        for g, w in zip(jax.tree.leaves(got[k]), jax.tree.leaves(w1["chunk"][k])):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    for k in ("loss", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(a["metrics"][0][k], w1["metrics"][0][k], rtol=RTOL, err_msg=k)
    assert a["metrics"][0]["moe_aux"] > 0
    assert_bitwise(a["params"], b["params"], "ranks")
    assert_params_close(a["params"], w1["params"], side["fcfg"].ppo.learning_rate, 1, "world 2 vs 1")


# -- tensor parallelism -------------------------------------------------------------------------------


def test_wide_core_tp2_matches_jax_and_world_1(world4):
    side, ranks = world4
    want, one = side["wide"], ranks[2]["wide1"]
    for r in (0, 1):
        got = ranks[r]["wide2"]
        for i in range(2):
            for k in want["metrics"][i]:
                np.testing.assert_allclose(got["metrics"][i][k], want["metrics"][i][k], rtol=TP_RTOL, atol=TP_ATOL,
                                           err_msg=f"rank {r} step {i} {k} vs jax")
                np.testing.assert_allclose(got["metrics"][i][k], one["metrics"][i][k], rtol=TP_RTOL, atol=TP_ATOL,
                                           err_msg=f"rank {r} step {i} {k} vs world 1")
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=TP_RTOL, atol=TP_ATOL, err_msg=f"{name} vs jax")
            np.testing.assert_allclose(got["params"][name], one["params"][name], rtol=TP_RTOL, atol=TP_ATOL,
                                       err_msg=f"{name} vs world 1")
    assert_bitwise(ranks[0]["wide2"]["params"], ranks[1]["wide2"]["params"], "ranks")


def test_tp2_state_actually_sharded(world4):
    _, ranks = world4
    for r in (0, 1):
        lay = ranks[r]["wide2"]["layout"]
        trunk = lay["trunk_proj.weight"]
        # the Flax kernel (in, out) cut on its last axis: torch's [out, in] on 0
        out_dim, in_dim = trunk["whole"]
        assert trunk["dim"] == 0 and trunk["master"] == (out_dim // 2, in_dim)
        assert trunk["moments"] == [trunk["master"]] * 2
        cut = [n for n, v in lay.items() if v["dim"] is not None]
        assert len(cut) > len(lay) // 2, cut


def test_fused_under_tensor_parallelism_matches_world_1(world4):
    side, ranks = world4
    one = ranks[0]["fused1"]
    for r in range(4):
        got = ranks[r]["fused_tp"]
        assert got["lane_shards"] == 2
        assert any(v["dim"] is not None for n, v in got["layout"].items() if n.startswith("core."))
        np.testing.assert_allclose(got["metrics"][-1]["loss"], one["metrics"][-1]["loss"], rtol=TP_RTOL,
                                   atol=TP_ATOL)
        for name, w in one["params"].items():
            np.testing.assert_allclose(got["params"][name], w, rtol=TP_RTOL, atol=TP_ATOL, err_msg=name)
        assert_bitwise(got["params"], ranks[0]["fused_tp"]["params"], f"rank {r}")


def test_moe_transformer_trains_on_data_model_mesh(world4):
    _, ranks = world4
    one = ranks[0]["moe1"]
    for r in range(4):
        got = ranks[r]["moe_tp"]
        w1 = got["layout"]["core.blocks.0.moe.expert_w1"]
        assert w1["dim"] == 0 and w1["master"] == (w1["whole"][0] // 2,) + w1["whole"][1:]
        m = got["metrics"][0]
        assert np.isfinite(m["loss"]) and m["moe_aux"] >= 0.99, m
        np.testing.assert_allclose(m["loss"], one["metrics"][0]["loss"], rtol=RTOL)
        np.testing.assert_allclose(m["moe_aux"], one["metrics"][0]["moe_aux"], rtol=RTOL)


def test_dcn_2_by_model_2_equals_data_2_by_model_2(world4):
    _, ranks = world4
    for r in range(4):
        flat, dcn = ranks[r]["dcn_flat"], ranks[r]["dcn_dcn"]
        np.testing.assert_allclose([m["loss"] for m in dcn["metrics"]], [m["loss"] for m in flat["metrics"]],
                                   rtol=1e-5)
        assert np.isfinite(flat["metrics"][-1]["loss"])
        assert_bitwise(dcn["params"], flat["params"], f"rank {r}")
        assert_bitwise(flat["params"], ranks[0]["dcn_flat"]["params"], f"rank {r} vs rank 0")


def test_checkpoint_model_2_restores_at_model_1_and_back(world4):
    _, ranks = world4
    tp2, back = ranks[0]["ck_tp2"], ranks[0]["ck_2to1"]
    assert_bitwise(ranks[1]["ck_tp2"]["params"], tp2["params"], "the model ranks")
    # model 2 -> model 1: the whole params and moments, bitwise
    assert_bitwise(back["params"], tp2["params"], "2 -> 1 params")
    assert back["step"] == tp2["step"] > 0
    assert_tree_equal(back["opt"], tp2["opt"], "2 -> 1 moments")
    # model 1 -> model 2: each rank holds its cut of what model 1 saved
    one = ranks[0]["ck_tp1"]
    for r in (0, 1):
        got = ranks[r]["ck_1to2"]
        assert_bitwise(got["params"], one["params"], f"1 -> 2 params, rank {r}")
        assert_tree_equal(got["opt"], one["opt"], f"1 -> 2 gathered moments, rank {r}")
        lay = ranks[r]["ck_tp2"]["layout"]
        names = list(lay)
        for i, name in enumerate(names):
            d = lay[name]["dim"]
            whole = one["params"][name]
            if d is None:
                continue
            per = whole.shape[d] // 2
            want = np.take(whole, range(got["me"] * per, (got["me"] + 1) * per), axis=d)
            np.testing.assert_array_equal(got["masters"][name], want, err_msg=name)
            np.testing.assert_array_equal(got["moments"][name],
                                          np.take(one["opt"][i]["exp_avg"], range(got["me"] * per,
                                                                                 (got["me"] + 1) * per), axis=d),
                                          err_msg=name)

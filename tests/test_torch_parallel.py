"""The port's parallel library (``dotaclient_tpu_torch/parallel``) against
the JAX package's: the mesh's layout, its errors and row rules, the
partition rule on every leaf of the tiny policy, and, in one spawned gloo
world of 4 ranks (``tests/torch_world.py``), ring and Ulysses attention
(causal and not), the GPipe pipeline, the explicit expert dispatch with
capacity drops, the dcn x data groups, the probe and the idempotent
runtime. The JAX side runs each primitive under ``shard_map`` on a mesh of
``jax.devices()[:4]`` (the conftest's 8 CPU devices). Inputs are numpy from
a seed; the tolerance is the reference's own, 2e-5 at f32."""

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from dotaclient_tpu.config import MeshConfig as JaxMeshConfig
from dotaclient_tpu.parallel import expert as jexpert
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import pipeline as jpipeline
from dotaclient_tpu.parallel import sequence as jsequence
from dotaclient_tpu.parallel.sharding import param_spec as jax_param_spec
from dotaclient_tpu_torch.config import MeshConfig
from dotaclient_tpu_torch.models.policy import make_policy
from dotaclient_tpu_torch.parallel import (
    batch_axes, batch_shard_count, data_sharding, make_mesh, param_spec, replicated, row_sharding,
    state_shardings,
)
from dotaclient_tpu_torch.train.ppo import init_train_state
from tests.test_torch_common import flax_shapes, tiny_configs
from tests.torch_world import run_world

ATOL = 2e-5
WORLD = 4
B, T, H, D = 2, 16, 4, 8          # attention: batch, sequence, heads, head width
S, M, PD, PB = WORLD, 4, 6, 8     # pipeline: stages, microbatches, width, batch
E, MD, F, MB, CF = 8, 8, 12, 16, 1.0   # experts, model width, FFN width, tokens, capacity factor


def inputs():
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "q": f32(B, T, H, D), "k": f32(B, T, H, D), "v": f32(B, T, H, D),
        "w": (f32(S, PD, PD) * 0.5), "b": f32(S, PD) * 0.1, "x": f32(PB, PD), "M": M,
        "mx": f32(MB, MD), "gate": f32(MD, E), "w1": f32(E, MD, F) * 0.3, "b1": f32(E, F) * 0.1,
        "w2": f32(E, F, MD) * 0.3, "b2": f32(E, MD) * 0.1, "cf": CF,
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank-side case, run once in one world of 4 ranks."""
    return run_world(WORLD, "tests.torch_world:parallel_ranks", inputs(), tmp_path_factory.mktemp("pworld"))


def jax_mesh():
    return JaxMesh(np.asarray(jax.devices()[:WORLD]), ("data",))


# -- the collective primitives against the JAX package ---------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax(world, kind, causal):
    p = inputs()
    make = jsequence.make_ring_attention if kind == "ring" else jsequence.make_ulysses_attention
    want = np.asarray(make(jax_mesh(), "data", causal=causal)(*(jnp.asarray(p[n]) for n in "qkv")))
    oracle = np.asarray(jsequence.reference_attention(*(jnp.asarray(p[n]) for n in "qkv"), causal=causal))
    for r, res in enumerate(world):
        np.testing.assert_allclose(res[f"{kind}/{causal}"], want, rtol=0, atol=ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res[f"{kind}/{causal}"], oracle, rtol=0, atol=ATOL)
        if kind == "ring":
            # the rank's own shard is its rows of the sequence
            Tl = T // WORLD
            np.testing.assert_array_equal(res[f"ring_local/{causal}"], res[f"ring/{causal}"][:, r * Tl:(r + 1) * Tl])


def test_pipeline_matches_jax_and_sequential_stages(world):
    p = inputs()
    stage = lambda prm, x: jnp.tanh(x @ prm["w"] + prm["b"])  # noqa: E731
    pipe = jpipeline.make_pipeline(stage, jax_mesh(), "data", M)
    want = np.asarray(pipe({"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])}, jnp.asarray(p["x"])))
    seq = p["x"]
    for s in range(S):
        seq = np.tanh(seq @ p["w"][s] + p["b"][s])
    for res in world:
        np.testing.assert_allclose(res["pipe"], want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(res["pipe"], seq, rtol=0, atol=ATOL)


def test_expert_dispatch_matches_jax_with_capacity_drops(world):
    p = inputs()
    layer = jexpert.make_expert_dispatch(jax_mesh(), "data", capacity_factor=CF)
    want = np.asarray(layer(*(jnp.asarray(p[n]) for n in ("mx", "gate", "w1", "b1", "w2", "b2"))))
    # capacity 1 a rank's expert: some tokens are dropped, their rows zero
    dropped = np.all(want == 0.0, axis=1)
    assert 0 < dropped.sum() < MB
    per = MB // WORLD
    for r, res in enumerate(world):
        np.testing.assert_allclose(res["moe"], want, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(np.all(res["moe"] == 0.0, axis=1), dropped)
        np.testing.assert_array_equal(res["moe_local"], res["moe"][r * per:(r + 1) * per])


def test_world_groups_probe_and_runtime(world):
    for r, res in enumerate(world):
        assert res["shape"] == {"data": WORLD, "model": 1} and res["coords"] == {"data": r, "model": 0}
        assert res["probe_ms"] > 0.0
        d = res["dcn"]
        assert d["shape"] == {"dcn": 2, "data": 2, "model": 1}
        assert d["coords"] == {"dcn": r // 2, "data": r % 2, "model": 0}
        # ranks 1..4: the batch group is all of them, a data group the
        # slice's two, a dcn group the two of one data index
        assert d["batch_sum"] == 10.0
        assert d["data_sum"] == (3.0 if r < 2 else 7.0)
        assert d["dcn_sum"] == (4.0 if r % 2 == 0 else 6.0)
        assert res["idempotent"] is True


# -- the mesh's layout and rules, with no processes ------------------------------------------------


LAYOUTS = [
    (8, {}), (8, {"dcn_slices": 2}), (8, {"dcn_slices": 2, "model_parallel": 2}), (8, {"data_parallel": 2}),
    (8, {"data_parallel": 3, "model_parallel": 2}), (4, {"model_parallel": 4}), (1, {}),
]


@pytest.mark.parametrize("n, over", LAYOUTS)
def test_mesh_layout_matches_jax(n, over):
    jm = jmesh.make_mesh(JaxMeshConfig(**over), devices=jax.devices()[:n])
    jcfg, cfg = JaxMeshConfig(**over), MeshConfig(**over)
    ids = {d.id: i for i, d in enumerate(jax.devices()[:n])}
    for rank in range(n):
        m = make_mesh(cfg, world_size=n, rank=rank)
        assert m.shape == dict(jm.shape)
        assert m.axis_names == tuple(jm.axis_names)
        assert batch_axes(m, cfg) == jmesh.batch_axes(jm, jcfg)
        assert batch_shard_count(m, cfg) == jmesh.batch_shard_count(jm, jcfg)
        in_mesh = [ids[d.id] for d in jm.devices.flat]
        assert m.member == (rank in in_mesh)
        if m.member:
            # the rank's coordinates are its device's place in the JAX mesh
            where = np.argwhere(np.vectorize(lambda d: ids[d.id])(jm.devices) == rank)[0]
            assert m.coords == dict(zip(jm.axis_names, (int(i) for i in where)))
            for rows in (16, 3, 0):
                jsh = jmesh.row_sharding(jm, jcfg, rows)
                idx = jsh.devices_indices_map((rows,))
                dev = jax.devices()[rank]
                want = idx[dev][0]
                got = row_sharding(m, cfg, rows)
                assert (got.start, got.stop) == (want.start or 0, rows if want.stop is None else want.stop)


@pytest.mark.parametrize("n, over", [(8, {"dcn_slices": 3}), (4, {"data_parallel": 5}), (6, {"model_parallel": 4}),
                                     (8, {"dcn_slices": 2, "data_parallel": 3, "model_parallel": 2})])
def test_mesh_errors_match_jax(n, over):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(JaxMeshConfig(**over), devices=jax.devices()[:n])
    with pytest.raises(ValueError) as perr:
        make_mesh(MeshConfig(**over), world_size=n, rank=0)
    assert str(perr.value) == str(jerr.value)


def test_row_rules():
    cfg = MeshConfig(dcn_slices=2)
    m = make_mesh(cfg, world_size=8, rank=5)           # dcn 1, data 1
    assert data_sharding(m, cfg, 16) == slice(10, 12)
    assert replicated(m, 16) == slice(0, 16)
    assert row_sharding(m, cfg, 12) == replicated(m, 12)
    with pytest.raises(ValueError, match="not divisible"):
        data_sharding(m, cfg, 12)


# -- the partition rule ----------------------------------------------------------------------------


def _jax_dim(spec):
    """The dimension a JAX PartitionSpec cuts over the model axis, or None."""
    for i, a in enumerate(tuple(spec)):
        if a == "model":
            return i
    return None


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_param_spec_matches_jax_on_every_leaf(n_model):
    jcfg, _ = tiny_configs()
    mc = JaxMeshConfig(model_parallel=n_model, data_parallel=1)
    jm = jmesh.make_mesh(mc, devices=jax.devices()[:n_model])
    leaves = jax.tree_util.tree_leaves_with_path(flax_shapes(jcfg))
    assert leaves
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        want = _jax_dim(jax_param_spec(leaf.shape, jm, mc, name))
        assert param_spec(leaf.shape, name, n_model) == want, name
    # the expert rule, which the LSTM policy has no leaf for
    for shape, path in (((8, 16, 32), "['expert_w1']"), ((6, 16, 32), "['expert_w1']"), ((4,), "['bias']")):
        want = _jax_dim(jax_param_spec(shape, jm, mc, path))
        assert param_spec(shape, path, n_model) == want


def test_state_shardings_cover_params_and_moments():
    _, pcfg = tiny_configs()
    policy = make_policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    state = init_train_state(policy, pcfg.ppo)
    names = [n for n, _ in policy.named_parameters()]
    for n_model in (1, 2):
        specs = state_shardings(state, n_model)
        assert set(specs) == {f"{k}/{n}" for n in names for k in ("params", "opt_state/exp_avg",
                                                                   "opt_state/exp_avg_sq")}
        for n in names:
            assert specs[f"opt_state/exp_avg/{n}"] == specs[f"params/{n}"] == specs[f"opt_state/exp_avg_sq/{n}"]
        if n_model == 1:
            assert set(specs.values()) == {None}
    # a Linear weight [out, in] is the Flax kernel transposed: the column cut
    # of the kernel's last axis is the weight's first
    linear = next(n for n, m in policy.named_modules() if isinstance(m, torch.nn.Linear))
    w = dict(policy.named_parameters())[f"{linear}.weight"]
    if w.shape[0] % 2 == 0:
        assert state_shardings(state, 2)[f"params/{linear}.weight"] == 0

"""The port's data-parallel training against the JAX package's, in one
spawned gloo world of 4 ranks (``tests/torch_world.py``).

The world-2 cases run on ranks 0 and 1 (an explicit ``data_parallel=2``
mesh takes the first ranks) beside world-1 references on rank 0; dcn 2 x
data 2 runs on all four against data 4. The JAX side builds its meshes of
``jax.devices()[:n]``. Held:

* the fused step at world 2 (lane-sharded actor, global loss) against JAX's
  on a 2-device mesh from the same converted params, noise and jitter;
* the rollout and the update the same whatever the world size, from the
  actor's own draws: the ranks' chunks concatenated equal world 1's, the
  ranks' params equal each other bitwise and world 1's within tolerance;
* games that do not split (3 on 2 ranks) replicated on every rank;
* shard-local minibatches: the JAX package's permutation rule and a lane
  never crossing ranks;
* unequal valid counts on the two ranks: the global reduction matches the
  one-card update and JAX, where a mean of the ranks' means does not;
* the buffered epoch step (minibatches gathered across ranks) at world 2
  against JAX's on a 2-device mesh;
* dcn 2 x data 2 equal to data 4 (``tests/test_dcn.py``);
* the ring's divisibility messages and ``buffer/shard_bytes``;
* the learner's checkpoint and actor state restored 2 -> 1 and 1 -> 2, its
  record at world 2 against the multichip tier, and the calls once refused
  naming item 7b (the host-fed modes, an MoE core) now building learners;
* ``initialize_runtime`` idempotent.

Tolerances: metrics 1e-4 relative (1e-6 absolute), params the train tests'
rule (1e-4 relative, 1e-6 absolute, at most 1% of elements past it, none
past two Adam steps of the learning rate a step: a gradient within
rounding of zero flips its Adam step)."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.actor.device_rollout import DeviceActor as JaxDeviceActor
from dotaclient_tpu.buffer import TrajectoryBuffer as JaxTrajectoryBuffer
from dotaclient_tpu.parallel import make_mesh as jax_make_mesh
from dotaclient_tpu.train import fused as jfused
from dotaclient_tpu.train import ppo as jppo
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.parallel import make_mesh
from dotaclient_tpu_torch.train import fused as pfused
from dotaclient_tpu_torch.utils import schema, telemetry
from tests.test_torch_common import flax_params, jax_policy, tiny_configs
from tests.test_torch_rollout import jax_randomness
from tests.test_torch_train import batch_to, make_batch
from tests.torch_world import run_world

WORLD = 4
RTOL, ATOL = 1e-4, 1e-6
MAX_EXCLUDED = 0.01


def configs(**over):
    """The tiny model in both packages, with ``over`` applied to env, ppo and
    buffer fields by name."""
    out = []
    for cfg in tiny_configs():
        fields = {}
        for sub in ("env", "ppo", "buffer"):
            obj = getattr(cfg, sub)
            mine = {k: v for k, v in over.items() if k in {f.name for f in dataclasses.fields(obj)}}
            fields[sub] = dataclasses.replace(obj, **mine)
        out.append(dataclasses.replace(cfg, log_every=1, checkpoint_every=1_000_000, **fields))
    return tuple(out)


FUSED = dict(n_envs=4, opponent="selfplay", max_dota_time=0.4, rollout_len=3, minibatches=1)
# the kl_target controller on: its post-update KL is a global mean too
TRAIN = dict(rollout_len=5, batch_rollouts=4, kl_target=0.001)


def unequal_valid(batch):
    """Rank 0's rows (0, 1) almost all padding, rank 1's (2, 3) all valid."""
    valid = np.ones_like(batch["valid"])
    valid[:2] = 0.0
    valid[0, :2] = 1.0
    return {**batch, "valid": valid}


def jax_inputs():
    """The inputs both sides take (cheap: no update is compiled): the JAX
    fused step's actor and its randomness, the batches, their params."""
    jcfg, pcfg = configs(**FUSED)
    params = flax_params(jcfg, seed=3)
    mesh2 = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:2])
    jactor = JaxDeviceActor(jcfg, jax_policy(jcfg)[0], seed=5, mesh=mesh2)
    js = jactor.state
    noise, _, jitter = jax_randomness(jcfg, jactor.n_lanes)(js.key, js.sim.key)
    fused = {
        "cfg": pcfg, "params": {k: v.numpy() for k, v in convert(params).items()},
        "sim": {k: np.asarray(getattr(js.sim, k)) for k in js.sim._fields if k != "key"},
        "noise": {h: np.asarray(v) for h, v in noise.items()},
        "jitter": {k: np.asarray(v) for k, v in jitter.items()},
        "degenerate_cfg": configs(**{**FUSED, "n_envs": 3})[1],
        "minibatch_cfg": configs(**{**FUSED, "minibatches": 2, "epochs_per_batch": 2})[1],
    }
    jcfg_t, pcfg_t = configs(**TRAIN)
    tparams = flax_params(jcfg_t, seed=1)
    port_tparams = {k: v.numpy() for k, v in convert(tparams).items()}
    d = {"cfg": pcfg_t, "params": port_tparams, "batch": unequal_valid(make_batch(pcfg_t, tparams, seed=2))}
    _, pcfg_e = configs(**TRAIN, minibatches=2, epochs_per_batch=2)
    perms = np.stack([np.random.default_rng(9).permutation(4) for _ in range(2)]).astype(np.int32)
    perms[1] = perms[1][::-1]
    e = {"cfg": pcfg_e, "params": port_tparams, "batch": make_batch(pcfg_e, tparams, seed=4), "perms": perms}
    jax_only = {"fused": (jcfg, params, mesh2, jactor), "train": (jcfg_t, tparams)}
    return {"fused": fused, "d": d, "e": e}, jax_only


def jax_outputs(inputs, jax_only):
    """The JAX package's fused step, two train steps and the epoch step on
    2-device meshes: the references."""
    out = {}
    jcfg, params, mesh2, jactor = jax_only["fused"]
    jpolicy = jax_policy(jcfg)[0]
    jstate = jppo.init_train_state(jax.tree.map(jnp.asarray, params), jcfg.ppo)
    jstate, _, jm, _ = jfused.make_fused_step(jpolicy, jcfg, mesh2, jactor)(jstate, jactor.state, jstate.params)
    out["a"] = {"metrics": {k: float(v) for k, v in jm.items()}, "params": port_np(jstate.params)}
    jcfg, tparams = jax_only["train"]
    step = jppo.make_train_step(jax_policy(jcfg)[0], jcfg, mesh2)
    jstate = jppo.init_train_state(jax.tree.map(jnp.asarray, tparams), jcfg.ppo)
    ms = []
    for _ in range(2):
        jstate, m = step(jstate, batch_to(inputs["d"]["batch"], jnp.asarray))
        ms.append({k: float(v) for k, v in m.items()})
    out["d"] = {"metrics": ms, "params": port_np(jstate.params)}
    jcfg = dataclasses.replace(jcfg, ppo=dataclasses.replace(jcfg.ppo, minibatches=2, epochs_per_batch=2))
    estep = jppo.make_epoch_step(jax_policy(jcfg)[0], jcfg, mesh2)
    jstate = jppo.init_train_state(jax.tree.map(jnp.asarray, tparams), jcfg.ppo)
    jstate, m = estep(jstate, batch_to(inputs["e"]["batch"], jnp.asarray), jnp.asarray(inputs["e"]["perms"]))
    out["e"] = {"metrics": [{k: float(v) for k, v in m.items()}], "params": port_np(jstate.params)}
    return out


def port_np(jparams):
    return {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray, jparams)).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world runs while the JAX side compiles its references."""
    inputs, jax_only = jax_inputs()
    _, lcfg = configs(n_envs=12, max_dota_time=4.0, rollout_len=4, batch_rollouts=4, minibatches=2,
                      capacity_rollouts=16, min_fill=4)
    _, dcfg = configs(**TRAIN)
    payload = {
        **inputs,
        "dcn": {"cfg": dcfg, "params": inputs["d"]["params"], "batch": make_batch(
            dcfg, flax_params(tiny_configs()[0], seed=1), seed=6)},
        "learner": {"cfg": lcfg, "dir": str(tmp_path_factory.mktemp("dp_ck")), "steps": 4},
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, WORLD, "tests.torch_world:data_parallel_ranks", payload,
                            tmp_path_factory.mktemp("dpworld"), timeout_s=120.0, deadline_s=400.0)
        side = {**jax_outputs(inputs, jax_only), **{f"{k}_in": v for k, v in inputs.items()}}
        return side, ranks.result()


def assert_metrics_close(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")


def assert_params_close(got, want, lr, steps, what):
    """The train tests' rule: elements past (RTOL, ATOL) at most
    MAX_EXCLUDED of all, and none past ``steps`` Adam steps of 2 x lr."""
    past = total = 0
    for name, w in want.items():
        g = got[name]
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr * steps + ATOL, err_msg=f"{what}: {name}")
        past += int((np.abs(g - w) > ATOL + RTOL * np.abs(w)).sum())
        total += w.size
    assert past <= MAX_EXCLUDED * total, (what, past, total)


def assert_bitwise(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def concat_lanes(x, y):
    if isinstance(x, dict):
        return {k: concat_lanes(x[k], y[k]) for k in x}
    if isinstance(x, tuple):
        return tuple(concat_lanes(a, b) for a, b in zip(x, y))
    return np.concatenate([x, y], axis=0)


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


# -- the fused step ------------------------------------------------------------------------------


def test_fused_step_at_world_2_matches_jax(world):
    side, ranks = world
    lr = side["fused_in"]["cfg"].ppo.learning_rate
    for r in (0, 1):
        a = ranks[r]["a"]
        assert a["lane_shards"] == 2 and a["lanes"] == 4 and a["games"] == (2 * r, 2 * r + 2)
        assert_metrics_close(a["metrics"], side["a"]["metrics"], f"rank {r}")
        assert_params_close(a["params"], side["a"]["params"], lr, 1, f"rank {r}")
    # every rank holds the same params, bitwise
    assert_bitwise(ranks[0]["a"]["params"], ranks[1]["a"]["params"], "ranks")


def test_rollout_and_update_do_not_depend_on_the_world_size(world):
    side, ranks = world
    w1, (w2a, w2b) = ranks[0]["b1"], (ranks[0]["b2"], ranks[1]["b2"])
    assert w1["lane_shards"] == 1 and w2a["lane_shards"] == 2
    # the first chunk from the actor's own draws: the shards, concatenated
    got = concat_lanes(w2a["chunk"], w2b["chunk"])
    for k in ("actions", "dones"):
        assert_tree_equal(got[k], w1["chunk"][k], k)
    for k in ("obs", "rewards", "behavior_logp", "carry0"):
        for g, w in zip(jax.tree.leaves(got[k]), jax.tree.leaves(w1["chunk"][k])):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)
    # the stream is the run's, not the rank's
    np.testing.assert_array_equal(w2a["gen"], w1["gen"])
    np.testing.assert_array_equal(w2b["gen"], w1["gen"])
    assert_bitwise(w2a["params"], w2b["params"], "ranks")
    assert_params_close(w2a["params"], w1["params"], side["fused_in"]["cfg"].ppo.learning_rate, 2, "world 2 vs 1")
    for m2, m1 in zip(w2a["metrics"], w1["metrics"]):
        assert_metrics_close(m2, m1, "world 2 vs 1")
    # the drained episode stats: summed over the ranks, the world-1 totals
    for k in ("episodes_done", "env_steps", "rollouts_shipped"):
        assert w2a["drained"][k] == w2b["drained"][k] == w1["drained"][k], k


def test_degenerate_games_are_replicated(world):
    _, ranks = world
    w1, w2a, w2b = ranks[0]["c1"], ranks[0]["c2"], ranks[1]["c2"]
    assert w2a["lane_shards"] == w2b["lane_shards"] == 1
    assert_tree_equal(w2a["chunk"], w1["chunk"])
    assert_tree_equal(w2b["chunk"], w1["chunk"])
    assert_bitwise(w2a["params"], w1["params"], "rank 0 vs world 1")
    assert_bitwise(w2b["params"], w1["params"], "rank 1 vs world 1")


def test_fused_minibatches_at_world_2(world):
    _, ranks = world
    w2a, w2b = ranks[0]["mb2"], ranks[1]["mb2"]
    assert_bitwise(w2a["params"], w2b["params"], "ranks")
    assert all(np.isfinite(m["loss"]) and m["health_ok"] == 1.0 for m in w2a["metrics"])


@pytest.mark.parametrize("step", [0, 7])
def test_lane_minibatches_follow_the_reference_and_stay_on_their_shard(step):
    """JAX's shard-local shuffle fed to the port as ``perm``: minibatch m of
    the reference is every shard's m-th group; the port's own draw keeps
    each shard's lanes on the shard."""
    S, Ls, M, seed = 2, 6, 3, 11
    lanes = np.arange(S * Ls)
    chunk = {"rewards": lanes.astype(np.float32)[:, None]}
    want = jfused.lane_minibatches({k: jnp.asarray(v) for k, v in chunk.items()}, step, seed, S * Ls, S, M)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    perm = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, Ls))(jax.random.split(key, S)))
    got = [pfused.lane_minibatches({"rewards": torch.from_numpy(chunk["rewards"][s * Ls:(s + 1) * Ls])}, step,
                                   seed, Ls, M, S, s, perm=torch.from_numpy(perm.copy())) for s in range(S)]
    for m in range(M):
        # minibatch m: shard 0's m-th group, then shard 1's (the chunk's
        # rewards are the lanes' global ids)
        joined = np.concatenate([got[s][m]["rewards"].numpy() for s in range(S)])
        np.testing.assert_array_equal(joined, np.asarray(want["rewards"][m]))
    for s in range(S):
        own = pfused.lane_minibatches({"rewards": torch.from_numpy(chunk["rewards"][s * Ls:(s + 1) * Ls])},
                                      step, seed, Ls, M, S, s)
        ids = np.concatenate([mb["rewards"].numpy()[:, 0] for mb in own])
        assert sorted(ids.tolist()) == list(range(s * Ls, (s + 1) * Ls))


# -- the update over the global batch --------------------------------------------------------------


def test_unequal_valid_counts_reduce_globally(world):
    side, ranks = world
    lr = side["d_in"]["cfg"].ppo.learning_rate
    w1 = ranks[0]["d1"]
    for r in (0, 1):
        w2 = ranks[r]["d2"]
        for i in range(2):
            assert_metrics_close(w2["metrics"][i], w1["metrics"][i], f"rank {r} step {i} vs world 1")
            assert_metrics_close(w2["metrics"][i], side["d"]["metrics"][i], f"rank {r} step {i} vs jax")
        assert_params_close(w2["params"], side["d"]["params"], lr, 2, f"rank {r} vs jax")
    assert_bitwise(ranks[0]["d2"]["params"], ranks[1]["d2"]["params"], "ranks")
    # the teeth: a mean of the ranks' own means is another loss
    per_rank = (ranks[0]["d_local_loss"] + ranks[1]["d_local_loss"]) / 2
    glob = w1["metrics"][0]["loss"]
    assert abs(per_rank - glob) > 100 * (ATOL + RTOL * abs(glob)), (per_rank, glob)


def test_buffered_epoch_step_at_world_2_matches_jax(world):
    side, ranks = world
    lr = side["e_in"]["cfg"].ppo.learning_rate
    for r in (0, 1):
        w2 = ranks[r]["e2"]
        assert w2["step"] == 4
        assert_metrics_close(w2["metrics"][0], side["e"]["metrics"][0], f"rank {r} vs jax")
        assert_metrics_close(w2["metrics"][0], ranks[0]["e1"]["metrics"][0], f"rank {r} vs world 1")
        assert_params_close(w2["params"], side["e"]["params"], lr, 4, f"rank {r} vs jax")
    assert_bitwise(ranks[0]["e2"]["params"], ranks[1]["e2"]["params"], "ranks")


def test_dcn_2_by_data_2_equals_data_4(world):
    _, ranks = world
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["f_dcn"]["losses"], ranks[r]["f_flat"]["losses"], rtol=1e-5)
        assert np.all(np.isfinite(ranks[r]["f_flat"]["losses"]))
        assert_bitwise(ranks[r]["f_dcn"]["params"], ranks[0]["f_flat"]["params"], f"rank {r}")


# -- the ring, the learner, the runtime ------------------------------------------------------------


@pytest.mark.parametrize("over", [dict(capacity_rollouts=5), dict(batch_rollouts=5, capacity_rollouts=16),
                                  dict(dcn=True, capacity_rollouts=6)])
def test_ring_divisibility_messages_match_jax(over):
    over = dict(over)
    dcn = over.pop("dcn", False)
    jcfg, pcfg = configs(**over)
    n = 4 if dcn else 2
    if dcn:
        jcfg, pcfg = (dataclasses.replace(c, mesh=dataclasses.replace(c.mesh, dcn_slices=2)) for c in (jcfg, pcfg))
    with pytest.raises(ValueError) as jerr:
        JaxTrajectoryBuffer(jcfg, jax_make_mesh(jcfg.mesh, devices=jax.devices()[:n]))
    with pytest.raises(ValueError) as perr:
        TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry(),
                         mesh=make_mesh(pcfg.mesh, world_size=n, rank=0))
    assert str(perr.value) == str(jerr.value)


def test_ring_shard_bytes_and_shares():
    _, pcfg = configs(capacity_rollouts=16, batch_rollouts=8, min_fill=6)
    regs = {n: telemetry.Registry() for n in (1, 4)}
    rings = {n: TrajectoryBuffer(pcfg, device="cpu", registry=regs[n], mesh=make_mesh(pcfg.mesh, world_size=n,
                                                                                      rank=n - 1))
             for n in (1, 4)}
    whole = regs[1].snapshot()["buffer/shard_bytes"]
    assert whole > 0 and regs[4].snapshot()["buffer/shard_bytes"] == whole / 4
    assert (rings[4].capacity, rings[4].batch_size, rings[4]._min_fill) == (4, 2, 2)


def ordered(pipe):
    """A snapshot's chunks in consumption order (store rows, versions) and
    its actor leaves: what a restore must carry, whatever the slots."""
    buf = pipe["buffer"]
    order = [int(s) for s in buf["order"] if s >= 0]
    rows = jax.tree.map(lambda t: t[order], buf["store"])
    return {"rows": rows, "versions": buf["slot_version"][order], "actor": pipe["actor_leaves"]}


def test_learner_restores_across_world_sizes(world):
    _, ranks = world
    w2, w1 = ranks[0]["g_w2"], ranks[0]["g_w1"]
    # both ranks gathered the same whole-batch snapshot
    assert_tree_equal(ordered(ranks[1]["g_w2"]["pipeline"]), ordered(w2["pipeline"]))
    assert len(ordered(w2["pipeline"])["versions"]) > 0          # the ring holds chunks at the end
    for got, want, what in ((ranks[0]["g_2to1"], w2, "2 -> 1"), (ranks[0]["g_1to2"], w1, "1 -> 2"),
                            (ranks[1]["g_1to2"], w1, "1 -> 2, rank 1")):
        assert_tree_equal(ordered(got["pipeline"]), ordered(want["pipeline"]), what)
        assert_bitwise(got["params"], want["params"], what)
        assert (got["step"], got["version"]) == (want["step"], want["version"]), what


def test_learner_record_at_world_2_meets_the_multichip_tier(world):
    _, ranks = world
    g = ranks[0]["g_gauges"]
    assert g["mesh/n_devices"] == 2.0 and g["mesh/data_shards"] == 2.0 and g["mesh/lane_shards"] == 2.0
    assert g["fused/lanes_per_shard"] == 6.0 and g["buffer/shard_bytes"] > 0 and g["learner/psum_ms"] > 0
    lines = ranks[0]["g_lines"]
    assert lines and "g_lines" not in ranks[1]       # rank 0 alone writes the record
    assert schema.validate_lines(lines, schema.LEARNER_TIERS) == []
    assert schema.validate_lines(lines, schema.MULTICHIP_KEYS) == []


def test_refusals_name_item_7b(world):
    """The calls that raised naming item 7b now build learners: the
    host-fed modes with the ring's single door and rank 0's pool, the MoE
    core's actor routing over the batch group, and ``model_parallel=2`` in
    the config beside a data-parallel mesh (whose model axis is 1: no
    tensor-parallel layout)."""
    _, ranks = world
    for r in (0, 1):
        built = ranks[r]["g_refusals"]
        assert set(built) == {"vec", "scalar", "external", "moe", "model_parallel"}
        for mode in ("vec", "scalar"):
            assert built[mode] == {"pool": r == 0, "door": True}, (r, mode)
        assert built["external"] == {"pool": False, "door": True}
        assert built["moe"]["routes_over"] and not built["moe"]["tp"]
        assert not built["model_parallel"]["tp"]


def test_initialize_runtime_is_idempotent(world):
    _, ranks = world
    assert all(r["idempotent"] is True for r in ranks)

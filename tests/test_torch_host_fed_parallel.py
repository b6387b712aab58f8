"""The host-fed actor modes on a world of 2: the port's single door against
the JAX package's one ring on a 2-device mesh and the port's world 1, in
one spawned gloo world (``tests/torch_world.py``) while the references run
in this process. Held:

* the ring through a script of adds and takes with a stale drop and an
  overflow eviction between admission and take, a held batch requeued,
  and a snapshot: every batch, the ranks' shares concatenated, bitwise
  the world-1 ring's and JAX's, with the same counters; rows that crossed
  shards counted; the snapshot restored at world 1 takes the same
  batches;
* each rank's resident rows after an ingest: exactly the rows its shares
  of the next batches hold, and ``buffer/shard_bytes`` half the world-1
  ring's;
* an ``external`` learner fed the same encoded chunks (mixed versions, so
  the ring drops a stale row) through rank 0's in-process transport: its
  batches bitwise world 1's, its books rank 0's and world 1's, its first
  update world 1's, its params equal on both ranks, and within the data
  parallel tests' rule of world 1's and of JAX's external learner on a
  2-device mesh;
* a ``vec`` learner: rank 0 alone runs the pool, whose first rows equal
  world 1's pool's bitwise; the batches and the first update as above.

Tolerances: the data-parallel tests' (``tests/test_torch_data_parallel.py``).
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

from dotaclient_tpu.buffer import TrajectoryBuffer as JaxTrajectoryBuffer
from dotaclient_tpu.parallel import make_mesh as jax_make_mesh
from dotaclient_tpu.train.learner import Learner as JaxLearner
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu.transport.queues import InProcTransport as JaxInProcTransport
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.utils import telemetry
from tests.test_torch_buffered import buffered_configs, chunk, telemetry_registry
from tests.test_torch_data_parallel import assert_bitwise, assert_params_close, assert_tree_equal, concat_lanes
from tests.test_torch_external import rows_of
from tests.torch_world import run_ring_script, run_world

WORLD = 2
RTOL = 1e-4


def world2(cfg):
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, data_parallel=2))


def tagged(cfg, ids, versions, seed):
    """Rows of ``chunk`` with their ids in ``rewards[:, 0]`` (1000 + id)."""
    rows = rows_of(chunk(cfg, len(ids), seed), versions)
    for (_, arrays), i in zip(rows, ids):
        arrays["rewards"] = arrays["rewards"].copy()
        arrays["rewards"][0] = 1000.0 + i
    return rows


def ring_case():
    """The placement ingest (8 rows), then: a take; 3 rows; a held take
    after which row 4 is stale (its drop shifts every position by one, so
    rows cross shards); 6 rows into a ring of 2 free slots (2 evictions, 2
    rows dropped); a snapshot; the requeue; and takes to the end."""
    jcfg, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    jcfg, pcfg = (dataclasses.replace(world2(c), buffer=dataclasses.replace(c.buffer, max_weight_staleness=2))
                  for c in (jcfg, pcfg))
    placement = [("add", tagged(pcfg, range(8), [0, 0, 0, 0, 1, 2, 2, 2], 1), 2)]
    script = [("take", 2, False), ("add", tagged(pcfg, range(8, 11), [3] * 3, 2), 3), ("take", 4, True),
              ("add", tagged(pcfg, range(11, 17), [4] * 6, 3), 4), ("snapshot",), ("requeue",),
              ("take", 4, False), ("take", 4, False), ("take", 4, False)]
    return jcfg, pcfg, placement, script


def encoded(cfg, n, versions, seed):
    return [J.encode_rollout(a, **m).SerializeToString() for m, a in rows_of(chunk(cfg, n, seed), versions)]


def learner_cases():
    jcfg, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    jcfg, pcfg = (dataclasses.replace(world2(c), buffer=dataclasses.replace(c.buffer, max_weight_staleness=1))
                  for c in (jcfg, pcfg))
    # versions 0 to 2 mixed: the second ingest (at version 1, 8 rows into a
    # ring of 4 free slots) evicts 4 rows, its version-0 row 14 is stale by
    # the third take (at version 2), and the last 4 rows fill that batch
    versions = [0, 1, 0, 1, 1, 1, 1, 0] + [1, 1, 0, 1, 2, 0, 2, 2] + [2] * 4
    ext = {"cfg": pcfg, "blobs": encoded(pcfg, 20, versions, 21), "steps": 3}
    vec = dataclasses.replace(pcfg, env=dataclasses.replace(pcfg.env, n_envs=2, opponent="selfplay",
                                                            max_dota_time=2.0))
    return jcfg, ext, {"cfg": vec, "steps": 3}


def jax_ring(jcfg, placement, script):
    """The script through JAX's ring on a 2-device mesh (no snapshot op)."""
    from dotaclient_tpu_torch.utils.tree import tree_map

    ring = JaxTrajectoryBuffer(jcfg, jax_make_mesh(jcfg.mesh, devices=jax.devices()[:2]),
                               registry=telemetry_registry())
    out, ticket = [], None
    for op in placement + script:
        if op[0] == "add":
            out.append(ring.add([(dict(m), a) for m, a in op[1]], op[2]))
        elif op[0] == "take":
            got = ring.take(current_version=op[1], hold=op[2])
            if got is not None and op[2]:
                got, ticket = got
            out.append(None if got is None else tree_map(np.asarray, got))
        elif op[0] == "snapshot":
            out.append(None)
        else:
            ring.requeue(ticket)
            out.append(None)
    return out, ring.metrics()


def world1_learner(lc, actor):
    """The port's learner at world 1 on ``lc``, recorded as the ranks'
    are."""
    from dotaclient_tpu_torch.protos import dota_pb2 as pb
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.transport.queues import InProcTransport
    from tests.torch_world import _np_tree, _torch_tree, ring_books

    cfg = dataclasses.replace(lc["cfg"], mesh=dataclasses.replace(lc["cfg"].mesh, data_parallel=1))
    transport = None
    if actor == "external":
        transport = InProcTransport(registry=telemetry.Registry())
        for blob in lc["blobs"]:
            transport.publish_rollout(pb.Rollout.FromString(blob))
    reg = telemetry.Registry()
    lr = Learner(cfg, actor=actor, seed=1, device="cpu", registry=reg, transport=transport)
    if "params" in lc:
        lr.policy.load_state_dict(_torch_tree(lc["params"]))
    batches, metrics, adds = [], [], []
    take, step, add = lr.buffer.take, lr.train_step, lr.buffer.add

    def taking(*a, **k):
        got = take(*a, **k)
        if got is not None:
            batches.append(_np_tree(got[0] if isinstance(got, tuple) else got))
        return got

    def stepping(state, batch):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    def adding(rows, version):
        if rows:
            adds.append([_np_tree(a) for _, a in rows])
        return add(rows, version)

    lr.buffer.take, lr.train_step, lr.buffer.add = taking, stepping, adding
    lr.train(lc["steps"], refresh_every=1)
    out = {"batches": batches, "metrics": metrics, "books": ring_books(lr.buffer), "adds": adds[:1],
           "params": {k: v.numpy().copy() for k, v in lr.policy.state_dict().items()},
           "shard_bytes": reg.snapshot()["buffer/shard_bytes"]}
    lr.close()
    return out


def jax_external(jcfg, lc):
    """JAX's external learner on a 2-device mesh: its initial params (the
    port's learners load them) and a thunk that trains it on the blobs."""
    jt = JaxInProcTransport()
    jl = JaxLearner(jcfg, actor="external", transport=jt, seed=1)
    init = {k: v.numpy().copy() for k, v in convert(jax.tree.map(np.asarray, jl.state.params)).items()}

    def run():
        for blob in lc["blobs"]:
            jt.publish_rollout(J.pb.Rollout.FromString(blob))
        jl.train(lc["steps"], refresh_every=1)
        out = {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray, jl.state.params)).items()}
        jl._snap_engine.stop()
        return out

    return init, run


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg, pcfg, placement, script = ring_case()
    jcfg_l, ext, vec = learner_cases()
    ext["params"], jax_run = jax_external(jcfg_l, ext)
    payload = {"ring": {"cfg": pcfg, "placement": placement, "script": script}, "external": ext, "vec": vec}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, WORLD, "tests.torch_world:host_fed_ranks", payload,
                            tmp_path_factory.mktemp("hfworld"), timeout_s=120.0, deadline_s=300.0)
        reg1 = telemetry.Registry()
        one = TrajectoryBuffer(dataclasses.replace(pcfg, mesh=dataclasses.replace(pcfg.mesh, data_parallel=1)),
                               device="cpu", registry=reg1)
        side = {"ring1": run_ring_script(one, placement + script), "ring1_metrics": one.metrics(),
                "ring1_bytes": reg1.snapshot()["buffer/shard_bytes"], "cfg": pcfg,
                "jax_ring": jax_ring(jcfg, placement, script),
                "external1": world1_learner(ext, "external"), "vec1": world1_learner(vec, "vec"),
                "jax_external": jax_run()}
        return side, ranks.result()


def test_ring_batches_match_world_1_and_jax_through_drops(world):
    side, ranks = world
    _, _, placement, script = ring_case()
    ops = placement + script
    jax_ops, jax_metrics = side["jax_ring"]
    n_batches = 0
    for i, op in enumerate(ops):
        if op[0] == "add":
            assert ranks[0]["ring"]["ops"][i] == side["ring1"][i] == jax_ops[i], f"op {i}: admitted"
        elif op[0] == "take":
            got = [r["ring"]["ops"][i] for r in ranks]
            want = side["ring1"][i]
            assert (got[0] is None) == (got[1] is None) == (want is None) == (jax_ops[i] is None), f"op {i}"
            if want is not None:
                assert_tree_equal(concat_lanes(*got), want, f"op {i}")
                assert_tree_equal(concat_lanes(*got), jax_ops[i], f"op {i} vs jax")
                n_batches += 1
    assert n_batches == 4
    books = ranks[0]["ring"]["books"]["counters"]
    assert books == side["ring1_metrics"] == jax_metrics
    assert books["buffer_dropped_stale"] == 1 and books["buffer_dropped_overflow"] == 4
    # the stale drop and the evictions moved rows across shards, and every
    # rank counted the same moves
    assert ranks[0]["ring"]["rows_moved"] == ranks[1]["ring"]["rows_moved"] > 0
    # rank 1 keeps no books
    assert ranks[1]["ring"]["books"]["order"] == [] and ranks[1]["ring"]["books"]["free"] == []


def test_ring_places_each_row_on_the_shard_that_trains_it(world):
    side, ranks = world
    # after the placement ingest: rank r holds the rows of its shares of
    # the next two batches (ids 0-1 and 4-5 on rank 0, 2-3 and 6-7 on rank 1)
    for r, want in ((0, {0, 1, 4, 5}), (1, {2, 3, 6, 7})):
        placed = set((ranks[r]["ring"]["placed"] - 1000).astype(int).tolist())
        assert placed == want, (r, placed)
        assert ranks[r]["ring"]["local_cap"] == 4
        assert ranks[r]["ring"]["shard_bytes"] == side["ring1_bytes"] / 2


def test_ring_snapshot_restores_at_world_1(world):
    side, ranks = world
    _, pcfg, placement, script = ring_case()
    at = len(placement) + script.index(("snapshot",))
    snaps = [r["ring"]["ops"][at] for r in ranks]
    assert_tree_equal(snaps[1], snaps[0], "the ranks' snapshots")
    one = TrajectoryBuffer(dataclasses.replace(pcfg, mesh=dataclasses.replace(pcfg.mesh, data_parallel=1)),
                           device="cpu", registry=telemetry.Registry())
    from tests.torch_world import _torch_tree

    one.load_state_dict(_torch_tree(snaps[0]))
    rest = [("take", 4, False)] * 3
    got = run_ring_script(one, rest)
    # the snapshot folded the held batch back in front: the batches the
    # world-2 ring took after its requeue
    want = [side["ring1"][i] for i in range(at + 2, at + 5)]
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert_tree_equal(g, w, "restored at world 1")


def learner_checks(side_key, world, mode, bitwise_batches):
    """The first ``bitwise_batches`` batches bitwise world 1's (a pool
    phase after an update plays params that differ from world 1's by
    rounding), the books, the first update and the params."""
    side, ranks = world
    one = side[side_key]
    lr = side["cfg"].ppo.learning_rate
    r0, r1 = ranks[0][mode], ranks[1][mode]
    assert len(r0["batches"]) == len(r1["batches"]) == len(one["batches"]) >= 3
    for i, (a, b, w) in enumerate(zip(r0["batches"], r1["batches"], one["batches"])):
        if i < bitwise_batches:
            assert_tree_equal(concat_lanes(a, b), w, f"{mode} batch {i}")
    assert r0["books"]["counters"] == one["books"]["counters"]
    first, want = r0["metrics"][0], one["metrics"][0]
    assert abs(first["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    assert abs(first["grad_norm"] - want["grad_norm"]) <= RTOL * abs(want["grad_norm"])
    assert_bitwise(r0["params"], r1["params"], f"{mode}: the ranks")
    assert_params_close(r0["params"], one["params"], lr, r0["steps"], f"{mode}: world 2 vs world 1")
    for r in (r0, r1):
        assert r["shard_bytes"] == one["shard_bytes"] / 2
    return one, r0, r1


def test_external_learner_at_world_2_trains_world_1s_batches(world):
    one, r0, r1 = learner_checks("external1", world, "external", bitwise_batches=3)
    assert one["books"]["counters"]["buffer_dropped_stale"] > 0
    assert not r0["pool"] and not r1["pool"]


def test_external_learner_at_world_2_matches_jax_on_2_devices(world):
    side, ranks = world
    want = side["jax_external"]
    assert_params_close(ranks[0]["external"]["params"], want, side["cfg"].ppo.learning_rate,
                        ranks[0]["external"]["steps"], "world 2 vs jax")


def test_vec_learner_at_world_2_runs_the_pool_on_rank_0(world):
    one, r0, r1 = learner_checks("vec1", world, "vec", bitwise_batches=1)
    assert r0["pool"] and not r1["pool"]
    # rank 0's pool played world 1's first rows, bitwise; rank 1 got none
    assert len(r0["adds"]) == 1 and not r1["adds"]
    assert len(r0["adds"][0]) == len(one["adds"][0])
    for g, w in zip(r0["adds"][0], one["adds"][0]):
        assert_tree_equal(g, w, "the pool's first rows")

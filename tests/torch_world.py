"""Spawned gloo worlds for the port's data-parallel tests (this module holds
no test cases and imports neither JAX nor the JAX package, so a rank never
loads them).

``run_world(n, target, payload, tmp_dir)`` starts n spawned processes, each a
rank of one gloo process group (a ``file://`` rendezvous under ``tmp_dir``,
so worlds of parallel test workers never meet), calls ``target(rank, n,
payload)`` (``"module:function"``) on each and returns the ranks' results
(picklable: numpy arrays, floats) in rank order. Every collective of the
group times out after ``timeout_s``, and the world as a whole is killed
after ``deadline_s``: a hang fails the test instead of running the suite
into its clock. A rank that raises fails the world with its traceback.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from typing import Any, List


def _rank_main(rank: int, world: int, init_file: str, target: str, payload: Any, out: Any, timeout_s: float):
    try:
        import torch

        torch.set_num_threads(1)
        from dotaclient_tpu_torch.parallel import initialize_runtime

        initialize_runtime(f"file://{init_file}", world, rank, backend="gloo", timeout_s=timeout_s)
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(rank, world, payload)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        try:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # noqa: BLE001 - teardown of a failed rank
            pass


def run_world(world: int, target: str, payload: Any, tmp_dir: str, timeout_s: float = 60.0,
              deadline_s: float = 240.0) -> List[Any]:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init_file = os.path.join(str(tmp_dir), "rendezvous")
    procs = [ctx.Process(target=_rank_main, args=(r, world, init_file, target, payload, out, timeout_s),
                         daemon=True) for r in range(world)]
    env0 = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if env0 is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env0
    results: dict = {}
    end = time.monotonic() + deadline_s
    try:
        while len(results) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the world of {world} ranks did not finish within {deadline_s:.0f} s "
                                   f"(ranks done: {sorted(results)})")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [results[r] for r in range(world)]


# -- the rank side of tests/test_torch_parallel.py ---------------------------------------------------


def parallel_ranks(rank: int, world: int, p: dict) -> dict:
    """Ring and Ulysses attention (causal and not), the pipeline, the expert
    dispatch, the probe, the dcn x data groups and the idempotent runtime,
    on a world of ``world`` ranks over one ``data`` axis."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dotaclient_tpu_torch.config import MeshConfig
    from dotaclient_tpu_torch.parallel import (
        collective_probe_ms, initialize_runtime, make_expert_dispatch, make_mesh, make_pipeline,
        make_ring_attention, make_ulysses_attention,
    )
    from dotaclient_tpu_torch.parallel.collectives import psum

    t = {k: torch.from_numpy(v) for k, v in p.items() if isinstance(v, np.ndarray)}
    mesh = make_mesh(MeshConfig())
    out = {"coords": mesh.coords, "shape": mesh.shape}
    q, k, v = t["q"], t["k"], t["v"]
    for causal in (False, True):
        out[f"ring/{causal}"] = make_ring_attention(mesh, causal=causal, gather=True)(q, k, v).numpy()
        out[f"ring_local/{causal}"] = make_ring_attention(mesh, causal=causal)(q, k, v).numpy()
        out[f"ulysses/{causal}"] = make_ulysses_attention(mesh, causal=causal, gather=True)(q, k, v).numpy()
    pipe = make_pipeline(lambda prm, x: torch.tanh(x @ prm["w"] + prm["b"]), mesh, "data", p["M"])
    out["pipe"] = pipe({"w": t["w"], "b": t["b"]}, t["x"]).numpy()
    layer = make_expert_dispatch(mesh, capacity_factor=p["cf"], gather=True)
    out["moe"] = layer(t["mx"], t["gate"], t["w1"], t["b1"], t["w2"], t["b2"]).numpy()
    out["moe_local"] = make_expert_dispatch(mesh, capacity_factor=p["cf"])(
        t["mx"], t["gate"], t["w1"], t["b1"], t["w2"], t["b2"]).numpy()
    out["probe_ms"] = collective_probe_ms(mesh, MeshConfig(), torch.device("cpu"))
    dcn = make_mesh(MeshConfig(dcn_slices=2))
    one = torch.tensor([float(rank + 1)])
    out["dcn"] = {"shape": dcn.shape, "coords": dcn.coords,
                  "batch_sum": float(psum(one, dcn.batch_group)),
                  "data_sum": float(psum(one, dcn.group("data"))), "dcn_sum": float(psum(one, dcn.group("dcn")))}
    group_before = dist.group.WORLD
    initialize_runtime()                                 # a second call: a no-op
    initialize_runtime("127.0.0.1:1", world, rank)       # explicit arguments too
    out["idempotent"] = dist.group.WORLD is group_before and dist.get_world_size() == world
    return out


# -- the rank side of tests/test_torch_data_parallel.py ----------------------------------------------


def _np_tree(tree: Any) -> Any:
    import torch

    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _torch_tree(tree: Any) -> Any:
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_torch_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _rows(tree: Any, lo: int, hi: int) -> Any:
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rows(v, lo, hi) for v in tree)
    return tree[lo:hi]


def _policy_of(cfg, params):
    from dotaclient_tpu_torch.models.policy import Policy

    policy = Policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    policy.load_state_dict(_torch_tree(params))
    return policy


def _params_np(policy):
    return {k: v.detach().numpy().copy() for k, v in policy.state_dict().items()}


def _metrics_np(m):
    return {k: float(v) for k, v in m.items()}


def data_parallel_ranks(rank: int, world: int, p: dict) -> dict:
    """The data-parallel slice's cases on a world of 4: the world-2 cases
    on ranks 0 and 1 (an explicit ``data_parallel=2`` mesh takes the first
    ranks; ranks 2 and 3 make its groups and sit out), world-1 references
    on rank 0, and dcn 2 x data 2 against data 4 on all four. Every mesh is
    made by every rank in the same order (``new_group`` is collective)."""
    import copy
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
    from dotaclient_tpu_torch.envs import torch_lane_sim as S
    from dotaclient_tpu_torch.parallel import initialize_runtime, make_mesh
    from dotaclient_tpu_torch.train import fused as pfused
    from dotaclient_tpu_torch.train import ppo as pppo
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    def mesh_of(cfg, **over):
        return make_mesh(dataclasses.replace(cfg.mesh, **over))

    policy_of, params_np, metrics_np = _policy_of, _params_np, _metrics_np

    out: dict = {}
    world2 = rank < 2

    # (a) the fused step at world 2 on the JAX side's world, params, noise
    # and jitter; (b) its own draws at world 2 and at world 1
    fc = p["fused"]
    cfg = fc["cfg"]
    m2, m1 = mesh_of(cfg, data_parallel=2), mesh_of(cfg, data_parallel=1)
    if world2:
        policy = policy_of(cfg, fc["params"])
        actor = DeviceActor(cfg, policy, seed=5, device="cpu", mesh=m2)
        actor.state.sim = S.SimState(**{k: torch.from_numpy(fc["sim"][k].copy())[actor._games] for k in S.FIELDS})
        state = pppo.init_train_state(policy, cfg.ppo)
        fused = pfused.make_fused_step(cfg, actor)
        state, _, m, stats = fused(state, actor.state, noise=_torch_tree(fc["noise"]),
                                   jitter=_torch_tree(fc["jitter"]))
        out["a"] = {"metrics": metrics_np(m), "params": params_np(policy), "lane_shards": actor.lane_shards,
                    "lanes": actor.n_lanes, "games": (actor._games.start, actor._games.stop)}

    def own_draws(cfg, mesh, iters):
        policy = policy_of(cfg, fc["params"])
        actor = DeviceActor(cfg, policy, seed=5, device="cpu", mesh=mesh)
        with torch.no_grad():
            _, chunk, _ = actor._rollout_impl(policy, copy.deepcopy(actor.state))
        gen = actor.generator.get_state()
        state = pppo.init_train_state(policy, cfg.ppo)
        fused = pfused.make_fused_step(cfg, actor)
        ms = []
        for _ in range(iters):
            state, actor.state, m, _ = fused(state, actor.state)
            ms.append(metrics_np(m))
        return {"chunk": _np_tree(chunk), "gen": gen.numpy().copy(), "params": params_np(policy), "metrics": ms,
                "lane_shards": actor.lane_shards, "drained": actor.drain_stats()}

    for name, c in (("b", cfg), ("c", fc["degenerate_cfg"]), ("mb", fc["minibatch_cfg"])):
        mesh = mesh_of(c, data_parallel=2)
        if world2:
            out[f"{name}2"] = own_draws(c, mesh, 2)
        if rank == 0:
            out[f"{name}1"] = own_draws(c, mesh_of(c, data_parallel=1), 2)

    # (d) unequal valid counts, and (e) the buffered epoch step, at world 2
    # and world 1, on the JAX side's batch
    for key in ("d", "e"):
        bc = p[key]
        cfg = bc["cfg"]
        mesh = mesh_of(cfg, data_parallel=2)
        batch = _torch_tree(bc["batch"])
        Bg = batch["rewards"].shape[0]

        def run(group, rows):
            policy = policy_of(cfg, bc["params"])
            state = pppo.init_train_state(policy, cfg.ppo)
            if key == "d":
                ms = []
                for _ in range(2):
                    state, m = pppo._train_step(cfg.ppo, state, rows, group=group)
                    ms.append(metrics_np(m))
            else:
                step = pppo.make_epoch_step(cfg, group=group)
                state, m = step(state, rows, bc["perms"])
                ms = [metrics_np(m)]
            return {"metrics": ms, "params": params_np(policy), "step": state.step}

        if world2:
            per = Bg // 2
            local = _rows(batch, rank * per, (rank + 1) * per)
            out[f"{key}2"] = run(mesh.batch_group, local)
            if key == "d":
                # a per-rank mean: this rank's loss over its own rows alone
                policy = policy_of(cfg, bc["params"])
                with torch.no_grad():
                    loss, _ = pppo.ppo_loss(policy, local, cfg.ppo, step=0)
                out["d_local_loss"] = float(loss)
        if rank == 0:
            out[f"{key}1"] = run(None, batch)

    # (f) dcn 2 x data 2 against data 4, on all four ranks
    fc4 = p["dcn"]
    cfg = fc4["cfg"]
    batch = _torch_tree(fc4["batch"])
    per = batch["rewards"].shape[0] // world
    for name, over in (("flat", {}), ("dcn", {"dcn_slices": 2})):
        mesh = mesh_of(cfg, **over)
        policy = policy_of(cfg, fc4["params"])
        state = pppo.init_train_state(policy, cfg.ppo)
        losses = []
        for _ in range(2):
            state, m = pppo._train_step(cfg.ppo, state, _rows(batch, rank * per, (rank + 1) * per),
                                        group=mesh.batch_group)
            losses.append(float(m["loss"]))
        out[f"f_{name}"] = {"losses": losses, "params": params_np(policy)}

    # (g) the learners: restores 2 -> 1 and 1 -> 2, the record, the refusals
    lc = p["learner"]
    cfg = lc["cfg"]
    m2 = mesh_of(cfg, data_parallel=2)
    m1 = mesh_of(cfg, data_parallel=1)
    d2, d1 = os.path.join(lc["dir"], "w2"), os.path.join(lc["dir"], "w1")

    def learner(mesh, **kw):
        return Learner(cfg, actor="device", seed=3, device="cpu", registry=telemetry.Registry(), mesh=mesh, **kw)

    def snapshot(lr):
        pipe = lr._pipeline_state()
        return {"pipeline": _np_tree({k: v for k, v in pipe.items() if k != "actor_rng"}),
                "params": params_np(lr.policy), "step": lr.state.step, "version": lr.state.version}

    if world2:
        lr = learner(m2, checkpoint_dir=d2, metrics_jsonl=os.path.join(lc["dir"], "w2.jsonl"))
        lr.train(lc["steps"])
        snap = snapshot(lr)
        reg = lr.registry.snapshot()
        out["g_gauges"] = {k: reg[k] for k in ("mesh/n_devices", "mesh/data_shards", "mesh/lane_shards",
                                               "fused/lanes_per_shard", "buffer/shard_bytes", "learner/psum_ms")}
        lr.close()
        out["g_w2"] = snap
        if rank == 0:
            out["g_lines"] = telemetry.load_jsonl(os.path.join(lc["dir"], "w2.jsonl"))
    dist.barrier()
    if rank == 0:
        lr = learner(m1, checkpoint_dir=d2, restore=True)
        out["g_2to1"] = snapshot(lr)
        lr.close()
        lr = learner(m1, checkpoint_dir=d1)
        lr.train(lc["steps"])
        out["g_w1"] = snapshot(lr)
        lr.close()
    dist.barrier()
    if world2:
        lr = learner(m2, checkpoint_dir=d1, restore=True)
        out["g_1to2"] = snapshot(lr)
        lr.close()
        # the calls the port once refused (ROADMAP item 7b) now build
        # learners: the host-fed modes through the ring's single door (rank
        # 0's pool), an MoE core routing over the batch group
        built = {}
        for mode in ("vec", "scalar", "external"):
            lr = Learner(cfg, actor=mode, device="cpu", registry=telemetry.Registry(), mesh=m2, transport=object())
            built[mode] = {"pool": lr.host_pool is not None, "door": lr.buffer._door}
            lr.close()
        moe = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, core="transformer", moe_experts=2))
        for name, c in (("moe", moe), ("model_parallel", dataclasses.replace(
                cfg, mesh=dataclasses.replace(cfg.mesh, model_parallel=2)))):
            lr = Learner(c, actor="device", device="cpu", registry=telemetry.Registry(), mesh=m2)
            built[name] = {"routes_over": lr.device_actor.batch_group is not None,
                           "tp": lr.state.shards is not None}
            lr.close()
        out["g_refusals"] = built

    group_before = dist.group.WORLD
    initialize_runtime()
    out["idempotent"] = dist.group.WORLD is group_before and dist.get_world_size() == world
    return out


# -- the rank side of tests/test_torch_host_fed_parallel.py ----------------------------------------


def run_ring_script(ring, script):
    """The ops of ``script`` on ``ring`` (any world): ``("add", rows,
    version)``, ``("take", version, hold)``, ``("snapshot",)``,
    ``("release",)`` and ``("requeue",)`` (of the last held ticket).
    Returns each take's batch (numpy, None when there was none), each
    add's count and each snapshot."""
    out, ticket = [], None
    for op in script:
        if op[0] == "add":
            out.append(ring.add([(dict(m), a) for m, a in op[1]], op[2]))
        elif op[0] == "take":
            got = ring.take(current_version=op[1], hold=op[2])
            if got is not None and op[2]:
                got, ticket = got
            out.append(None if got is None else _np_tree(got))
        elif op[0] == "snapshot":
            out.append(_np_tree(ring.state_dict()))
        elif op[0] == "release":
            ring.release(ticket)
            out.append(None)
        else:
            ring.requeue(ticket)
            out.append(None)
    return out


def ring_books(ring):
    return {"order": list(ring._order), "free": sorted(ring._free), "held": {k: list(v) for k, v in ring._held.items()},
            "counters": ring.metrics(), "versions": [int(v) for v in ring._slot_version]}


def host_fed_ranks(rank: int, world: int, p: dict) -> dict:
    """The single door at world 2: the ring through a script of adds and
    takes (a stale drop and an eviction between admission and take), an
    ``external`` learner fed encoded chunks through rank 0's in-process
    transport, and a ``vec`` learner; each rank's shares, books, resident
    rows and ``buffer/shard_bytes``."""
    import numpy as np
    import torch

    from dotaclient_tpu_torch.buffer import TrajectoryBuffer
    from dotaclient_tpu_torch.parallel import make_mesh
    from dotaclient_tpu_torch.protos import dota_pb2 as pb
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.transport.queues import InProcTransport
    from dotaclient_tpu_torch.utils import telemetry

    out: dict = {}
    rc = p["ring"]
    mesh = make_mesh(rc["cfg"].mesh)
    reg = telemetry.Registry()
    ring = TrajectoryBuffer(rc["cfg"], device="cpu", registry=reg, mesh=mesh, host_fed=True)
    first = run_ring_script(ring, rc["placement"])
    # after the first ingest, before any take: this rank's slots' row ids
    placed = ring._store["rewards"][:, 0].numpy().copy()
    rest = run_ring_script(ring, rc["script"])
    out["ring"] = {"ops": first + rest, "placed": placed, "books": ring_books(ring),
                   "shard_bytes": reg.snapshot()["buffer/shard_bytes"], "local_cap": ring._local_cap,
                   "rows_moved": ring.rows_moved}

    def learner_run(lc, actor):
        cfg = lc["cfg"]
        transport = None
        if actor == "external" and rank == 0:
            transport = InProcTransport(registry=telemetry.Registry())
            for blob in lc["blobs"]:
                transport.publish_rollout(pb.Rollout.FromString(blob))
        reg = telemetry.Registry()
        lr = Learner(cfg, actor=actor, seed=1, device="cpu", registry=reg, mesh=make_mesh(cfg.mesh),
                     transport=transport)
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
        res = lr.train(lc["steps"], refresh_every=1)
        snap = reg.snapshot()
        books = ring_books(lr.buffer)
        params = {k: v.numpy().copy() for k, v in lr.policy.state_dict().items()}
        lr.close()
        return {"batches": batches, "metrics": metrics, "params": params, "books": books, "adds": adds[:1],
                "shard_bytes": snap["buffer/shard_bytes"], "steps": res["optimizer_steps"],
                "pool": lr.host_pool is not None}

    out["external"] = learner_run(p["external"], "external")
    out["vec"] = learner_run(p["vec"], "vec")
    return out


# -- the rank side of tests/test_torch_model_parallel.py --------------------------------------------


def _fused_run(cfg, params, mesh, iters, model_group=None):
    """``iters`` fused iterations from ``params`` with the actor's own draws
    (seed 5): the first chunk, the metrics, the params, the state."""
    import copy

    import torch

    from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
    from dotaclient_tpu_torch.train import fused as pfused
    from dotaclient_tpu_torch.train import ppo as pppo

    policy = _policy_of(cfg, params)
    actor = DeviceActor(cfg, policy, seed=5, device="cpu", mesh=mesh)
    with torch.no_grad():
        _, chunk, _ = actor._rollout_impl(policy, copy.deepcopy(actor.state))
    state = pppo.init_train_state(policy, cfg.ppo, model_group=model_group)
    fused = pfused.make_fused_step(cfg, actor)
    ms = []
    for _ in range(iters):
        state, actor.state, m, _ = fused(state, actor.state)
        ms.append(_metrics_np(m))
    return {"chunk": _np_tree(chunk), "metrics": ms, "params": _params_np(policy), "lane_shards": actor.lane_shards}, state


def moe_data_ranks(rank: int, world: int, p: dict) -> dict:
    """The MoE core over a data group of 2: the layer's routing on each
    rank's block of the global tokens (and routed locally, the fault), the
    load-balancing term, and the MoE transformer's fused step at world 2;
    world 1 on rank 0 after."""
    import torch

    from dotaclient_tpu_torch.models.moe import MoEMLP
    from dotaclient_tpu_torch.parallel import make_mesh
    from dotaclient_tpu_torch.parallel import expert as pexpert
    from dotaclient_tpu_torch.train import ppo as pppo

    out: dict = {}
    lay = p["layer"]
    mesh = make_mesh(lay["mesh"])
    group = mesh.batch_group
    x = torch.from_numpy(lay["x"])
    per = x.shape[0] // world
    xr = x[rank * per:(rank + 1) * per]
    E, cf = lay["E"], lay["cf"]
    C = pexpert.expert_capacity(per, E, cf, group)
    gate = torch.from_numpy(lay["params"]["gate"])
    d, c, pr = pexpert.route_top1(xr, gate, E, C, group)
    layer = MoEMLP(x.shape[1], E, cf, torch.device("cpu"))
    layer.load_state_dict(_torch_tree(lay["params"]))
    with torch.no_grad():
        y, (probs, frac) = layer(xr, group)
        y_local, _ = layer(xr)
    out["layer"] = {"C": C, "dispatch": d.numpy(), "combine": c.numpy(), "probs": pr.numpy(), "y": y.numpy(),
                    "frac": frac.numpy(), "y_local": y_local.numpy()}
    ax = p["aux"]
    b = ax["valid"].shape[0] // world
    stats = tuple((torch.from_numpy(pp[:, rank * b:(rank + 1) * b].copy()),
                   torch.from_numpy(ff[:, rank * b:(rank + 1) * b].copy())) for pp, ff in ax["stats"])
    valid = torch.from_numpy(ax["valid"][rank * b:(rank + 1) * b].copy())
    local, glob = pppo._moe_aux_terms(stats, valid, group)
    out["aux"] = {"local": float(local), "global": float(glob), "alone": float(pppo._moe_aux_loss(stats, valid))}
    fc = p["fused"]
    out["fused2"], _ = _fused_run(fc["cfg"], fc["params"], make_mesh(fc["cfg"].mesh), 1)
    if rank == 0:
        out["fused1"], _ = _fused_run(fc["cfg"], fc["params"], None, 1)
    return out


def model_parallel_ranks(rank: int, world: int, p: dict) -> dict:
    """Tensor parallelism on a world of 4: the wide core at data 1 x model 2
    (ranks 0 and 1; world 1 on rank 2), the fused step at data 2 x model 2,
    the MoE transformer at data 2 x model 2, dcn 2 x model 2 against data 2
    x model 2, and checkpoints between model 2 and model 1. Every mesh is
    made by every rank in the same order."""
    import dataclasses
    import os

    import torch.distributed as dist

    from dotaclient_tpu_torch.config import MeshConfig
    from dotaclient_tpu_torch.parallel import make_mesh
    from dotaclient_tpu_torch.train import ppo as pppo
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    def layout(state):
        s = state.shards
        opt = state.optimizer
        return {name: {"master": tuple(m.shape), "whole": tuple(q.shape), "dim": d,
                       "moments": [tuple(opt.state[m][k].shape) for k in ("exp_avg", "exp_avg_sq") if m in opt.state]}
                for (name, q, d), m in zip(s.named, s.masters)}

    def steps(cfg, params, batch, group, model_group, n):
        policy = _policy_of(cfg, params)
        state = pppo.init_train_state(policy, cfg.ppo, model_group=model_group)
        ms = []
        for _ in range(n):
            state, m = pppo._train_step(cfg.ppo, state, batch, group=group)
            ms.append(_metrics_np(m))
        return {"metrics": ms, "params": _params_np(policy)}, state

    out: dict = {}
    # (a) the wide core
    wc = p["wide"]
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=2))
    batch = _torch_tree(wc["batch"])
    if rank < 2:
        out["wide2"], state = steps(wc["cfg"], wc["params"], batch, None, mesh.group("model"), 2)
        out["wide2"]["layout"] = layout(state)
    elif rank == 2:
        out["wide1"], _ = steps(wc["cfg"], wc["params"], batch, None, None, 2)
    # (b) the fused step at data 2 x model 2
    fc = p["fused"]
    mesh = make_mesh(fc["cfg"].mesh)
    out["fused_tp"], state = _fused_run(fc["cfg"], fc["params"], mesh, 2, model_group=mesh.group("model"))
    out["fused_tp"]["layout"] = layout(state)
    # (c) the MoE transformer at data 2 x model 2, one step on its rows
    mc = p["moe"]
    mesh = make_mesh(mc["cfg"].mesh)
    batch = _torch_tree(mc["batch"])
    per = batch["rewards"].shape[0] // 2
    d = mesh.coords["data"]
    out["moe_tp"], state = steps(mc["cfg"], mc["params"], _rows(batch, d * per, (d + 1) * per), mesh.batch_group,
                                 mesh.group("model"), 1)
    out["moe_tp"]["layout"] = layout(state)
    # (d) dcn 2 x model 2 against data 2 x model 2
    dc = p["dcn"]
    batch = _torch_tree(dc["batch"])
    for name, over in (("flat", {}), ("dcn", {"dcn_slices": 2})):
        cfg = dataclasses.replace(dc["cfg"], mesh=dataclasses.replace(dc["cfg"].mesh, model_parallel=2, **over))
        mesh = make_mesh(cfg.mesh)
        from dotaclient_tpu_torch.parallel.mesh import batch_index

        i = batch_index(mesh, cfg.mesh)
        per = batch["rewards"].shape[0] // 2
        out[f"dcn_{name}"], _ = steps(cfg, dc["params"], _rows(batch, i * per, (i + 1) * per), mesh.batch_group,
                                      mesh.group("model"), 2)
    # (e) checkpoints: model 2 -> model 1, and model 1 -> model 2
    lc = p["learner"]
    cfg2 = dataclasses.replace(lc["cfg"], mesh=MeshConfig(data_parallel=1, model_parallel=2))
    cfg1 = dataclasses.replace(lc["cfg"], mesh=MeshConfig(data_parallel=1, model_parallel=1))
    m2, m1 = make_mesh(cfg2.mesh), make_mesh(cfg1.mesh)
    d2, d1 = os.path.join(lc["dir"], "tp2"), os.path.join(lc["dir"], "tp1")

    def learner(cfg, mesh, **kw):
        return Learner(cfg, actor="device", seed=3, device="cpu", registry=telemetry.Registry(), mesh=mesh, **kw)

    def whole(lr):
        return {"params": _params_np(lr.policy), "opt": _np_tree(lr.state.optimizer_state_dict()["state"]),
                "step": lr.state.step}

    if rank < 2:
        lr = learner(cfg2, m2, checkpoint_dir=d2)
        lr.train(lc["steps"])
        out["ck_tp2"] = {**whole(lr), "layout": layout(lr.state)}
        lr.close()
    dist.barrier()
    if rank == 0:
        lr = learner(cfg1, m1, checkpoint_dir=d2, restore=True)
        out["ck_2to1"] = whole(lr)
        lr.close()
        lr = learner(cfg1, m1, checkpoint_dir=d1)
        lr.train(lc["steps"])
        out["ck_tp1"] = whole(lr)
        lr.close()
    dist.barrier()
    if rank < 2:
        lr = learner(cfg2, m2, checkpoint_dir=d1, restore=True)
        s = lr.state.shards
        out["ck_1to2"] = {**whole(lr), "masters": {name: m.detach().numpy().copy()
                                                   for (name, _, _), m in zip(s.named, s.masters)},
                          "moments": {name: lr.state.optimizer.state[m]["exp_avg"].numpy().copy()
                                      for (name, _, _), m in zip(s.named, s.masters) if m in lr.state.optimizer.state},
                          "me": s.me}
        lr.close()
    # world-1 references of (b) and (c), after the world's collectives
    if rank == 0:
        out["fused1"], _ = _fused_run(fc["cfg"], fc["params"], None, 2)
        out["moe1"], _ = steps(mc["cfg"], mc["params"], _torch_tree(mc["batch"]), None, None, 1)
    return out

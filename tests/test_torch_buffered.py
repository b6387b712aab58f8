"""The buffered learner (``actor="device"``) against the JAX package's.

Held against the reference on numpy inputs from a seed, on the CPU:

* the trajectory ring: one sequence of ``add_device``, ``take``, held
  takes, ``requeue``, ``release``, staleness drops, ``drop_newer_than`` and
  a ``state_dict`` round trip through both rings (the JAX one on a
  1-device CPU mesh): slot order, free list, slot versions and counters
  equal, gathered rows bitwise;
* the one-pass advantage pass: f32 within ``test_torch_train``'s bounds,
  its bf16 staging within one bf16 rounding step;
* the epoch step at E x M = 1x1, 2x1 and 2x2 (the last two on precomputed
  advantages) with the same host permutations: metrics and params as in
  ``test_two_train_steps_match_jax``;
* the slice: both learners in device mode, handed the same chunks through
  ``buffer.add_device``, each draining two batches through ``_next_batch``
  -> ``_attach_advantages`` -> ``_optimize`` (the collect is bypassed:
  threefry noise cannot be matched, and the rollout tests hold it apart).

And the port alone: the staged loop equals the epoch step bitwise, a short
device-mode run closes its books, a NaN rollback reaches its target step,
``request_stop`` and a restore resume the pipeline bitwise, the snapshot
engine's clone, monotonic and gate rules, and the CLI's default actor and
override flags.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.buffer import TrajectoryBuffer as JaxTrajectoryBuffer
from dotaclient_tpu.parallel import make_mesh
from dotaclient_tpu.train import advantage as jadv
from dotaclient_tpu.train.learner import Learner as JaxLearner
from dotaclient_tpu_torch.actor.device_rollout import flatten_state, tree_map
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.train import advantage as padv
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.train import ppo as pppo
from dotaclient_tpu_torch.train import snapshot as psnap
from dotaclient_tpu_torch.train.health import HealthMonitor
from dotaclient_tpu_torch.transport.queues import InProcTransport
from dotaclient_tpu_torch.transport.serialize import decode_weights
from dotaclient_tpu_torch.utils import faults, telemetry
from tests.test_torch_common import flax_params, jax_policy, port_policy, random_obs, small_configs
from tests.test_torch_train import ATOL, MAX_EXCLUDED, NOISE_FLOOR, RTOL, jppo, make_batch

# the bf16 staging of an advantage: the two packages' f32 values differ by
# ~1e-6, so their bf16 roundings agree within one rounding step (2^-8 of
# the value) and are mostly bitwise equal
BF16_RTOL = 2.0 ** -8


def buffered_configs(T=3, batch=4, capacity=8, min_fill=4, epochs=1, minibatches=1, **ppo):
    """The small config in both packages for the buffered path: a 1-device
    mesh, a small ring, f32 compute."""
    out = []
    for cfg in small_configs():
        out.append(dataclasses.replace(
            cfg,
            ppo=dataclasses.replace(cfg.ppo, rollout_len=T, batch_rollouts=batch, epochs_per_batch=epochs,
                                    minibatches=minibatches, **ppo),
            buffer=dataclasses.replace(cfg.buffer, capacity_rollouts=capacity, min_fill=min_fill),
            env=dataclasses.replace(cfg.env, n_envs=2, max_dota_time=0.4),
            mesh=dataclasses.replace(cfg.mesh, data_parallel=1),
            log_every=10 ** 9,
        ))
    return tuple(out)


def chunk(cfg, L, seed):
    """A rollout chunk batch [L, T(+1), ...] as numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    T, H = cfg.ppo.rollout_len, cfg.model.hidden_dim
    return {
        "obs": random_obs(cfg, (L, T + 1), seed=seed),
        "actions": {h: rng.integers(0, n, size=(L, T)).astype(np.int32) for h, n in cfg.actions.head_sizes.items()},
        "behavior_logp": (rng.normal(size=(L, T)) * 0.3 - 1.0).astype(np.float32),
        "rewards": rng.normal(size=(L, T)).astype(np.float32),
        "dones": (rng.random((L, T)) < 0.2).astype(np.float32),
        "valid": np.ones((L, T), np.float32),
        "carry0": tuple((rng.normal(size=(L, H)) * 0.5).astype(np.float32) for _ in range(2)),
    }


def to_port(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_jax(tree):
    return tree_map(jnp.asarray, tree)


def assert_rows_equal(got, want, path=""):
    """A port tree bitwise equal to a JAX tree, key by key."""
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            assert_rows_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_rows_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(w := want), err_msg=path)
        assert got.numpy().dtype == np.asarray(w).dtype, path


def books(buf):
    """A ring's bookkeeping, host ints."""
    return (list(buf._order), list(buf._free), [int(v) for v in buf._slot_version],
            {k: sorted(v) for k, v in buf._held.items()}, buf.dropped_stale, buf.dropped_overflow, buf.ingested,
            buf._warmed, buf.size)


# -- the ring ---------------------------------------------------------------


def test_ring_matches_jax():
    jcfg, pcfg = buffered_configs()
    jbuf = JaxTrajectoryBuffer(jcfg, make_mesh(jcfg.mesh), registry=telemetry_registry())
    pbuf = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())

    def both(fn):
        return fn(jbuf, to_jax), fn(pbuf, to_port)

    def check(j, p, bufs=None):
        jb, pb = bufs or (jbuf, pbuf)
        assert books(pb) == books(jb)
        if j is None or isinstance(j, int):
            assert p == j
        elif isinstance(j, tuple):
            assert p[1] == j[1]
            assert_rows_equal(p[0], j[0])
        else:
            assert_rows_equal(p, j)

    check(*both(lambda b, cv: b.add_device(cv(chunk(pcfg, 6, 1)), 0)))
    check(*both(lambda b, cv: b.take(current_version=0)))
    check(*both(lambda b, cv: b.add_device(cv(chunk(pcfg, 6, 2)), 2)))
    held = both(lambda b, cv: b.take(current_version=2, hold=True))
    check(*held)
    check(*both(lambda b, cv: b.requeue(held[0][1])))
    again = both(lambda b, cv: b.take(current_version=2, hold=True))
    check(*again)
    assert_rows_equal(again[1][0], held[0][0])   # the requeued rows come back first
    check(*both(lambda b, cv: b.release(again[0][1])))
    check(*both(lambda b, cv: b.add_device(cv(chunk(pcfg, 3, 3)), 5)))
    check(*both(lambda b, cv: b.take(current_version=9)))                  # versions 0 and 2 go stale
    assert pbuf.dropped_stale > 0
    check(*both(lambda b, cv: b.add_device(cv(chunk(pcfg, 10, 4)), 7)))   # more rows than the ring holds
    check(*both(lambda b, cv: b.drop_newer_than(6)))
    check(*both(lambda b, cv: b.add_device(cv(chunk(pcfg, 4, 5)), 8)))
    check(*both(lambda b, cv: b.take(current_version=8, hold=True)))
    jstate, pstate = jbuf.state_dict(), pbuf.state_dict()   # folds the held batch back
    assert books(pbuf) == books(jbuf)
    for key in ("order", "free", "slot_version", "counters"):
        np.testing.assert_array_equal(pstate[key].numpy(), np.asarray(jstate[key]), err_msg=key)
    assert_rows_equal(pstate["store"], jstate["store"])
    jbuf2 = JaxTrajectoryBuffer(jcfg, make_mesh(jcfg.mesh), registry=telemetry_registry())
    pbuf2 = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())
    jbuf2.load_state_dict(jstate)
    pbuf2.load_state_dict(pstate)
    assert books(pbuf2) == books(jbuf2) == books(jbuf)
    check(jbuf2.take(current_version=8), pbuf2.take(current_version=8), (jbuf2, pbuf2))
    assert pbuf.metrics() == jbuf.metrics()


def telemetry_registry():
    from dotaclient_tpu.utils import telemetry as jtel

    return jtel.Registry()


def test_ring_host_rows_and_narrow_store_are_not_ported():
    _, pcfg = buffered_configs()
    buf = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())
    with pytest.raises(NotImplementedError, match="4b"):
        buf.add([], 0)
    narrow = dataclasses.replace(pcfg, transport=dataclasses.replace(pcfg.transport, rollout_wire_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="4b"):
        TrajectoryBuffer(narrow, device="cpu")


# -- the advantage pass ---------------------------------------------------------


@pytest.mark.parametrize("seed", [2, 4])
def test_advantage_pass_matches_jax(seed):
    jcfg, pcfg = buffered_configs(T=5, epochs=2)
    params = flax_params(jcfg, seed=1)
    batch = make_batch(pcfg, params, seed=seed)
    jpolicy = jax_policy(jcfg)[0]
    jparams = jax.tree.map(jnp.asarray, params)
    want = jadv.advantages_and_returns(jpolicy, jparams, to_jax(batch), jcfg.ppo)
    policy = port_policy(pcfg, params)
    got = padv.advantages_and_returns(policy, to_port(batch), pcfg.ppo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    # the staged bf16 leaves, as the learner attaches them
    jstaged = jadv.make_advantage_pass(jpolicy, jcfg, make_mesh(jcfg.mesh))(jparams, to_jax(batch))
    pstaged = padv.make_advantage_pass(policy, pcfg)(to_port(batch))
    for g, w, f32 in zip(pstaged, jstaged, got):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert torch.equal(g, f32.to(torch.bfloat16))
        w32 = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w32, rtol=BF16_RTOL, atol=ATOL)
    for over in ({}, {"epochs_per_batch": 1}, {"advantage": "vtrace"}, {"one_pass_advantage": False},
                 {"advantage_dtype": "float32"}):
        j, p = (dataclasses.replace(c, ppo=dataclasses.replace(c.ppo, **over)) for c in (jcfg, pcfg))
        assert padv.one_pass_enabled(p) == jadv.one_pass_enabled(j), over
        assert str(padv.store_dtype(p)).replace("torch.", "") == np.dtype(jadv.store_dtype(j)).name, over


# -- the epoch step -------------------------------------------------------------


def capture_grads(state):
    """Record the gradients the optimizer sees at every update of ``state``."""
    seen = []
    opt = state.optimizer
    step = opt.step

    def recording(*a, **k):
        seen.append({id(p): p.grad.detach().clone() for g in opt.param_groups for p in g["params"]})
        return step(*a, **k)

    opt.step = recording
    return seen


def noisy_mask(policy, seen):
    """Per param, the elements whose gradient was nonzero but below
    NOISE_FLOOR of its leaf's largest in some update: a direction set by
    rounding (``test_torch_train``'s rule)."""
    out = {}
    for name, p in policy.named_parameters():
        mask = torch.zeros_like(p, dtype=torch.bool)
        for grads in seen:
            g = grads[id(p)]
            mask |= (g != 0) & (g.abs() < NOISE_FLOOR * g.abs().max())
        out[name] = mask
    return out


def assert_params_close(policy, jparams, noisy, what):
    got = policy.state_dict()
    for name, w in convert(jax.tree.map(np.asarray, jparams)).items():
        keep = ~noisy[name]
        np.testing.assert_allclose(got[name][keep].numpy(), w[keep].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: param {name}")
    excluded = sum(int(m.sum()) for m in noisy.values())
    assert excluded <= MAX_EXCLUDED * sum(m.numel() for m in noisy.values()), (what, excluded)


@pytest.mark.parametrize("epochs,minibatches,precomputed", [(1, 1, False), (2, 1, True), (2, 2, True)])
def test_epoch_step_matches_jax(epochs, minibatches, precomputed):
    seed = 2
    jcfg, pcfg = buffered_configs(T=5, epochs=epochs, minibatches=minibatches)
    params = flax_params(jcfg, seed=1)
    batch = make_batch(pcfg, params, seed=seed)
    jpolicy = jax_policy(jcfg)[0]
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch, pbatch = to_jax(batch), to_port(batch)
    if precomputed:
        adv, ret = jadv.make_advantage_pass(jpolicy, jcfg, make_mesh(jcfg.mesh))(jparams, jbatch)
        jbatch = {**jbatch, "advantages": adv, "returns": ret}
        pbatch = {**pbatch, **{k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
                               for k, v in (("advantages", adv), ("returns", ret))}}
    B = pcfg.ppo.batch_rollouts
    rng = np.random.default_rng(pcfg.seed + 1)
    perms = np.stack([rng.permutation(B) for _ in range(epochs)])
    jstate, jm = jppo.make_epoch_step(jpolicy, jcfg, make_mesh(jcfg.mesh))(
        jppo.init_train_state(jparams, jcfg.ppo), jbatch, perms.astype(np.int32))
    pstate = pppo.init_train_state(port_policy(pcfg, params), pcfg.ppo)
    seen = capture_grads(pstate)
    pstate, pm = pppo.make_epoch_step(pcfg)(pstate, pbatch, perms)
    assert len(seen) == epochs * minibatches and pstate.step == int(jstate.step) == epochs * minibatches
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=f"metric {k}")
    assert_params_close(pstate.policy, jstate.params, noisy_mask(pstate.policy, seen),
                        f"E={epochs} M={minibatches}")


def port_learner(pcfg, seed=1, **kw):
    return plearner.Learner(pcfg, actor="device", seed=seed, device="cpu", registry=telemetry.Registry(), **kw)


def test_staged_loop_equals_the_epoch_step():
    """The learner's epoch step runs the reference's staged loop: per
    epoch one permutation from ``default_rng(seed + 1)``, then one
    ``train_step`` per minibatch of its rows; bitwise the same params.
    ``fused_epoch=False`` builds the same learner."""
    _, pcfg = buffered_configs(T=3, epochs=2, minibatches=2)
    staged_cfg = dataclasses.replace(pcfg, ppo=dataclasses.replace(pcfg.ppo, fused_epoch=False))
    learner, twin = port_learner(pcfg), port_learner(staged_cfg)
    assert learner.epoch_step is not None and twin.epoch_step is not None
    batch = to_port(chunk(pcfg, 4, 7))
    for _ in range(2):
        m = learner._optimize(learner._attach_advantages(batch))
    assert learner._mb_draws == 4 and learner.state.step == 8
    # the staged loop by hand on the twin, from the same stream
    B, mb = pcfg.ppo.batch_rollouts, pcfg.ppo.batch_rollouts // 2
    rng = np.random.default_rng(pcfg.seed + 1)
    for _ in range(2):
        staged = twin._attach_advantages(batch)
        for _ in range(2):
            idx = torch.from_numpy(rng.permutation(B))
            for i in range(2):
                twin.state, _ = twin.train_step(twin.state, pppo.take_rows(staged, idx[i * mb:(i + 1) * mb]))
    assert twin.state.step == 8
    for (name, a), b in zip(learner.policy.state_dict().items(), twin.policy.state_dict().values()):
        assert torch.equal(a, b), name
    assert float(m["health_ok"]) == 1.0


# -- the slice -------------------------------------------------------------------------


def test_learners_agree_on_injected_chunks():
    jcfg, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4, epochs=2, minibatches=2)
    jl = JaxLearner(jcfg, actor="device", seed=1)
    pl = port_learner(pcfg)
    pl.policy.load_state_dict(convert(jax.tree.map(np.asarray, jl.state.params)))
    assert jl.advantage_pass is not None and pl.advantage_pass is not None and pl.epoch_step is not None
    rows = chunk(pcfg, 8, 11)
    assert jl.buffer.add_device(to_jax(rows), 0) == pl.buffer.add_device(to_port(rows), 0) == 8
    seen = capture_grads(pl.state)
    for i in range(2):
        jb, pb = jl._next_batch(drain_transport=False), pl._next_batch()
        assert "advantages" in jb and "advantages" in pb
        jm, pm = jl._optimize(jb), pl._optimize(pb)
        if i == 0:
            jl._prefetch_next(drain_transport=False)
            pl._prefetch_next()
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=f"batch {i}: {k}")
    assert pl.state.step == jl._host_step == 8 and pl._mb_draws == jl._mb_draws == 4
    assert books(pl.buffer) == books(jl.buffer)
    assert_params_close(pl.policy, jl.state.params, noisy_mask(pl.policy, seen), "two batches")
    jl._snap_engine.stop()
    pl.close()


# -- the port's learner --------------------------------------------------------------


def run_config(**ppo):
    """A device-mode run on the CPU at the small model: 2 games of 0.4 s,
    so 2 chunks a collect, into batches of 4; a log line every 4 steps."""
    _, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4, **ppo)
    return dataclasses.replace(pcfg, log_every=4)


def test_device_run_closes_its_books():
    cfg = run_config(epochs=2, minibatches=2)
    learner = port_learner(cfg)
    n_batches, collects = [0], [0]
    optimize, collect = learner._optimize, learner.device_actor.collect
    learner._optimize = lambda b: (n_batches.__setitem__(0, n_batches[0] + 1), optimize(b))[1]
    learner.device_actor.collect = lambda *a: (collects.__setitem__(0, collects[0] + 1), collect(*a))[1]
    out = learner.train(12)
    buf, L = learner.buffer, learner.device_actor.n_lanes
    assert out["optimizer_steps"] == 12.0 and learner.state.step == 12 and n_batches[0] == 3
    assert out["frames_trained"] == 3 * 4 * 3
    assert buf.ingested == collects[0] * L == n_batches[0] * 4 + buf.size + buf.dropped_stale + buf.dropped_overflow
    snap = learner.registry.snapshot()
    assert snap["advantage/passes_total"] == n_batches[0] and snap["advantage/one_pass"] == 1.0
    assert np.isfinite(out["loss"]) and out["health_ok"] == 1.0 and learner.history
    assert learner.transport.latest_weights().version == learner.state.version   # the final publish


@pytest.fixture
def fault_spec():
    yield faults.configure
    faults.configure(None)


def test_nan_batch_rolls_back_to_last_good_and_reaches_the_target(tmp_path, fault_spec, capsys):
    """The 4th batch is poisoned after the last_good save at step 2: the
    verdict latches, the step-4 checkpoint is refused, the rollback puts
    the step-2 save back bitwise and drops the newer chunks of the ring,
    and the run still ends at its target step, healthy. 6 games a collect
    against batches of 4 leave chunks in the ring at every boundary."""
    fault_spec("learner.nan_grad@4")
    cfg = run_config()
    cfg = dataclasses.replace(cfg, checkpoint_every=2, log_every=2, env=dataclasses.replace(cfg.env, n_envs=6))
    learner = port_learner(cfg, checkpoint_dir=str(tmp_path))
    restored = []
    restore_last_good = learner.ckpt.restore_last_good

    def recording(*a, **k):
        want, step = learner.ckpt._last_good_slot().restore_weights()
        out = restore_last_good(*a, **k)
        restored.append(step)
        for name, v in learner.policy.state_dict().items():
            assert torch.equal(v, want[name]), name
        return out

    learner.ckpt.restore_last_good = recording
    out = learner.train(8)
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("HEALTH_ROLLBACK "))
    event = json.loads(line[len("HEALTH_ROLLBACK "):])
    assert restored == [2] and event["reason"] == "nonfinite" and event["to_step"] == 2
    assert event["resumed_version"] == event["from_step"] + 1 and event["detected_step"] == 4
    snap = learner.registry.snapshot()
    assert snap["health/rollbacks_total"] == 1.0 and snap["health/nonfinite_steps_total"] == 1.0
    assert snap["health/checkpoints_blocked_total"] >= 1.0
    assert snap["buffer/poison_dropped_total"] > 0.0
    assert learner.state.step == 8 and out["optimizer_steps"] == 8.0
    assert np.isfinite(out["loss"]) and out["health_ok"] == 1.0 and learner._health.unhealthy is None
    assert learner.ckpt.all_steps()[-1] == 8 and learner.ckpt.last_good_step() == 8
    learner.close()


def test_stop_then_restore_resumes_the_pipeline(tmp_path):
    cfg = run_config(epochs=2, minibatches=2)
    a = port_learner(cfg, checkpoint_dir=str(tmp_path))
    after_step = a._after_step

    def stop_at_8(m, frames, stride):
        rewound = after_step(m, frames, stride)
        if a.state.step >= 8:
            a.request_stop()
        return rewound

    a._after_step = stop_at_8
    out = a.train(40)
    assert out["optimizer_steps"] == 8.0 and a.state.step == 8
    saved = {"buffer": a.buffer.state_dict(), "actor": [t.clone() for t in flatten_state(a.device_actor.state)],
             "rng": a.device_actor.generator.get_state(), "mb_draws": a._mb_draws}
    b = port_learner(cfg, seed=5, checkpoint_dir=str(tmp_path), restore=True)
    assert b.state.step == 8 and b._mb_draws == saved["mb_draws"] == 4
    got = b.buffer.state_dict()
    for key in ("order", "free", "slot_version", "counters"):
        assert torch.equal(got[key], saved["buffer"][key]), key
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), got["store"], saved["buffer"]["store"])
    for x, y in zip(flatten_state(b.device_actor.state), saved["actor"]):
        assert torch.equal(x, y)
    assert torch.equal(b.device_actor.generator.get_state(), saved["rng"])
    for (name, x), y in zip(b.policy.state_dict().items(), a.policy.state_dict().values()):
        assert torch.equal(x, y), name
    # the next permutation is the one an uninterrupted run draws
    c = port_learner(cfg)
    c.train(8)
    B = cfg.ppo.batch_rollouts
    assert c._mb_draws == 4
    np.testing.assert_array_equal(b._mb_rng.permutation(B), c._mb_rng.permutation(B))
    for learner in (a, b, c):
        learner.close()


# -- the snapshot engine ---------------------------------------------------------------


def test_snapshot_clone_is_taken_before_the_update():
    _, pcfg = buffered_configs(T=3)
    learner = port_learner(pcfg)
    before = {k: v.clone() for k, v in learner.policy.state_dict().items()}
    copy = psnap.device_copy(learner.policy.state_dict())
    learner._optimize(to_port(chunk(pcfg, 4, 3)))
    assert any(not torch.equal(v, before[k]) for k, v in learner.policy.state_dict().items())
    for k, v in copy.tree.items():
        assert torch.equal(v, before[k]), k
    learner.close()


def test_snapshot_publishes_are_monotonic_and_gated():
    _, pcfg = buffered_configs()
    transport = InProcTransport(registry=telemetry.Registry())
    health = HealthMonitor(pcfg.health, registry=telemetry.Registry())
    reg = telemetry.Registry()
    engine = psnap.SnapshotEngine(transport=transport, registry=reg, health=health)
    params = {"w": torch.arange(3, dtype=torch.float32)}
    engine.submit_publish(psnap.device_copy(params), 5)
    engine.drain()
    engine.submit_publish(psnap.device_copy(params), 3)    # an older version: never published
    engine.drain()
    assert transport.latest_weights().version == 5 == engine.last_published
    version, tree = decode_weights(transport.latest_weights())
    np.testing.assert_array_equal(np.asarray(tree["w"]), params["w"].numpy())
    health.fold_host(6, 6, {"loss": float("nan"), "grad_norm": 1.0, "health_ok": 0.0})
    engine.submit_publish(psnap.device_copy(params), 7)
    engine.drain()
    assert transport.latest_weights().version == 5 and reg.snapshot()["health/publish_blocked_total"] == 1.0
    engine.stop()


def test_blocked_final_publish_never_reaches_the_transport(fault_spec):
    """No checkpoint directory: the divergence cannot roll back, so the
    gate stays closed through the end of ``train``."""
    fault_spec("learner.nan_grad@1")
    cfg = run_config()
    learner = port_learner(cfg)
    learner.train(2)
    assert learner._health.unhealthy is not None
    assert learner.transport.latest_weights() is None
    assert learner.registry.snapshot()["health/publish_blocked_total"] >= 1.0
    learner.close()


# -- the CLI ------------------------------------------------------------------------------


def test_cli_default_actor_and_override_flags(monkeypatch, capsys):
    built = []
    real = plearner.Learner

    def recording(config, actor, **kw):
        built.append((config, actor))
        return real(config, actor, **kw)

    monkeypatch.setattr(plearner, "Learner", recording)
    assert plearner.main(["--smoke", "--steps", "1", "--device", "cpu", "--buffer", "capacity_rollouts=16",
                          "--health", "explosion_band=50,max_rollbacks=2", "--learner", "overlap_advantage=false",
                          "--sync-snapshots"]) == 0
    config, actor = built[-1]
    assert actor == "device"
    assert config.buffer.capacity_rollouts == 16 and config.health.explosion_band == 50.0
    assert config.health.max_rollbacks == 2
    assert config.learner.overlap_advantage is False and config.learner.async_snapshots is False
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: 1 steps, ")
    for bad in (["--buffer", "nope=1"], ["--health", "enabled=maybe"], ["--learner", "x=1"]):
        with pytest.raises(SystemExit) as e:
            plearner.main(["--smoke", "--device", "cpu", *bad])
        assert e.value.code == 2
    if not torch.cuda.is_available():
        # no device named and no card: the default (buffered) learner raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plearner.main(["--smoke", "--steps", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            real(buffered_configs()[1])

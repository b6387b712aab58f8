"""The port's serving engine, on the CPU, held against the JAX engine.

The port's dispatch draws other random numbers than the JAX engine's, so the
two are compared given the same actions: the port's logits and the log-prob
it assigns to the JAX engine's sampled actions must match the JAX dispatch
at f32 (atol 1e-5), step after step through the carry store. The rest pins
the engine's own contracts: release zeroes a slot, weights swap between
dispatches, ``reference_step`` replays a live stream bit for bit, and no
entry point runs on the CPU unless asked.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.serve import ServeEngine as JaxServeEngine
from dotaclient_tpu.serve import make_inference_policy as jax_inference_policy
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models import distributions as PD
from dotaclient_tpu_torch.models.policy import Policy, mask_carry
from dotaclient_tpu_torch.serve import ServeEngine, make_inference_policy, slice_train_params
from dotaclient_tpu_torch.utils import telemetry
from tests.test_torch_common import (
    flax_params,
    jax_policy,
    np32,
    obs_row,
    random_obs,
    small_configs,
    to_jax,
    to_torch,
)


class ReplyCollector:
    """Thread-safe sink for engine replies, kept in arrival order (which is
    row order within a dispatch)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.replies = []

    def __call__(self, actions, logp, version, request_id, dispatch_idx, carry=None):
        with self.cond:
            self.replies.append(dict(
                actions=np.asarray(actions).copy(), logp=logp, version=version,
                request_id=request_id, dispatch_idx=dispatch_idx,
            ))
            self.cond.notify_all()

    def wait(self, n, timeout=30.0):
        with self.cond:
            ok = self.cond.wait_for(lambda: len(self.replies) >= n, timeout=timeout)
        assert ok, f"only {len(self.replies)}/{n} replies arrived"
        return sorted(self.replies, key=lambda r: r["request_id"])


def port_engine(pcfg, params, registry=None):
    return ServeEngine(
        pcfg, make_inference_policy(pcfg, device="cpu"), params,
        registry=registry, device="cpu",
    )


def slim_params(jcfg, seed=0):
    return flax_params(jcfg, seed=seed, value_head=False)


def wait_until(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.005)
    return pred()


def test_engine_matches_jax_dispatch_given_the_same_actions():
    jcfg, pcfg = small_configs(max_batch=4, batch_window_ms=0.0)
    jparams = slim_params(jcfg, seed=1)
    pparams = convert(jparams)
    rounds, slots = 3, [0, 2, 5]
    obs = random_obs(pcfg, (rounds, len(slots)), seed=2)
    resets = [1.0, 0.0, 0.0]

    jengine = JaxServeEngine(jcfg, jax_inference_policy(jcfg), jparams)
    jstep = jax_policy(jcfg, value_head=False)[1]
    policy = Policy(pcfg.model, pcfg.obs, pcfg.actions, value_head=False, device="cpu")
    policy.load_state_dict(pparams)
    engine = port_engine(pcfg, pparams)
    sink = ReplyCollector()
    try:
        jcarries = jax.tree.map(jnp.asarray, jengine._policy.initial_state(jcfg.serve.max_slots + 1))
        jcarry = jax.tree.map(jnp.asarray, jengine._policy.initial_state(len(slots)))
        pcarry = policy.initial_state(len(slots))
        for r in range(rounds):
            rows = [obs_row({k: v[r] for k, v in obs.items()}, i) for i in range(len(slots))]
            for i, slot in enumerate(slots):
                engine.submit(slot, rows[i], reset=bool(resets[r]), reply=sink, request_id=r * 10 + i)
            replies = sink.wait((r + 1) * len(slots))[-len(slots):]
            j_packed, j_logp, jcarries = jengine.reference_step(
                rows, slots, [resets[r]] * len(slots), jcarries, r
            )
            ob = {k: v[r] for k, v in obs.items()}
            keep = 1.0 - resets[r]
            jlogits, _, jcarry = jstep(
                jparams, to_jax(ob), jax.tree.map(lambda c: c * keep, jcarry)
            )
            with torch.no_grad():
                plogits, _, pcarry = policy.step(
                    to_torch(ob), mask_carry(pcarry, torch.full((len(slots),), keep))
                )
            for head in jlogits:
                np.testing.assert_allclose(np32(plogits[head]), np.asarray(jlogits[head]), atol=1e-5)
            n = len(slots)
            j_actions = {h: torch.from_numpy(j_packed[:n, k].astype(np.int64)) for k, h in enumerate(PD.HEADS)}
            np.testing.assert_allclose(
                np32(PD.log_prob(plogits, to_torch(ob), j_actions)), j_logp[:n], rtol=0, atol=1e-5
            )
            # the port engine's own replies: its log-prob of its own actions
            p_actions = {
                h: torch.tensor([rep["actions"][k] for rep in replies]) for k, h in enumerate(PD.HEADS)
            }
            np.testing.assert_allclose(
                [rep["logp"] for rep in replies],
                np32(PD.log_prob(plogits, to_torch(ob), p_actions)), rtol=0, atol=1e-5,
            )
    finally:
        engine.stop()
        jengine.stop()


def test_reference_step_replays_the_live_stream_bitwise():
    jcfg, pcfg = small_configs(max_batch=4, batch_window_ms=5.0)
    engine = port_engine(pcfg, convert(slim_params(jcfg, seed=3)))
    sink = ReplyCollector()
    slots, rounds = [1, 3, 4, 6, 7], 4
    obs = random_obs(pcfg, (rounds, len(slots)), seed=4)
    sent = {}
    try:
        for r in range(rounds):
            for i, slot in enumerate(slots):
                rid = r * 100 + i
                sent[rid] = (obs_row({k: v[r] for k, v in obs.items()}, i), slot, 1.0 if r == 0 else 0.0)
                engine.submit(slot, sent[rid][0], reset=r == 0, reply=sink, request_id=rid)
            sink.wait((r + 1) * len(slots))
        by_dispatch = {}
        for rep in sink.replies:  # arrival order == row order
            by_dispatch.setdefault(rep["dispatch_idx"], []).append(rep)
        assert len(by_dispatch) >= rounds * 2  # 5 games, 4 rows a window
        carries = engine.initial_carries()
        for idx in sorted(by_dispatch):
            reps = by_dispatch[idx]
            rows = [sent[rep["request_id"]] for rep in reps]
            packed, logp, carries = engine.reference_step(
                [o for o, _, _ in rows], [s for _, s, _ in rows], [z for _, _, z in rows], carries, idx
            )
            for i, rep in enumerate(reps):
                np.testing.assert_array_equal(packed[i], rep["actions"])
                assert float(logp[i]) == rep["logp"]
    finally:
        engine.stop()


def test_release_slot_zeroes_the_carry_row():
    jcfg, pcfg = small_configs(max_batch=1, batch_window_ms=0.0)
    engine = port_engine(pcfg, convert(slim_params(jcfg, seed=5)))
    sink = ReplyCollector()
    obs = random_obs(pcfg, (3,), seed=6)
    try:
        engine.submit(0, obs_row(obs, 0), reset=True, reply=sink, request_id=1)
        engine.submit(0, obs_row(obs, 1), reset=False, reply=sink, request_id=2)
        sink.wait(2)
        engine.release_slot(0)
        # NO reset flag: only the release-time zeroing can make this fresh
        engine.submit(0, obs_row(obs, 2), reset=False, reply=sink, request_id=3)
        served = sink.wait(3)[2]
        fresh = engine.reference_step(
            [obs_row(obs, 2)], [0], [0.0], engine.initial_carries(), served["dispatch_idx"]
        )
        np.testing.assert_array_equal(fresh[0][0], served["actions"])
        assert float(fresh[1][0]) == served["logp"]
        # teeth: the same request from the un-released carry differs
        carries = engine.initial_carries()
        for idx, (i, z) in enumerate([(0, 1.0), (1, 0.0)]):
            _, _, carries = engine.reference_step([obs_row(obs, i)], [0], [z], carries, idx)
        stale = engine.reference_step([obs_row(obs, 2)], [0], [0.0], carries, served["dispatch_idx"])
        assert float(stale[1][0]) != served["logp"]
    finally:
        engine.stop()


def replay_window(engine, replies, rows, slots, resets, carries):
    """The one dispatch that served ``replies`` (in row order), replayed on
    ``carries``: its packed actions and log-probs must be the served ones."""
    assert len({r["dispatch_idx"] for r in replies}) == 1, "the requests did not share a window"
    packed, logp, _ = engine.reference_step(rows, slots, resets, carries, replies[0]["dispatch_idx"])
    for i, r in enumerate(replies):
        np.testing.assert_array_equal(packed[i], r["actions"])
        assert float(logp[i]) == r["logp"]


def test_shadow_row_joining_an_open_window_is_installed_before_it_dispatches():
    """A re-homed game's request with its carry row arrives while another
    game's window is open: the row is installed before that window
    dispatches, not after."""
    jcfg, pcfg = small_configs(max_batch=4, batch_window_ms=400.0, carry_shadow=True)
    engine = port_engine(pcfg, convert(slim_params(jcfg, seed=13)))
    sink = ReplyCollector()
    obs = random_obs(pcfg, (2,), seed=14)
    rng = np.random.default_rng(15)
    H = pcfg.model.hidden_dim
    wire = {"c0": rng.normal(size=H).astype(np.float32), "c1": rng.normal(size=H).astype(np.float32)}
    try:
        engine.submit(0, obs_row(obs, 0), reset=True, reply=sink, request_id=1)
        time.sleep(0.1)  # the window is open
        engine.submit(1, obs_row(obs, 1), reset=False, reply=sink, request_id=2, carry=wire)
        replies = sink.wait(2)
        carries = engine.initial_carries()
        for store, key in zip(carries, ("c0", "c1")):
            store[1] = torch.from_numpy(wire[key]).to(store.dtype)
        replay_window(engine, replies, [obs_row(obs, 0), obs_row(obs, 1)], [0, 1], [1.0, 0.0], carries)
    finally:
        engine.stop()


def test_release_and_reattach_inside_an_open_window_serve_a_fresh_carry():
    """A slot released while another game's window is open, and attached
    again by a game that sends no reset into that window: the release's
    zeroing lands before the window dispatches, so the new game starts from
    zeros and keeps the carry its first step wrote."""
    jcfg, pcfg = small_configs(max_batch=4, batch_window_ms=400.0)
    engine = port_engine(pcfg, convert(slim_params(jcfg, seed=16)))
    sink = ReplyCollector()
    obs = random_obs(pcfg, (4,), seed=17)
    try:
        engine.submit(0, obs_row(obs, 0), reset=True, reply=sink, request_id=1)  # the old game
        sink.wait(1)
        engine.submit(1, obs_row(obs, 1), reset=True, reply=sink, request_id=2)
        time.sleep(0.1)  # the window is open
        engine.release_slot(0)
        engine.submit(0, obs_row(obs, 2), reset=False, reply=sink, request_id=3)  # the new game
        replies = sink.wait(3)[1:]
        replay_window(engine, replies, [obs_row(obs, 1), obs_row(obs, 2)], [1, 0], [1.0, 0.0],
                      engine.initial_carries())
        # its next step goes on from the carry its first step wrote
        engine.submit(0, obs_row(obs, 3), reset=False, reply=sink, request_id=4)
        last = sink.wait(4)[3]
        carries = engine.initial_carries()
        engine.reference_step([obs_row(obs, 1), obs_row(obs, 2)], [1, 0], [1.0, 0.0], carries,
                              replies[0]["dispatch_idx"])
        replay_window(engine, [last], [obs_row(obs, 3)], [0], [0.0], carries)
    finally:
        engine.stop()


def test_weight_swap_lands_between_dispatches():
    jcfg, pcfg = small_configs(max_batch=2, batch_window_ms=0.0)
    p1, p2 = convert(slim_params(jcfg, seed=7)), convert(slim_params(jcfg, seed=8))
    reg = telemetry.Registry()
    engine = port_engine(pcfg, p1, registry=reg)
    sink = ReplyCollector()
    obs = obs_row(random_obs(pcfg, (1,), seed=9), 0)
    try:
        engine.submit(0, obs, reset=True, reply=sink, request_id=1)
        assert sink.wait(1)[0]["version"] == 0
        engine.submit_weights(5, p2)
        assert wait_until(lambda: engine.version == 5)
        engine.submit(0, obs, reset=True, reply=sink, request_id=2)
        r2 = sink.wait(2)[1]
        assert r2["version"] == 5
        engine.submit_weights(3, p1)  # stale: dropped
        engine.submit(0, obs, reset=True, reply=sink, request_id=3)
        assert sink.wait(3)[2]["version"] == 5
        # the swap is real: the new weights give another log-prob
        old = engine.reference_step([obs], [0], [1.0], engine.initial_carries(), r2["dispatch_idx"], params=p1)
        assert float(old[1][0]) != r2["logp"]
        assert reg.snapshot()["serve/weight_swaps_total"] == 1.0
        with pytest.raises(ValueError, match="do not fit"):
            engine.submit_weights(9, {"bogus": np.zeros(3)})
    finally:
        engine.stop()


@pytest.mark.parametrize("window_ms,max_batch,n,want_dispatches", [(60.0, 8, 3, 1), (30_000.0, 2, 4, 2)])
def test_window_closes_on_deadline_or_full_batch(window_ms, max_batch, n, want_dispatches):
    jcfg, pcfg = small_configs(max_batch=max_batch, batch_window_ms=window_ms)
    reg = telemetry.Registry()
    engine = port_engine(pcfg, convert(slim_params(jcfg)), registry=reg)
    sink = ReplyCollector()
    obs = obs_row(random_obs(pcfg, (1,), seed=10), 0)
    try:
        t0 = time.perf_counter()
        for slot in range(n):
            engine.submit(slot, obs, reset=True, reply=sink, request_id=slot)
        replies = sink.wait(n, timeout=20.0)
        assert time.perf_counter() - t0 < 20.0
        assert len({r["dispatch_idx"] for r in replies}) == want_dispatches
        snap = reg.snapshot()
        assert snap["serve/dispatches_total"] == want_dispatches
        assert snap["serve/dispatch_errors_total"] == 0.0
        assert snap["serve/batch_fill"] == pytest.approx(n / want_dispatches / max_batch)
    finally:
        engine.stop()


def test_entry_points_raise_without_a_device(monkeypatch):
    """No device given and no CUDA: raise, never carry on on the CPU."""
    jcfg, pcfg = small_configs()
    params = convert(slim_params(jcfg))
    cpu_policy = make_inference_policy(pcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inference_policy(pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(pcfg, cpu_policy, params)


def test_slice_train_params_drops_value_head_both_forms():
    jcfg, _ = small_configs()
    full = flax_params(jcfg)
    assert "head_value" not in slice_train_params(full)["params"]
    state = slice_train_params(convert(full))
    assert not any(k.startswith("head_value") for k in state)
    assert set(state) == set(convert(slim_params(jcfg)))


def test_carry_shadow_rehome_resumes_exactly():
    """A carry-shadow reply ships the slot's new carry row; a fresh engine
    that receives it with the next request resumes as if the game had never
    moved."""
    jcfg, pcfg = small_configs(max_batch=1, batch_window_ms=0.0, carry_shadow=True)
    params = convert(slim_params(jcfg, seed=11))
    obs = random_obs(pcfg, (3,), seed=12)
    rows = []

    def sink(actions, logp, version, request_id, dispatch_idx, carry=None):
        rows.append((np.asarray(actions).copy(), logp, dispatch_idx, carry))

    home, spare = port_engine(pcfg, params), port_engine(pcfg, params)
    try:
        home.submit(0, obs_row(obs, 0), reset=True, reply=sink)
        home.submit(0, obs_row(obs, 1), reset=False, reply=sink)
        assert wait_until(lambda: len(rows) == 2)
        wire = rows[1][3]
        assert set(wire) == {"c0", "c1"} and wire["c0"].shape == (pcfg.model.hidden_dim,)
        spare.submit(0, obs_row(obs, 2), reset=False, reply=sink, carry=wire)
        assert wait_until(lambda: len(rows) == 3)
        carries = home.initial_carries()
        for store, key in zip(carries, ("c0", "c1")):
            store[0] = torch.from_numpy(wire[key]).to(store.dtype)
        packed, logp, _ = home.reference_step([obs_row(obs, 2)], [0], [0.0], carries, rows[2][2])
        np.testing.assert_array_equal(packed[0], rows[2][0])
        assert float(logp[0]) == rows[2][1]
        with pytest.raises(ValueError, match="carry_shadow is off"):
            port_engine(small_configs()[1], params).submit(0, obs_row(obs, 0), True, sink, carry=wire)
    finally:
        home.stop()
        spare.stop()


def test_engine_creates_the_reference_telemetry_keys():
    """A fresh port engine reports every key a fresh JAX engine reports,
    apart from the per-program compile counters (PyTorch compiles no
    program per dispatch)."""
    from dotaclient_tpu.utils import telemetry as jax_telemetry

    jcfg, pcfg = small_configs()
    jreg, preg = jax_telemetry.Registry(), telemetry.Registry()
    jengine = JaxServeEngine(jcfg, jax_inference_policy(jcfg), slim_params(jcfg), registry=jreg)
    engine = port_engine(pcfg, convert(slim_params(jcfg)), registry=preg)
    try:
        want = {k for k in jreg.snapshot() if not k.startswith("compile/serve_dispatch/")}
        assert want <= set(preg.snapshot()), sorted(want - set(preg.snapshot()))
    finally:
        engine.stop()
        jengine.stop()

"""The port's learner in its ``vec`` and ``external`` modes against the JAX
package's, and the actor process into the learner over localhost.

* The ring's host-row ``add``: the same decoded rows through both rings
  (stale, config-skewed, non-finite and bf16-wire rows among them) leave
  the same books and counters, and ``take`` gives the same rows bitwise.
* An ``external`` learner in each package, from the same params, fed the
  same encoded rollouts through an in-process transport, ends K = 2
  optimizer steps with its metrics and params within
  ``test_torch_train``'s f32 bounds.
* The port alone: a ``vec`` learner, sequential and overlapped; the weights
  frames it publishes are the Flax layout; the health gate of the pool
  pushes; mid-run publishes to a transport out of process (the device
  loop's, and the external loop's one a refresh); and the actor
  CLI into the learner over a ``TransportServer`` on 127.0.0.1, in-process
  and through the learner's CLI (threads: every wait bounded, every server
  closed in a ``finally``).
"""

import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dotaclient_tpu.buffer import TrajectoryBuffer as JaxTrajectoryBuffer
from dotaclient_tpu.parallel import make_mesh
from dotaclient_tpu.train.learner import Learner as JaxLearner
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu.transport.queues import InProcTransport as JaxInProcTransport
from dotaclient_tpu_torch.actor import __main__ as actor_cli
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.config import default_config
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models.convert import to_flax
from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.transport.queues import InProcTransport
from dotaclient_tpu_torch.transport.socket_transport import SocketTransport, TransportServer
from dotaclient_tpu_torch.utils import faults, telemetry
from tests.test_torch_amqp import install_fake_pika
from tests.test_torch_buffered import (
    assert_params_close, assert_rows_equal, books, buffered_configs, capture_grads, chunk, noisy_mask,
    telemetry_registry,
)

WAIT_S = 60.0


def rows_of(batch, versions):
    """A chunk batch [L, ...] -> decoded ``(meta, arrays)`` rows."""
    L = batch["valid"].shape[0]

    def row(tree, i):
        if isinstance(tree, dict):
            return {k: row(v, i) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(row(v, i) for v in tree)
        return np.ascontiguousarray(tree[i])

    return [({"model_version": int(versions[i]), "env_id": i, "rollout_id": i, "length": 3, "total_reward": 0.0},
             row(batch, i)) for i in range(L)]


def decoded_in_each(rows, **wire):
    """The rows through the wire: each package's decode of the JAX
    package's bytes."""
    blobs = [J.encode_rollout(a, **m, **wire).SerializeToString() for m, a in rows]
    return [J.decode_rollout_bytes(b, native=False) for b in blobs], [S.decode_rollout_bytes(b) for b in blobs]


def test_ring_host_rows_match_jax():
    jcfg, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    jbuf = JaxTrajectoryBuffer(jcfg, make_mesh(jcfg.mesh), registry=telemetry_registry())
    pbuf = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())

    def add(jrows, prows, version):
        assert jbuf.add(jrows, version) == pbuf.add(prows, version)
        assert books(pbuf) == books(jbuf)
        for key in ("dropped_stale", "dropped_skew", "dropped_nonfinite", "dropped_bounds", "dropped_overflow"):
            assert getattr(pbuf, key) == getattr(jbuf, key), key

    def take(version):
        j, p = jbuf.take(current_version=version), pbuf.take(current_version=version)
        assert books(pbuf) == books(jbuf)
        assert (j is None) == (p is None)
        if p is not None:
            assert_rows_equal(p, j)

    first = rows_of(chunk(pcfg, 6, 1), [0] * 6)
    add(first, first, 0)
    take(0)
    # stale (version 0 at version 9: past the limit of 4), a config-skewed
    # row (T=4), a NaN reward, and rows through the bf16 wire
    mixed = rows_of(chunk(pcfg, 5, 2), [0, 7, 8, 8, 9])
    skewed = rows_of(chunk(dataclasses.replace(pcfg, ppo=dataclasses.replace(pcfg.ppo, rollout_len=4)), 1, 3), [9])
    mixed.insert(2, skewed[0])
    mixed[3][1]["rewards"] = mixed[3][1]["rewards"].copy()
    mixed[3][1]["rewards"][1] = np.nan
    add(mixed, mixed, 9)
    bounds = {f"actions/{h}": n - 1 for h, n in pcfg.actions.head_sizes.items()}
    bounds["obs/hero_id"] = pcfg.model.n_hero_ids - 1
    bounds["obs/unit_handles"] = np.iinfo(np.int16).max
    jnarrow, pnarrow = decoded_in_each(rows_of(chunk(pcfg, 3, 4), [9, 9, 9]), wire_dtype="bfloat16",
                                       int_bounds=bounds)
    add(jnarrow, pnarrow, 9)
    assert pbuf.dropped_stale == 1 and pbuf.dropped_skew == 1 and pbuf.dropped_nonfinite == 1
    take(9)
    take(9)
    # more rows than the ring holds: the newest kept, the rest overflow
    many = rows_of(chunk(pcfg, 11, 5), [9] * 11)
    add(many, many, 9)
    take(10)
    assert pbuf.metrics() == jbuf.metrics()


def test_ring_host_rows_through_pinned_lanes_stay_bitwise():
    """Rows staged in one lane and copied, then the lanes reused: the ring
    holds exactly what each ingest was given."""
    _, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    pcfg = dataclasses.replace(pcfg, buffer=dataclasses.replace(pcfg.buffer, staging_slots=2))
    pbuf = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())
    for k in range(5):
        rows = rows_of(chunk(pcfg, 4, 10 + k), [k] * 4)
        assert pbuf.add(rows, k) == 4
        got = pbuf.take(current_version=k)
        for i, (_, arrays) in enumerate(rows):
            for name, v in S.flatten_tree(arrays).items():
                np.testing.assert_array_equal(S.flatten_tree(got)[name][i].numpy(), v, err_msg=name)


def test_external_learner_matches_jax():
    jcfg, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    jt, pt = JaxInProcTransport(), InProcTransport(registry=telemetry.Registry())
    jl = JaxLearner(jcfg, actor="external", transport=jt, seed=1)
    pl = plearner.Learner(pcfg, actor="external", transport=pt, seed=1, device="cpu", registry=telemetry.Registry())
    pl.policy.load_state_dict(convert(jax.tree.map(np.asarray, jl.state.params)))
    for meta, arrays in rows_of(chunk(pcfg, 8, 21), [0] * 8):
        blob = J.encode_rollout(arrays, **meta).SerializeToString()
        jt.publish_rollout(J.pb.Rollout.FromString(blob))
        pt.publish_rollout(pb.Rollout.FromString(blob))
    seen = capture_grads(pl.state)
    jout = jl.train(2, refresh_every=1)
    pout = pl.train(2, refresh_every=1)
    assert pout["optimizer_steps"] == jout["optimizer_steps"] == 2.0
    assert pout["frames_trained"] == jout["frames_trained"]
    assert books(pl.buffer) == books(jl.buffer)
    assert_params_close(pl.policy, jl.state.params, noisy_mask(pl.policy, seen), "two external steps")
    # both published at the start, each step and the end, in the same layout
    jv, jtree = J.decode_weights(jt.latest_weights())
    pv, ptree = S.decode_weights(pt.latest_weights())
    assert pv == jv == 2 and set(S.flatten_tree(ptree)) == set(S.flatten_tree(jtree))
    for name, w in convert(ptree).items():   # the frame is the params it was cut from
        assert torch.equal(w, pl.policy.state_dict()[name]), name
    jl._snap_engine.stop()
    pl.close()


def test_external_mode_needs_a_transport_and_vec_and_external_are_ported():
    _, pcfg = buffered_configs()
    with pytest.raises(ValueError, match="needs a transport"):
        plearner.Learner(pcfg, actor="external", device="cpu")
    scalar = plearner.Learner(pcfg, actor="scalar", device="cpu", registry=telemetry.Registry())
    assert scalar.pool is scalar.host_pool and scalar.device_actor is None and scalar._sink is None
    assert scalar.host_pool.transport is scalar.transport   # its protos reach the ring by the drain
    scalar.close()
    vec = plearner.Learner(pcfg, actor="vec", device="cpu", registry=telemetry.Registry())
    assert vec.pool is vec.host_pool and vec.device_actor is None and vec._sink.maxlen == 4 * 8
    vec.close()


def vec_config():
    _, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    return dataclasses.replace(pcfg, env=dataclasses.replace(pcfg.env, n_envs=2, opponent="selfplay",
                                                             max_dota_time=2.0), log_every=2)


@pytest.mark.parametrize("overlap", [False, True])
def test_vec_learner_trains_and_keeps_its_books(overlap):
    cfg = vec_config()
    learner = plearner.Learner(cfg, actor="vec", device="cpu", registry=telemetry.Registry())
    before = {k: v.clone() for k, v in learner.policy.state_dict().items()}
    out = learner.train(4, overlap=overlap, refresh_every=1)
    buf = learner.buffer
    assert out["optimizer_steps"] == 4.0 and np.isfinite(out["loss"]) and out["health_ok"] == 1.0
    assert buf.ingested == 4 * 4 + buf.size + buf.dropped_stale + buf.dropped_overflow
    assert buf.dropped_skew == buf.dropped_nonfinite == buf.dropped_bounds == 0
    assert out["actor_env_steps"] > 0 and out["actor_rollouts_shipped"] >= buf.ingested
    assert any(not torch.equal(v, before[k]) for k, v in learner.policy.state_dict().items())
    assert learner.host_pool.version >= (2 if overlap else 3)   # pushed params
    learner.close()


def test_pool_pushes_wait_behind_the_health_gate():
    cfg = dataclasses.replace(vec_config(), learner=dataclasses.replace(vec_config().learner,
                                                                       async_snapshots=False))
    reg = telemetry.Registry()
    learner = plearner.Learner(cfg, actor="vec", device="cpu", registry=reg)
    learner.state.version = 5
    learner._push_pool_params(learner._actor_params_copy())
    assert learner.host_pool.version == 5
    learner._health.fold_host(6, 6, {"loss": float("nan"), "grad_norm": 1.0, "health_ok": 0.0})
    learner.state.version = 6
    learner._push_pool_params(learner._actor_params_copy())
    assert learner.host_pool.version == 5 and reg.snapshot()["health/publish_blocked_total"] == 1.0
    learner.close()


@pytest.mark.parametrize("sync", [False, True])
def test_published_frames_carry_the_flax_layout(sync):
    _, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    pcfg = dataclasses.replace(pcfg, learner=dataclasses.replace(pcfg.learner, async_snapshots=not sync))
    learner = plearner.Learner(pcfg, actor="device", device="cpu", registry=telemetry.Registry())
    learner.train(4)
    msg = learner.transport.latest_weights()
    sd = {k: v.detach() for k, v in learner.policy.state_dict().items()}
    # a map's entries serialize in hash order unless asked for a canonical one
    assert msg.SerializeToString(deterministic=True) == S.encode_weights(
        to_flax(sd), learner.state.version).SerializeToString(deterministic=True)
    version, tree = J.decode_weights(J.pb.ModelWeights.FromString(msg.SerializeToString()))
    assert version == learner.state.version and set(tree["params"]) >= {"core", "unit_encoder", "head_value"}
    learner.close()


def test_device_learner_publishes_mid_run_to_an_out_of_process_transport():
    """A transport other than the in-process one has readers out of
    process: the device loop publishes every refresh_every batches, as the
    reference's does."""
    cfg = dataclasses.replace(buffered_configs(T=3, batch=4, capacity=8, min_fill=4)[1],
                              learner=dataclasses.replace(default_config().learner, async_snapshots=False))
    reg = telemetry.Registry()
    srv = TransportServer(port=0, registry=reg)
    try:
        learner = plearner.Learner(cfg, actor="device", device="cpu", registry=reg, transport=srv)
        learner.train(4, refresh_every=2)
        # steps 2 and 4, and the final publish
        assert reg.snapshot()["transport/weights_published"] == 3.0
        assert srv.latest_weights().version == 4
        learner.close()
    finally:
        srv.close()


def test_external_learner_publishes_once_a_refresh_to_a_server():
    """On a ``TransportServer`` the external loop's own refresh cadence is
    the only mid-run publish (the device loops' boundary publish stays
    off): the start, every ``refresh_every`` batches and the end."""
    cfg = dataclasses.replace(buffered_configs(T=3, batch=4, capacity=8, min_fill=4)[1],
                              learner=dataclasses.replace(default_config().learner, async_snapshots=False))
    reg = telemetry.Registry()
    srv = TransportServer(port=0, registry=reg)
    try:
        learner = plearner.Learner(cfg, actor="external", device="cpu", registry=reg, transport=srv)
        actor = SocketTransport(*srv.address)
        try:
            for meta, arrays in rows_of(chunk(cfg, 8, 23), [0] * 8):
                actor.publish_rollout_bytes(S.encode_rollout(arrays, **meta).SerializeToString())
            deadline = time.time() + WAIT_S
            while srv.pending_rollouts < 8 and time.time() < deadline:
                time.sleep(0.01)
        finally:
            actor.close()
        steps, refresh_every = 2, 1
        out = learner.train(steps, refresh_every=refresh_every)
        assert out["optimizer_steps"] == steps
        assert reg.snapshot()["transport/weights_published"] == 1 + steps // refresh_every + 1
        assert srv.latest_weights().version == steps
        learner.close()
    finally:
        srv.close()


def smoke_external_config():
    cfg = plearner.smoke_config(default_config())
    return dataclasses.replace(cfg, log_every=10 ** 9)


def actor_args(port, seed, steps=0):
    return ["--connect", f"127.0.0.1:{port}", "--n-envs", "2", "--rollout-len", "8", "--platform", "cpu",
            "--opponent", "selfplay", "--max-dota-time", "2", "--refresh-every", "4", "--seed", str(seed),
            "--steps", str(steps)]


def test_actor_process_into_an_external_learner_over_localhost(capsys):
    reg = telemetry.Registry()
    srv = TransportServer(port=0, registry=reg)
    threads, rcs = [], []
    try:
        learner = plearner.Learner(smoke_external_config(), actor="external", device="cpu", transport=srv,
                                   registry=reg)
        for i in range(2):
            threads.append(threading.Thread(target=lambda i=i: rcs.append(actor_cli.main(actor_args(
                srv.address[1], i, steps=48))), daemon=True))
            threads[-1].start()
        out = learner.train(3, refresh_every=1)
        for t in threads:
            t.join(WAIT_S)
        learner.close()
    finally:
        srv.close()
    assert rcs == [0, 0]
    snap = reg.snapshot()
    assert out["optimizer_steps"] == 3.0 and out["frames_trained"] == 3 * 8 * 8
    assert snap["transport/rollout_bytes_total"] > 0 and snap["buffer/dropped_skew"] == 0
    lines = capsys.readouterr().out.splitlines()
    seen = [x for x in lines if x.startswith("ACTOR_VERSIONS_SEEN ")]
    # the actors applied weights the learner published after its first step
    assert len(seen) == 2 and all(max(eval(x.split(" ", 1)[1])) > 0 for x in seen)


def test_learner_cli_listens_for_actor_processes(monkeypatch, capsys):
    servers = []

    class Recorded(TransportServer):
        def __init__(self, host, port, **kw):
            super().__init__(host, 0, **kw)
            servers.append(self)

    monkeypatch.setattr(plearner, "TransportServer", Recorded)
    done = []
    learner = threading.Thread(target=lambda: done.append(plearner.main(
        ["--smoke", "--device", "cpu", "--transport", "socket", "--steps", "2", "--refresh-every", "1"])),
        daemon=True)
    learner.start()
    deadline = time.time() + WAIT_S
    while not servers and time.time() < deadline:
        time.sleep(0.01)
    rc = []
    actor = threading.Thread(target=lambda: rc.append(actor_cli.main(actor_args(servers[0].address[1], 3, 64))),
                             daemon=True)
    actor.start()
    learner.join(WAIT_S)
    actor.join(WAIT_S)
    assert done == [0] and rc in ([0], [1])   # the actor may outlive the learner's server
    out = capsys.readouterr().out
    assert "learner: listening for actors on" in out and "done: 2 steps" in out


@pytest.mark.parametrize("transport", ["shm", "amqp"])
def test_learner_cli_refuses_the_transports_of_item_13(transport, capsys, monkeypatch):
    if transport == "amqp":
        # ported: the learner CLI on a broker (the fake pika of
        # tests/test_torch_amqp.py), an actor CLI with --amqp feeding it. The
        # actor binds its fanout queue first: the learner's first publish
        # goes only to queues bound before it, as on RabbitMQ
        broker = install_fake_pika(monkeypatch)
        done, rc = [], []
        args = actor_args(0, 4, 64)
        args[:2] = ["--amqp", "broker"]
        actor = threading.Thread(target=lambda: rc.append(actor_cli.main(args)), daemon=True)
        actor.start()
        deadline = time.time() + WAIT_S
        while not broker.exchanges.get("weights") and time.time() < deadline:
            time.sleep(0.01)
        learner = threading.Thread(target=lambda: done.append(plearner.main(
            ["--smoke", "--device", "cpu", "--transport", "amqp", "--amqp-host", "broker", "--steps", "2",
             "--refresh-every", "1"])), daemon=True)
        learner.start()
        learner.join(WAIT_S)
        actor.join(WAIT_S)
        assert done == [0] and rc == [0]
        out = capsys.readouterr().out
        assert "learner: AMQP broker broker:5672" in out and "done: 2 steps" in out
        seen = [x for x in out.splitlines() if x.startswith("ACTOR_VERSIONS_SEEN ")]
        assert len(seen) == 1 and max(eval(seen[0].split(" ", 1)[1])) > 0
        return
    # the shm lane is ported: the learner CLI serves it (implying --actor
    # external) and an actor CLI feeds it; the lane is gone afterwards
    name = f"t-cli-{os.getpid()}"
    done, rc = [], []
    learner = threading.Thread(target=lambda: done.append(plearner.main(
        ["--smoke", "--device", "cpu", "--transport", "shm", "--shm-name", name, "--steps", "2",
         "--refresh-every", "1"])), daemon=True)
    learner.start()
    args = actor_args(0, 4, 64)
    args[1] = f"shm://{name}"
    actor = threading.Thread(target=lambda: rc.append(actor_cli.main(args)), daemon=True)
    actor.start()
    learner.join(WAIT_S)
    actor.join(WAIT_S)
    assert done == [0] and rc == [0]
    out = capsys.readouterr().out
    assert f"learner: shm lane {name!r} (16 actor slots" in out and "done: 2 steps" in out
    seen = [x for x in out.splitlines() if x.startswith("ACTOR_VERSIONS_SEEN ")]
    assert len(seen) == 1 and max(eval(seen[0].split(" ", 1)[1])) > 0
    assert not [f for f in os.listdir("/dev/shm") if f.startswith(name)]


def test_the_nonfinite_fault_is_dropped_at_the_ring_door():
    cfg = vec_config()
    faults.configure("actor.nonfinite_payload@1")
    try:
        learner = plearner.Learner(cfg, actor="vec", device="cpu", registry=telemetry.Registry())
    finally:
        faults.configure(None)
    learner.train(2)
    assert learner.buffer.dropped_nonfinite == 1
    learner.close()


# -- the fleet publisher: the actor CLI at its defaults arms the learner's curves ----------------------


def test_first_maybe_publish_ships_on_a_low_clock():
    """The reference starts its clock at 0.0 against ``time.monotonic()``,
    so on a host up less than ``interval_s`` its first snapshot waits a
    whole interval; the port's first call ships whatever the clock reads."""
    from dotaclient_tpu_torch.utils import fleet

    now = [5.0]   # a host up 5 s, an interval of an hour
    reg = telemetry.Registry()
    reg.counter("actor/env_steps").inc(12)
    sent = []
    pub = fleet.FleetPublisher(peer_id=3, interval_s=3600.0, registry=reg, clock=lambda: now[0])
    lane = type("Lane", (), {"publish_metrics_bytes": lambda self, b: sent.append(b)})()
    assert pub.maybe_publish(lane) and len(sent) == 1
    assert not pub.maybe_publish(lane)                     # within the interval
    now[0] += 3600.0
    assert pub.maybe_publish(lane) and len(sent) == 2
    assert pub.maybe_publish(lane, force=True) and len(sent) == 3
    assert not pub.maybe_publish(object(), force=True)     # a lane without a metrics channel
    snaps = [fleet.decode_snapshot(b) for b in sent]
    assert [s["seq"] for s in snaps] == [0, 1, 2] and {s["peer"] for s in snaps} == {"a3"}
    assert snaps[0]["counters"]["actor/env_steps"] == 12.0
    # configure / get / shutdown, and an interval of 0 turns it off
    try:
        assert fleet.configure(peer_id=4, interval_s=0.0) is None and fleet.get() is None
        assert fleet.configure(peer_id=4, registry=reg) is fleet.get()
        assert fleet.get().interval_s == telemetry.fleet_interval_s and fleet.get().kind == "actor"
    finally:
        fleet.shutdown()
    assert fleet.get() is None


@pytest.mark.parametrize("lane", ["socket", "shm"])
def test_actor_cli_at_defaults_arms_the_learners_fleet_and_outcome_curves(lane):
    """An actor process at the CLI's defaults (a snapshot every 5 s from
    its first weights refresh) into an external learner: the learner sees
    one peer with its ``fleet/a7/*`` keys, and the vs-scripted win-rate
    curve armed, as a JAX actor process gives it."""
    import signal
    import subprocess
    import sys

    from dotaclient_tpu_torch.transport.shm_transport import ShmTransportServer

    reg = telemetry.Registry()
    if lane == "socket":
        srv = TransportServer(port=0, registry=reg)
        connect = f"127.0.0.1:{srv.address[1]}"
    else:
        srv = ShmTransportServer(name=f"t-fleet-{os.getpid()}", slots=2, ring_bytes=1 << 20, weights_bytes=1 << 22,
                                 registry=reg)
        connect = f"shm://{srv.address}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    actor = None
    try:
        learner = plearner.Learner(smoke_external_config(), actor="external", device="cpu", transport=srv,
                                   registry=reg)
        actor = subprocess.Popen(
            [sys.executable, "-m", "dotaclient_tpu_torch.actor", "--connect", connect, "--n-envs", "2",
             "--rollout-len", "8", "--opponent", "scripted_easy", "--max-dota-time", "2", "--seed", "7",
             "--platform", "cpu"],
            cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        out = learner.train(2, refresh_every=1)
        deadline = time.time() + WAIT_S
        while time.time() < deadline:
            snap = reg.snapshot()
            if snap["fleet/peers"] == 1.0 and snap["outcome/stream_age_s"] >= 0.0:
                break
            if lane == "shm":
                srv.consume_decoded(64, timeout=0.05)   # the shm drain is the receive: metrics frames too
            else:
                time.sleep(0.05)
        learner.close()
    finally:
        if actor is not None:
            actor.send_signal(signal.SIGTERM)
            err = actor.communicate(timeout=WAIT_S)[1].decode()
        srv.close()
    assert out["optimizer_steps"] == 2.0 and actor.returncode == 0, err[-2000:]
    snap = reg.snapshot()
    assert snap["fleet/snapshots_total"] >= 2 and snap["fleet/peers"] == 1.0
    assert snap["fleet/a7/actor/env_steps"] > 0 and snap["fleet/a7/outcome/episodes/vs_scripted"] > 0
    assert snap["outcome/stream_age_s"] >= 0.0 and snap["outcome/episodes_total"] > 0
    assert 0.0 <= snap["outcome/win_rate/vs_scripted"] <= 1.0


def test_serve_cli_with_subscribe_ships_serve_snapshots(tmp_path):
    """``--subscribe`` with ``--fleet-interval``: the serve process's
    snapshots (peer ``s<listen port>``) reach the learner's side of the
    lane, the first at once."""
    import contextlib
    import io
    import json

    from dotaclient_tpu_torch.serve import __main__ as serve_cli
    from dotaclient_tpu_torch.utils import fleet
    from tests.test_torch_common import flax_params
    from tests.test_torch_server import configs, save_checkpoint

    jcfg, pcfg = configs()
    ck = str(tmp_path / "ckpt")
    save_checkpoint(pcfg, flax_params(jcfg, seed=4), ck)
    reg = telemetry.Registry()
    srv = TransportServer(port=0, registry=reg)
    got = []
    srv.metrics_handler = lambda b: got.append(fleet.decode_snapshot(b))
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert serve_cli.main(["--checkpoint", ck, "--device", "cpu", "--subscribe",
                                   f"127.0.0.1:{srv.address[1]}", "--fleet-interval", "0.5",
                                   "--serve-listen", "127.0.0.1:0", "--duration", "1.2"]) == 0
        deadline = time.time() + WAIT_S
        while len(got) < 2 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        srv.close()
    port = json.loads(out.getvalue().split("SERVE_LISTENING ", 1)[1].splitlines()[0])["port"]
    assert len(got) >= 2 and {s["kind"] for s in got} == {"serve"} and {s["peer"] for s in got} == {f"s{port}"}
    assert [s["seq"] for s in got] == list(range(len(got)))

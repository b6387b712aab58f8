"""The port's learner-side socket transport and weights frames, against the
JAX package.

``to_flax`` inverts ``convert`` bitwise and lays the tree out as a Flax
``init_params`` tree, so the port's weights frames are the JAX package's
bytes at f32. ``decode_drained_payloads`` gives the JAX package's meta and
byte counters. Over localhost, the JAX package's ``SocketTransport`` ships
rollouts to the port's ``TransportServer`` and reads its weights, and the
port's actor side does the same against the JAX server; the
``transport.corrupt_frame`` and ``transport.drop_conn`` fault sites leave
the same quarantine and reconnect counters on both servers. The rest holds
the port's server to the reference's behaviour (``tests/test_faults.py``):
malformed peers, liveness, the latest-wins fanout. Every socket binds port
0, every wait has its own timeout, and every server closes in a
``finally``.
"""

import functools
import socket as socket_mod
import time

import jax
import numpy as np
import pytest

from dotaclient_tpu.actor.__main__ import connect_with_backoff as jax_connect_with_backoff
from dotaclient_tpu.config import default_config as jax_default_config
from dotaclient_tpu.models.policy import init_params as jax_init_params
from dotaclient_tpu.models.policy import make_policy as jax_make_policy
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu.transport.socket_transport import SocketTransport as JaxSocketTransport
from dotaclient_tpu.transport.socket_transport import TransportServer as JaxTransportServer
from dotaclient_tpu.utils import faults as jax_faults
from dotaclient_tpu.utils import telemetry as jax_telemetry
from dotaclient_tpu_torch.actor.backoff import connect_with_backoff
from dotaclient_tpu_torch.config import default_config
from dotaclient_tpu_torch.models.convert import convert, random_flax_params, to_flax
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.transport import socket_transport as T
from dotaclient_tpu_torch.transport.socket_transport import SocketTransport, TransportServer
from dotaclient_tpu_torch.utils import faults, telemetry

WAIT_S = 5.0


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.configure(None)
    jax_faults.configure(None)


def wait_until(pred, timeout=WAIT_S, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def host_tree(tree):
    """A JAX param tree as numpy, its key order kept (``jax.tree.map``
    would sort the keys)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def jax_init_tree(seed=0):
    """Read only: cached."""
    cfg = jax_default_config()
    return host_tree(jax_init_params(jax_make_policy(cfg.model, cfg.obs, cfg.actions), jax.random.PRNGKey(seed)))


def flat_equal(a, b):
    fa, fb = S.flatten_tree(a), S.flatten_tree(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert np.asarray(fb[k]).dtype == np.asarray(fa[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(fb[k]), np.asarray(fa[k]), err_msg=k)
    return list(fa) == list(fb)


# -- the weights frame ------------------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["init_params", "random_flax_params"])
def test_to_flax_inverts_convert(source):
    tree = jax_init_tree(3) if source == "init_params" else random_flax_params(default_config(), seed=4)
    back = to_flax(convert(tree))
    same_order = flat_equal(tree, back)
    # the key order is init_params' (random_flax_params sorts its keys)
    assert same_order == (source == "init_params")
    assert list(S.flatten_tree(back)) == list(S.flatten_tree(jax_init_tree(0)))


def test_to_flax_of_an_inference_policy_has_no_value_head():
    sd = convert(jax_init_tree(1))
    sd = {k: v for k, v in sd.items() if not k.startswith("head_value.")}
    assert "head_value" not in to_flax(sd)["params"]
    flat_equal(to_flax(sd), {"params": {k: v for k, v in jax_init_tree(1)["params"].items() if k != "head_value"}})


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_weights_frame_bytes_equal_the_jax_packages(wire):
    tree = jax_init_tree(5)
    port = S.encode_weights(to_flax(convert(tree)), 7, wire_dtype=wire).SerializeToString()
    assert port == J.encode_weights(tree, 7, wire_dtype=wire).SerializeToString()
    # and the JAX package reads it back to the same tree
    version, got = J.decode_weights(J.pb.ModelWeights.FromString(port))
    assert version == 7
    if wire == "float32":
        flat_equal(tree, got)


# -- decode_drained_payloads ------------------------------------------------------------------------------


def rollout_arrays(seed, T_=4):
    rng = np.random.default_rng(seed)
    return {
        "obs": {"units": rng.normal(size=(T_ + 1, 3, 2)).astype(np.float32),
                "hero_id": rng.integers(0, 4, size=(T_ + 1,)).astype(np.int32)},
        "actions": {"action_type": rng.integers(0, 4, size=(T_,)).astype(np.int32)},
        "behavior_logp": rng.normal(size=(T_,)).astype(np.float32),
        "rewards": rng.normal(size=(T_,)).astype(np.float32),
        "carry0": (rng.normal(size=(5,)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)),
    }


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_decode_drained_payloads_matches_jax(wire):
    kw = {} if wire == "float32" else {"wire_dtype": "bfloat16", "int_bounds": {"actions/action_type": 3,
                                                                               "obs/hero_id": 3}}
    payloads = [J.encode_rollout(rollout_arrays(i), i, i, i, 4, 0.5, **kw).SerializeToString() for i in range(3)]
    payloads.insert(1, b"\xff\x00 not a rollout")
    items = [(float(i), p) for i, p in enumerate(payloads)]
    reg, jreg = telemetry.Registry(), jax_telemetry.Registry()
    totals, jtotals = [0, 0], [0, 0]
    for _ in range(2):   # the totals accumulate across drains
        got, bad = S.decode_drained_payloads(items, reg, totals)
        want, jbad = J.decode_drained_payloads(items, jreg, jtotals)
    assert bad == jbad == 1 and totals == jtotals
    assert [m for m, _ in got] == [m for m, _ in want]
    if wire == "bfloat16":
        # the byte accounting, to the byte: raw is the full-width encode
        full = [J.encode_rollout(rollout_arrays(i), i, i, i, 4, 0.5).SerializeToString() for i in range(3)]
        assert [m["raw_bytes"] for m, _ in got] == [len(p) for p in full]
    for key in ("transport/rollout_bytes_total", "transport/rollout_raw_bytes_total",
                "transport/rollout_compression_ratio"):
        assert reg.snapshot()[key] == jreg.snapshot()[key], key


def test_rollout_wire_kwargs_match_jax():
    import dataclasses

    from dotaclient_tpu.transport.serialize import rollout_wire_kwargs as jax_kwargs

    for wire in ("float32", "bfloat16"):
        pcfg, jcfg = default_config(), jax_default_config()
        pcfg = dataclasses.replace(pcfg, transport=dataclasses.replace(pcfg.transport, rollout_wire_dtype=wire))
        jcfg = dataclasses.replace(jcfg, transport=dataclasses.replace(jcfg.transport, rollout_wire_dtype=wire))
        assert S.rollout_wire_kwargs(pcfg) == jax_kwargs(jcfg)


# -- the two packages over localhost ----------------------------------------------------------------------


def tiny_rollout(rid=0, n=16):
    return S.encode_rollout({"rewards": np.arange(n, dtype=np.float32) + rid}, model_version=0, env_id=0,
                            rollout_id=rid, length=n, total_reward=0.0)


SERVERS = {"jax": JaxTransportServer, "port": TransportServer}
CLIENTS = {"jax": JaxSocketTransport, "port": SocketTransport}
FAULTS = {"jax": jax_faults, "port": faults}
BACKOFF = {"jax": jax_connect_with_backoff, "port": connect_with_backoff}


def server_registry(kind):
    return jax_telemetry.get_registry() if kind == "jax" else telemetry.get_registry()


def counter(kind, name):
    return server_registry(kind).counter(name).value


def drain_ids(server, want, timeout=WAIT_S):
    got = []
    deadline = time.time() + timeout
    while len(got) < want and time.time() < deadline:
        got.extend(r.rollout_id for r in server.consume_rollouts(64, timeout=0.1))
    return sorted(got)


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_rollouts_up_and_weights_down_across_packages(client, server):
    srv = SERVERS[server](port=0)
    try:
        actor = CLIENTS[client](*srv.address)
        for i in range(5):
            actor.publish_rollout_bytes(tiny_rollout(i).SerializeToString())
        assert drain_ids(srv, 5) == [0, 1, 2, 3, 4]
        tree = jax_init_tree(2)
        srv.publish_weights(J.encode_weights(tree, 1))
        srv.publish_weights(S.encode_weights(to_flax(convert(tree)), 2))
        assert wait_until(lambda: actor.latest_weights() is not None and actor.latest_weights().version == 2)
        _, got = S.decode_weights(actor.latest_weights())
        flat_equal(tree, got)
        actor.close()
    finally:
        srv.close()


def test_consume_decoded_keeps_the_byte_accounting():
    reg = telemetry.Registry()
    srv = TransportServer(port=0, registry=reg)
    try:
        actor = SocketTransport(*srv.address)
        payloads = [S.encode_rollout_bytes(rollout_arrays(i), i, 0, i, 4, 0.0) for i in range(3)]
        for p in payloads:
            actor.publish_rollout_bytes(p)
        actor.publish_rollout_bytes(b"\xff\x00 not a rollout")
        got = []
        assert wait_until(lambda: got.extend(srv.consume_decoded(16, timeout=0.05)) or
                          len(got) == 3 and srv.bad_payloads == 1)
        assert [m["rollout_id"] for m, _ in got] == [0, 1, 2]
        snap = reg.snapshot()
        assert snap["transport/rollout_bytes_total"] == sum(len(p) for p in payloads)
        assert snap["transport/rollout_compression_ratio"] == 1.0
        assert snap["transport/malformed_payloads_total"] == 1.0
        actor.close()
    finally:
        srv.close()


def quarantine_counts(server_kind, client_kind):
    """Every frame of one client corrupt at a poison limit of 2, a clean
    client beside it: the server's corrupt-frame and quarantine counts and
    the clean client's rollouts."""
    srv = SERVERS[server_kind](port=0, poison_frame_limit=2)
    c0, q0 = counter(server_kind, "transport/frames_corrupt_total"), counter(server_kind, "transport/peers_quarantined")
    try:
        FAULTS[client_kind].configure("transport.corrupt_frame@1+1")
        poisoner = CLIENTS[client_kind](*srv.address)
        FAULTS[client_kind].configure(None)
        survivor = CLIENTS[client_kind](*srv.address)
        for i in range(3):
            try:
                poisoner.publish_rollout_bytes(tiny_rollout(i).SerializeToString())
            except (ConnectionError, OSError):
                break
        assert wait_until(lambda: counter(server_kind, "transport/peers_quarantined") == q0 + 1)
        survivor.publish_rollout_bytes(tiny_rollout(42).SerializeToString())
        ids = drain_ids(srv, 1)
        poisoner.close()
        survivor.close()
        return (counter(server_kind, "transport/frames_corrupt_total") - c0,
                counter(server_kind, "transport/peers_quarantined") - q0, ids)
    finally:
        srv.close()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_corrupt_frames_quarantine_alike_on_both_servers(client):
    port = quarantine_counts("port", client)
    assert port == quarantine_counts("jax", client)
    assert port == (2.0, 1.0, [42])


def reconnect_counts(server_kind, client_kind):
    """The client's 2nd publish closes its own socket (``drop_conn``): the
    send fails, the client reconnects through its backoff, and goes on. The
    client's reconnect count, the rollouts that arrived, and the server's
    corrupt and quarantine counts (none)."""
    srv = SERVERS[server_kind](port=0)
    creg = server_registry(client_kind)
    r0 = creg.counter("transport/reconnects_total").value
    c0, q0 = counter(server_kind, "transport/frames_corrupt_total"), counter(server_kind, "transport/peers_quarantined")
    try:
        FAULTS[client_kind].configure("transport.drop_conn@2")
        actor = CLIENTS[client_kind](*srv.address)
        sent = []
        for i in range(4):
            try:
                actor.publish_rollout_bytes(tiny_rollout(i).SerializeToString())
                sent.append(i)
            except (ConnectionError, OSError):
                actor.close()
                FAULTS[client_kind].configure(None)
                actor = BACKOFF[client_kind](lambda: CLIENTS[client_kind](*srv.address), max_attempts=3,
                                             base_delay=0.01)
        ids = drain_ids(srv, len(sent))
        assert wait_until(lambda: srv.n_connected >= 1)
        actor.close()
        return (creg.counter("transport/reconnects_total").value - r0,
                counter(server_kind, "transport/frames_corrupt_total") - c0,
                counter(server_kind, "transport/peers_quarantined") - q0, ids)
    finally:
        srv.close()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_dropped_connections_reconnect_alike_on_both_servers(client):
    port = reconnect_counts("port", client)
    assert port == reconnect_counts("jax", client)
    # the first backoff attempt connects: no retry is counted
    assert port == (0.0, 0.0, 0.0, [0, 2, 3])


def test_delay_send_sleeps_before_each_rollout_frame():
    srv = TransportServer(port=0)
    try:
        faults.configure("transport.delay_send=0.05")
        actor = SocketTransport(*srv.address)
        t0 = time.perf_counter()
        for i in range(3):
            actor.publish_rollout_bytes(tiny_rollout(i).SerializeToString())
        assert time.perf_counter() - t0 >= 0.15
        assert drain_ids(srv, 3) == [0, 1, 2]
        actor.close()
    finally:
        srv.close()


# -- the port's server alone, as tests/test_faults.py holds the JAX one ------------------------------------


def test_producer_death_mid_frame_does_not_wedge_the_reader():
    srv = TransportServer(port=0)
    try:
        raw = socket_mod.create_connection(srv.address)
        payload = tiny_rollout(7).SerializeToString()
        raw.sendall(T._pack_header(T._KIND_ROLLOUT, len(payload)) + payload[: len(payload) // 2])
        raw.close()
        survivor = SocketTransport(*srv.address)
        survivor.publish_rollout(tiny_rollout(8))
        assert drain_ids(srv, 1) == [8]
        survivor.close()
    finally:
        srv.close()


def test_a_corrupt_header_is_quarantined_at_once():
    reg = telemetry.Registry()
    srv = TransportServer(port=0, poison_frame_limit=100, registry=reg)
    try:
        bad = bytearray(T._pack_header(T._KIND_ROLLOUT, 16384))
        bad[3] ^= 0x01   # the length word changed, its CRC stale
        raw = socket_mod.create_connection(srv.address)
        raw.sendall(bytes(bad))
        assert wait_until(lambda: reg.counter("transport/peers_quarantined").value == 1)
        raw.close()
        raw2 = socket_mod.create_connection(srv.address)
        raw2.sendall(T._pack_header(T._KIND_ROLLOUT, T.MAX_FRAME + 1))   # a valid CRC, past MAX_FRAME
        assert wait_until(lambda: reg.counter("transport/peers_quarantined").value == 2)
        raw2.close()
    finally:
        srv.close()


def test_heartbeats_keep_a_quiet_pair_alive():
    reg = telemetry.Registry()
    srv = TransportServer(port=0, heartbeat_interval_s=0.05, idle_timeout_s=0.5, registry=reg)
    try:
        actor = SocketTransport(*srv.address, idle_timeout_s=0.5)
        time.sleep(1.2)
        assert reg.counter("transport/heartbeats_sent").value > 0
        assert actor.latest_weights() is None   # alive: no raise
        assert srv.n_connected == 1
        actor.close()
    finally:
        srv.close()


def test_the_actor_detects_a_silent_learner():
    srv = TransportServer(port=0, heartbeat_interval_s=0.0, idle_timeout_s=0.0)
    try:
        actor = SocketTransport(*srv.address, idle_timeout_s=0.3)
        assert wait_until(lambda: actor._dead is not None)
        with pytest.raises(ConnectionError):
            actor.latest_weights()
        with pytest.raises(ConnectionError):
            actor.publish_rollout(tiny_rollout(0))
        actor.close()
    finally:
        srv.close()


def test_the_learner_drops_an_idle_connection():
    reg = telemetry.Registry()
    srv = TransportServer(port=0, heartbeat_interval_s=0.0, idle_timeout_s=0.3, registry=reg)
    try:
        raw = socket_mod.create_connection(srv.address)
        assert wait_until(lambda: srv.n_connected == 1)
        assert wait_until(lambda: reg.counter("transport/conn_idle_drops").value == 1)
        assert srv.n_connected == 0
        raw.close()
    finally:
        srv.close()


def test_fanout_is_latest_wins_and_drops_a_stalled_peer():
    """A peer that never reads: publishes coalesce in its slot, and once
    it is more than fanout_max_lag behind it is dropped, while a reading
    peer gets the newest version."""
    reg = telemetry.Registry()
    srv = TransportServer(port=0, fanout_max_lag=2, heartbeat_interval_s=0.0, idle_timeout_s=0.0, registry=reg)
    try:
        stalled = socket_mod.create_connection(srv.address)
        stalled.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_RCVBUF, 4096)
        reader = SocketTransport(*srv.address)
        assert wait_until(lambda: srv.n_connected == 2)
        big = {"w": np.ones(1 << 20, np.float32)}   # 4 MB: fills the stalled socket
        for v in range(1, 6):
            srv.publish_weights(S.encode_weights(big, v))
            # the reading peer keeps up, so it is never over the budget
            assert wait_until(lambda: reader.latest_weights() is not None and reader.latest_weights().version == v)
        assert reg.counter("transport/fanout_conns_dropped").value == 1
        assert srv.n_connected == 1
        reader.close()
        stalled.close()
    finally:
        srv.close()


def test_a_late_joiner_gets_the_current_weights():
    srv = TransportServer(port=0)
    try:
        srv.publish_weights(S.encode_weights({"w": np.arange(3, dtype=np.float32)}, 4))
        actor = SocketTransport(*srv.address)
        assert wait_until(lambda: actor.latest_weights() is not None)
        assert actor.latest_weights().version == 4 == srv.latest_weights().version
        actor.close()
    finally:
        srv.close()


def test_metrics_frames_reach_the_handler_and_drop_oldest_bounds_the_queue():
    reg = telemetry.Registry()
    srv = TransportServer(port=0, max_rollouts=3, registry=reg)
    try:
        got = []
        srv.metrics_handler = got.append
        actor = SocketTransport(*srv.address)
        actor.publish_metrics_bytes(b"snapshot")
        for i in range(5):
            actor.publish_rollout(tiny_rollout(i))
        assert wait_until(lambda: got == [b"snapshot"] and reg.counter("transport/experience_published").value == 5)
        assert srv.pending_rollouts == 3 and srv.dropped == 2
        assert drain_ids(srv, 3) == [2, 3, 4]
        with pytest.raises(RuntimeError):
            srv.publish_rollout(tiny_rollout(0))
        with pytest.raises(RuntimeError):
            actor.publish_weights(None)
        actor.close()
    finally:
        srv.close()


def test_transport_package_exports_the_references_names():
    import dotaclient_tpu.transport as jt
    import dotaclient_tpu_torch.transport as pt

    assert set(pt.__all__) == set(jt.__all__)
    for name in pt.__all__:
        assert getattr(pt, name) is not None

"""The port's serve fleet on the CPU, held against the JAX package.

The session router, hot spares, re-homing and the fleet-mode client: the
router cases of ``tests/test_router.py`` mirrored on the port against a
wire-accurate fake backend; the port's ``SessionRouter`` and the JAX one
answering one op sequence alike; a JAX client re-homed through the port's
router onto port backends and a port client through the JAX router onto
JAX backends, each across a backend kill, with the served log-probs equal
to the JAX policy's (f32 compute, atol 1e-5); the port's re-home parity
digest; the alert engine against the JAX one on the same snapshot streams
with a fake clock; and the router CLI on a thread. Every socket has a
timeout and every server is closed in ``finally``.
"""

import contextlib
import ctypes
import dataclasses
import json
import socket
import threading
import time

import numpy as np
import pytest

from dotaclient_tpu.serve import PolicyServer as JaxPolicyServer
from dotaclient_tpu.serve import ServeClient as JaxServeClient
from dotaclient_tpu.serve import ServeEngine as JaxServeEngine
from dotaclient_tpu.serve import SessionRouter as JaxSessionRouter
from dotaclient_tpu.serve import make_inference_policy as jax_inference_policy
from dotaclient_tpu.serve import route_call as jax_route_call
from dotaclient_tpu.utils import alerts as jax_alerts
from dotaclient_tpu.utils import telemetry as jax_telemetry
from dotaclient_tpu.utils.fleet import peer_label as jax_peer_label
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models.distributions import HEADS
from dotaclient_tpu_torch.serve import PolicyServer, ServeClient, ServeDeadlineError, SessionRouter, route_call
from dotaclient_tpu_torch.serve import loadgen
from dotaclient_tpu_torch.serve import router as router_cli
from dotaclient_tpu_torch.serve.router import KIND_ROUTE_REPLY, KIND_ROUTE_REQUEST
from dotaclient_tpu_torch.serve.server import ATTACH_REQUEST_ID, KIND_SERVE_REPLY, KIND_SERVE_REQUEST, encode_reply
from dotaclient_tpu_torch.transport.serialize import decode_rollout_bytes, encode_rollout_bytes
from dotaclient_tpu_torch.transport.socket_transport import FrameCorrupt, FramingLost, _recv_frame, _send_frame
from dotaclient_tpu_torch.utils import alerts, telemetry
from dotaclient_tpu_torch.utils.fleet import peer_label
from scripts.check_telemetry_schema import ROUTER_KEYS, validate_lines
from tests.test_torch_common import flax_params
from tests.test_torch_server import (
    ATOL,
    TIMEOUT_S,
    Lines,
    configs,
    is_legal,
    jax_logps_over_stream,
    port_stack,
    stream,
    wait_until,
    with_poison_limit,
)

# probes fast enough for a test; deadlines and retries roomy enough for a
# slow host (the re-home parity digest's numbers)
FLEET = dict(router_probe_s=0.1, router_dead_after_s=0.4, request_deadline_s=20.0, request_retries=16)


class FakeBackend:
    """A wire-accurate, policy-free serve backend: it sends each joiner the
    attach frame, skips every frame but a serve request (so a router's
    probe sees a live peer), and applies one behavior to requests:

    * ``"echo"``: reply to every request with a fixed action row;
    * ``"blackhole"``: read requests, never reply (a stuck window);
    * ``"close_first"``: close the connection on the first ``close_first``
      requests it ever sees, then echo (a transient failure).
    """

    ROW = np.array([1, 2, 3, 0, 4], np.int32)

    def __init__(self, behavior="echo", close_first=0, port=0):
        self.behavior = behavior
        self.close_remaining = close_first
        self.requests_seen = 0
        self._lock = threading.Lock()
        self._next_slot = 0
        self._conns = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", port))
        self._listener.listen(32)
        self.address = self._listener.getsockname()
        self._closed = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(sock)
                slot, self._next_slot = self._next_slot, self._next_slot + 1
            threading.Thread(target=self._conn_loop, args=(sock, slot), daemon=True).start()

    def _conn_loop(self, sock, slot):
        try:
            _send_frame(sock, KIND_SERVE_REPLY, encode_reply(np.zeros(len(HEADS), np.int32), 0.0, 1, slot,
                                                             ATTACH_REQUEST_ID))
            while not self._closed.is_set():
                frame = _recv_frame(sock)
                if frame is None:
                    return
                kind, payload = frame
                if kind != KIND_SERVE_REQUEST:
                    continue  # probe heartbeats
                with self._lock:
                    self.requests_seen += 1
                    must_close = self.close_remaining > 0
                    if must_close:
                        self.close_remaining -= 1
                    seen = self.requests_seen
                if self.behavior == "blackhole":
                    continue
                if self.behavior == "close_first" and must_close:
                    return
                meta, _ = decode_rollout_bytes(bytes(payload), upcast=True)
                _send_frame(sock, KIND_SERVE_REPLY, encode_reply(self.ROW, 0.25, 1, slot, meta["rollout_id"],
                                                                 dispatch_idx=seen))
        except (OSError, FrameCorrupt, FramingLost):
            pass
        finally:
            sock.close()

    def close(self):
        self._closed.set()
        self._listener.close()
        with self._lock:
            conns, self._conns = self._conns, []
        for sock in conns:
            with contextlib.suppress(OSError):
                sock.shutdown(socket.SHUT_RDWR)
            sock.close()


def fake_obs(pcfg, seed=0):
    return loadgen.synthetic_obs(pcfg, np.random.default_rng(seed))


def call(router, request, route=route_call):
    sock = socket.create_connection(router.address[:2], timeout=TIMEOUT_S)
    try:
        return route(sock, request, timeout=TIMEOUT_S)
    finally:
        sock.close()


def snap_of(reg):
    counters, gauges = reg.counters_and_gauges()
    return {**counters, **gauges}


@contextlib.contextmanager
def fake_fleet(n_backends=2, n_spares=0, jax_router=False, **serve):
    """Fake backends behind a router (the port's, or the JAX one)."""
    jcfg, pcfg = configs(**{"router_probe_s": 0.1, "router_dead_after_s": 0.4, **serve})
    backends = [FakeBackend() for _ in range(n_backends + n_spares)]
    reg = (jax_telemetry if jax_router else telemetry).Registry()
    cls = JaxSessionRouter if jax_router else SessionRouter
    router = cls(jcfg if jax_router else pcfg, [b.address for b in backends[:n_backends]],
                 spares=[b.address for b in backends[n_backends:]], registry=reg)
    try:
        assert wait_until(lambda: snap_of(reg).get("router/backends_live") == n_backends
                          and snap_of(reg).get("router/spares_available") == n_spares)
        yield pcfg, backends, reg, router
    finally:
        router.close()
        for b in backends:
            b.close()


# -- the client's failure budget (fake backend) ------------------------------------


def test_deadline_expiry_mid_window_is_typed_and_bounded():
    backend = FakeBackend("blackhole")
    _, pcfg = configs(request_deadline_s=0.6, request_retries=2)
    try:
        client = ServeClient(*backend.address, pcfg, timeout_s=5.0)
        try:
            t0 = time.monotonic()
            with pytest.raises(ServeDeadlineError):
                client.step(fake_obs(pcfg), reset=True)
            assert time.monotonic() - t0 < 3.0  # the budget and a backoff segment, not the socket timeout
        finally:
            client.close()
    finally:
        backend.close()


def test_retry_then_succeed_counts_the_discontinuity():
    """A dropped connection is retried on a fresh slot; the fresh slot's
    reset is sent explicitly and counted, and without a router it is no
    re-home."""
    backend = FakeBackend("close_first", close_first=1)
    _, pcfg = configs(request_deadline_s=10.0, request_retries=4)
    try:
        client = ServeClient(*backend.address, pcfg, timeout_s=5.0)
        try:
            actions = client.step(fake_obs(pcfg), reset=True)
            assert actions["action_type"] == 1 and np.array_equal(client.last_packed, FakeBackend.ROW)
            assert client.carry_resets == 1 and client.rehomed_count == 0
            assert client.last_dispatch_idx == 2 and client.slot == 1
        finally:
            client.close()
    finally:
        backend.close()


def test_retry_exhausted_raises_typed_error_with_bounded_attempts():
    backend = FakeBackend("close_first", close_first=100)
    _, pcfg = configs(request_deadline_s=30.0, request_retries=1)
    try:
        client = ServeClient(*backend.address, pcfg, timeout_s=5.0)
        try:
            with pytest.raises(ServeDeadlineError, match="2 attempt"):
                client.step(fake_obs(pcfg), reset=True)
            assert backend.requests_seen == 2
        finally:
            client.close()
    finally:
        backend.close()


# -- the router's control plane (fake backends) --------------------------------------


def test_router_attach_where_detach_status():
    with fake_fleet(n_backends=2) as (_, backends, reg, router):
        a = call(router, {"op": "attach"})
        b = call(router, {"op": "attach"})
        assert a["session"] != b["session"]
        assert {tuple(a["addr"]), tuple(b["addr"])} == {tuple(x.address) for x in backends}  # least loaded
        w = call(router, {"op": "where", "session": a["session"]})
        assert w["addr"] == a["addr"] and w["epoch"] == 0 and not w["rehomed"]
        assert len(call(router, {"op": "status"})["backends"]) == 2
        assert call(router, {"op": "detach", "session": a["session"]})["detached"]
        assert not call(router, {"op": "detach", "session": a["session"]})["detached"]
        assert call(router, {"op": "nonsense"}).get("error")
        assert call(router, {"op": "where", "session": 99}).get("error")
        snap = snap_of(reg)
        assert snap["router/sessions_attached_total"] == 2.0
        assert snap["router/sessions_detached_total"] == 1.0
        assert snap["router/sessions_active"] == 1.0
        assert snap["router/route_errors_total"] == 1.0
        assert snap["router/route_requests_total"] == 8.0


def test_router_death_promotes_spare_and_rehomes_sessions():
    with fake_fleet(n_backends=2, n_spares=1) as (_, backends, reg, router):
        sessions = [call(router, {"op": "attach"}) for _ in range(4)]
        dead_addr = list(backends[0].address)
        doomed = [s for s in sessions if s["addr"] == dead_addr]
        assert len(doomed) == 2
        backends[0].close()
        assert wait_until(lambda: snap_of(reg)["router/backends_dead"] == 1.0)
        snap = snap_of(reg)
        assert snap["router/spares_promoted_total"] == 1.0 and snap["router/spares_available"] == 0.0
        assert snap["router/backends_live"] == 2.0 and snap["router/backend_deaths_total"] == 1.0
        assert snap["router/sessions_rehomed_total"] == 2.0
        assert snap["router/carry_resets_total"] == 0.0  # the reference never counts it
        for s in doomed:
            w = call(router, {"op": "where", "session": s["session"]})
            assert w["addr"] != dead_addr and w["epoch"] == 1 and w["rehomed"]
        for s in sessions:
            if s not in doomed:  # survivors keep their home and epoch
                w = call(router, {"op": "where", "session": s["session"]})
                assert w["addr"] == s["addr"] and w["epoch"] == 0


def test_where_rehomes_a_session_stranded_while_no_backend_was_live():
    """B dies (its session moves to A), then A (both sessions stay parked:
    nowhere to go); when B comes back on its address, ``where`` moves each
    session onto it."""
    with fake_fleet(n_backends=2) as (_, backends, reg, router):
        s0, s1 = (call(router, {"op": "attach"}) for _ in range(2))
        assert [s0["addr"], s1["addr"]] == [list(b.address) for b in backends]
        b_port = backends[1].address[1]
        backends[1].close()
        assert wait_until(lambda: snap_of(reg)["router/backends_dead"] == 1.0)
        assert call(router, {"op": "where", "session": s1["session"]})["addr"] == s0["addr"]
        backends[0].close()
        assert wait_until(lambda: snap_of(reg)["router/backends_dead"] == 2.0)
        assert snap_of(reg)["router/sessions_rehomed_total"] == 1.0
        assert call(router, {"op": "where", "session": s0["session"]})["error"] == "no live backend"
        backends.append(FakeBackend(port=b_port))
        assert wait_until(lambda: snap_of(reg)["router/backends_live"] == 1.0)
        w0 = call(router, {"op": "where", "session": s0["session"]})
        w1 = call(router, {"op": "where", "session": s1["session"]})
        assert (w0["addr"], w0["epoch"], w0["rehomed"]) == (s1["addr"], 1, True)
        assert (w1["addr"], w1["epoch"]) == (s1["addr"], 2)
        assert snap_of(reg)["router/sessions_rehomed_total"] == 3.0


def test_control_lane_skips_other_kinds_and_counts_malformed_requests():
    with fake_fleet(n_backends=1) as (_, _, reg, router):
        sock = socket.create_connection(router.address[:2], timeout=TIMEOUT_S)
        try:
            _send_frame(sock, 2, b"")  # a heartbeat on the control lane: skipped
            _send_frame(sock, KIND_ROUTE_REQUEST, b"{not json")
            kind, payload = _recv_frame(sock)
            assert kind == KIND_ROUTE_REPLY and json.loads(bytes(payload)) == {"error": "malformed route request"}
            assert route_call(sock, {"op": "attach"})["session"] == 1  # the same connection goes on
        finally:
            sock.close()
        snap = snap_of(reg)
        assert snap["router/route_requests_total"] == 2.0 and snap["router/route_errors_total"] == 1.0


def test_router_status_names_each_backends_fleet_row():
    with fake_fleet(n_backends=1, n_spares=1) as (_, backends, _, router):
        status = call(router, {"op": "status"})
        assert [b["fleet_peer"] for b in status["backends"]] == [jax_peer_label("serve", b.address[1])
                                                                 for b in backends]
        assert [(b["live"], b["spare"]) for b in status["backends"]] == [(True, False), (True, True)]


@pytest.mark.parametrize("kind, peer_id", [("serve", 7788), ("actor", 0), ("serve", 65535)])
def test_peer_label_matches_the_reference(kind, peer_id):
    assert peer_label(kind, peer_id) == jax_peer_label(kind, peer_id)


def test_client_follows_router_redirect_after_backend_death():
    with fake_fleet(n_backends=2, request_deadline_s=10.0, request_retries=8) as (pcfg, backends, reg, router):
        client = ServeClient(*router.address[:2], pcfg, timeout_s=5.0, router=True)
        try:
            assert client.session == 1
            client.step(fake_obs(pcfg), reset=True)
            home = tuple(client.backend_addr)
            next(b for b in backends if tuple(b.address) == home).close()
            client.step(fake_obs(pcfg, seed=1))
            assert client.rehomed_count == 1 and client.last_rehomed
            assert tuple(client.backend_addr) != home
            assert client.carry_resets == 1  # default mode: an explicit, counted reset
        finally:
            client.close()
        assert wait_until(lambda: snap_of(reg)["router/sessions_detached_total"] == 1.0)
        assert snap_of(reg)["router/sessions_rehomed_total"] == 1.0


def test_heartbeat_frames_are_skipped_by_the_backend():
    """A router's probe frames (kind 2, empty payload) neither poison the
    connection nor count as requests; a request on the same connection is
    served."""
    jcfg, pcfg = configs(max_batch=1)
    pcfg = with_poison_limit(pcfg, 1)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=30, value_head=False))) as (reg, _, server):
        sock = socket.create_connection(server.address[:2], timeout=TIMEOUT_S)
        try:
            assert decode_rollout_bytes(_recv_frame(sock)[1])[0]["rollout_id"] == ATTACH_REQUEST_ID
            for _ in range(5):
                _send_frame(sock, 2, b"")
            row = stream(pcfg, 1, seed=300)[0]
            _send_frame(sock, KIND_SERVE_REQUEST, encode_rollout_bytes(
                {"obs": row, "reset": np.asarray(1.0, np.float32)}, model_version=0, env_id=0, rollout_id=1,
                length=1, total_reward=0.0))
            kind, payload = _recv_frame(sock)
            meta, arrays = decode_rollout_bytes(payload)
            assert kind == KIND_SERVE_REPLY and meta["rollout_id"] == 1 and is_legal(row, arrays["actions"])
        finally:
            sock.close()
        snap = reg.snapshot()
        assert snap["serve/requests_total"] == 1.0
        assert snap["transport/frames_corrupt_total"] == 0.0 and snap["transport/peers_quarantined"] == 0.0


# -- the port's router and the JAX one, op for op -------------------------------------


def op_sequence(jax_router):
    """attach x3, a backend death, where x3, detach, status; the replies
    with each address written as its backend's index, and the router's key
    family."""
    route = jax_route_call if jax_router else route_call
    with fake_fleet(n_backends=2, n_spares=1, jax_router=jax_router) as (_, backends, reg, router):
        index = {tuple(b.address): i for i, b in enumerate(backends)}
        replies = [call(router, {"op": "attach"}, route) for _ in range(3)]
        backends[0].close()
        assert wait_until(lambda: snap_of(reg)["router/backends_dead"] == 1.0)
        replies += [call(router, {"op": "where", "session": s}, route) for s in (1, 2, 3)]
        replies.append(call(router, {"op": "detach", "session": 2}, route))
        replies.append(call(router, {"op": "status"}, route))
        counters, gauges = reg.counters_and_gauges()

    def norm(reply):
        reply = dict(reply)
        if "addr" in reply:
            reply["addr"] = index[tuple(reply["addr"])]
        if "backends" in reply:
            reply["backends"] = [{**b, "addr": index[tuple(b["addr"])], "fleet_peer": None}
                                 for b in reply["backends"]]
        return reply

    return [norm(r) for r in replies], counters, gauges


def test_port_and_jax_routers_answer_one_op_sequence_alike():
    port, jax_ = op_sequence(False), op_sequence(True)
    assert port[0] == jax_[0]
    for ours, theirs in zip(port[1:], jax_[1:]):
        assert set(ours) == set(theirs)
        # the probe's reconnect count depends on timing; every other value is the op sequence's
        assert {k: v for k, v in ours.items() if k != "router/probe_reconnects_total"} == \
               {k: v for k, v in theirs.items() if k != "router/probe_reconnects_total"}
    assert port[1]["router/backend_deaths_total"] == 1.0 and port[1]["router/sessions_rehomed_total"] == 2.0


def test_router_jsonl_meets_the_reference_router_schema(tmp_path):
    with fake_fleet(n_backends=1, n_spares=1) as (_, _, reg, _):
        sink = telemetry.JsonlSink(str(tmp_path / "router.jsonl"))
        sink.emit(0, reg.snapshot())
        sink.emit_event({"event": "ALERT", "rule": "serve_peer_dead"})
        sink.close()
    lines = (tmp_path / "router.jsonl").read_text().splitlines()
    assert validate_lines(lines, extra_required=ROUTER_KEYS, base_required=()) == []


# -- real port backends on the CPU ------------------------------------------------------


def test_quarantine_reclaims_slot_and_recovery_is_not_a_rehome():
    """A quarantined client reconnects through the router onto a fresh slot
    of the same live backend: a counted carry reset, not a re-home."""
    jcfg, pcfg = configs(max_batch=1, max_slots=2, **FLEET)
    pcfg = with_poison_limit(pcfg, 1)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=31, value_head=False))) as (reg, _, server):
        rreg = telemetry.Registry()
        router = SessionRouter(pcfg, [server.address[:2]], registry=rreg)
        try:
            assert wait_until(lambda: snap_of(rreg)["router/backends_live"] == 1.0)
            client = ServeClient(*router.address[:2], pcfg, timeout_s=TIMEOUT_S, router=True)
            try:
                client.step(stream(pcfg, 1, seed=310)[0], reset=True)
                client._sock.sendall(b"\xde\xad\xbe\xef" * 4)  # a corrupt header: quarantined at once
                assert wait_until(lambda: reg.snapshot()["transport/peers_quarantined"] == 1.0)
                client.step(stream(pcfg, 1, seed=311)[0])
                assert client.carry_resets == 1 and client.rehomed_count == 0
                assert reg.snapshot()["serve/slots_in_use"] == 2.0  # the probe and this client
            finally:
                client.close()
        finally:
            router.close()


def test_rehome_on_real_backend_death_default_mode():
    """Shadow off: the session re-homes onto the promoted spare and resumes
    on a zeroed carry, counted, with the JAX policy's log-probs on each side
    of the boundary."""
    jcfg, pcfg = configs(max_batch=1, **FLEET)
    jparams = flax_params(jcfg, seed=32, value_head=False)
    rows, kill_at = stream(pcfg, 6, seed=320), 3
    with port_stack(pcfg, convert(jparams)) as (_, engine_a, server_a), \
            port_stack(pcfg, convert(jparams)) as (reg_b, _, server_b):
        rreg = telemetry.Registry()
        router = SessionRouter(pcfg, [server_a.address[:2]], spares=[server_b.address[:2]], registry=rreg)
        try:
            assert wait_until(lambda: snap_of(rreg)["router/backends_live"] == 1.0
                              and snap_of(rreg)["router/spares_available"] == 1.0)
            client = ServeClient(*router.address[:2], pcfg, timeout_s=TIMEOUT_S, router=True)
            served = []
            try:
                for t, row in enumerate(rows):
                    if t == kill_at:
                        server_a.close()
                        engine_a.stop()
                    client.step(row, reset=t == 0)
                    served.append((client.last_packed.copy(), client.last_logp))
                assert client.rehomed_count == 1 and client.carry_resets == 1
                assert tuple(client.backend_addr) == tuple(server_b.address[:2])
            finally:
                client.close()
            snap = snap_of(rreg)
            assert snap["router/spares_promoted_total"] == 1.0 and snap["router/backend_deaths_total"] == 1.0
            assert reg_b.snapshot()["serve/carry_installs_total"] == 0.0
        finally:
            router.close()
    actions = [p for p, _ in served]
    want = np.concatenate([jax_logps_over_stream(jcfg, jparams, rows[:kill_at], actions[:kill_at]),
                           jax_logps_over_stream(jcfg, jparams, rows[kill_at:], actions[kill_at:])])
    np.testing.assert_allclose([lp for _, lp in served], want, rtol=0, atol=ATOL)


def test_rehome_parity_digest_is_bitwise():
    digest = loadgen.run_rehome_parity(seed=0, device="cpu")
    assert digest["parity"] == "bitwise", digest
    assert digest["teeth"] is True and digest["mismatches"] == 0 and digest["steps"] == 20
    assert digest["rehomed_sessions"] == 1 and digest["rehomed_to_spare"] is True
    assert digest["router_sessions_rehomed"] == 1 and digest["router_backend_deaths"] == 1


def test_loadgen_cli_rehome_parity_and_its_router_snapshot(tmp_path, capsys):
    path = str(tmp_path / "router.jsonl")
    assert loadgen.main(["--rehome-parity", "--device", "cpu", "--seed", "3", "--metrics-jsonl", path]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["parity"] == "bitwise"
    lines = open(path).read().splitlines()
    assert len(lines) == 1 and validate_lines(lines, extra_required=ROUTER_KEYS, base_required=()) == []


def test_synthetic_obs_matches_the_reference():
    from scripts.serve_loadgen import synthetic_obs as jax_synthetic_obs

    jcfg, pcfg = configs()
    ours, theirs = loadgen.synthetic_obs(pcfg, np.random.default_rng(5)), jax_synthetic_obs(jcfg, np.random.default_rng(5))
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_loadgen_through_the_router():
    jcfg, pcfg = configs(max_batch=4, **FLEET)
    params = convert(flax_params(jcfg, seed=33, value_head=False))
    with port_stack(pcfg, params) as (reg_a, _, server_a), port_stack(pcfg, params) as (reg_b, _, server_b):
        rreg = telemetry.Registry()
        router = SessionRouter(pcfg, [server_a.address[:2], server_b.address[:2]], registry=rreg)
        try:
            assert wait_until(lambda: snap_of(rreg)["router/backends_live"] == 2.0)
            out = loadgen.run_loadgen(*router.address[:2], pcfg, n_clients=4, requests_per_client=3, router=True)
        finally:
            router.close()
        assert out["replies"] == 12 and out["errors"] == 0 and out["sessions_rehomed"] == 0
        # least-loaded attach spread the four games two and two
        assert reg_a.snapshot()["serve/requests_total"] == reg_b.snapshot()["serve/requests_total"] == 6.0
        assert snap_of(rreg)["router/sessions_detached_total"] == 4.0


# -- interop across a backend kill --------------------------------------------------------


def run_games_across_a_kill(make_client, homes, kill, rows, kill_at):
    """One fleet-mode game per stream of ``rows`` through one router, game g
    homed on ``homes[g]``; after ``kill_at`` steps the first game's backend
    is killed. Returns each game's served (packed, logp) stream and each
    client's (rehomed_count, backend_addr) at the end."""
    clients = [make_client() for _ in rows]
    try:
        assert [tuple(c.backend_addr) for c in clients] == list(homes)
        served = [[] for _ in rows]
        for t in range(len(rows[0])):
            if t == kill_at:
                kill()
            for g, c in enumerate(clients):
                c.step(rows[g][t], reset=t == 0)
                served[g].append((np.array(c.last_packed, copy=True), c.last_logp))
        return served, [(c.rehomed_count, tuple(c.backend_addr)) for c in clients]
    finally:
        for c in clients:
            c.close()


def check_against_the_jax_policy(jcfg, jparams, rows, served):
    for g in range(len(rows)):
        actions = [p for p, _ in served[g]]
        assert all(is_legal(r, p) for r, p in zip(rows[g], actions))
        want = jax_logps_over_stream(jcfg, jparams, rows[g], actions)  # the carry goes on across the kill
        np.testing.assert_allclose([lp for _, lp in served[g]], want, rtol=0, atol=ATOL)


def test_jax_client_rehomes_through_the_port_router_onto_port_backends():
    """Two games, one on each live backend; the first one's backend dies
    and the game resumes on the promoted spare from its shadowed carry."""
    jcfg, pcfg = configs(max_batch=1, carry_shadow=True, **FLEET)
    jparams = flax_params(jcfg, seed=34, value_head=False)
    rows, kill_at = [stream(pcfg, 5, seed=340 + g) for g in range(2)], 2
    with contextlib.ExitStack() as stack:
        stacks = [stack.enter_context(port_stack(pcfg, convert(jparams))) for _ in range(3)]
        addrs = [tuple(s.address[:2]) for _, _, s in stacks]
        rreg = telemetry.Registry()
        router = SessionRouter(pcfg, addrs[:2], spares=[addrs[2]], registry=rreg)
        stack.callback(router.close)
        assert wait_until(lambda: snap_of(rreg)["router/backends_live"] == 2.0
                          and snap_of(rreg)["router/spares_available"] == 1.0)

        def kill():
            stacks[0][2].close()
            stacks[0][1].stop()

        served, finals = run_games_across_a_kill(
            lambda: JaxServeClient(*router.address[:2], jcfg, timeout_s=TIMEOUT_S, router=True),
            addrs[:2], kill, rows, kill_at)
        assert stacks[2][0].snapshot()["serve/carry_installs_total"] == 1.0
    assert finals == [(1, addrs[2]), (0, addrs[1])]
    check_against_the_jax_policy(jcfg, jparams, rows, served)


def test_port_client_rehomes_through_the_jax_router_onto_jax_backends():
    """One game on a JAX backend with a JAX spare; the backend dies and the
    game resumes on the spare from its shadowed carry."""
    jcfg, pcfg = configs(max_batch=1, carry_shadow=True, **FLEET)
    jparams = flax_params(jcfg, seed=35, value_head=False)
    rows, kill_at = [stream(pcfg, 5, seed=350)], 2
    policy = jax_inference_policy(jcfg)
    regs = [jax_telemetry.Registry() for _ in range(2)]
    engines = [JaxServeEngine(jcfg, policy, jparams, registry=r) for r in regs]
    servers = [JaxPolicyServer(e, jcfg, port=0, registry=r) for e, r in zip(engines, regs)]
    addrs = [tuple(s.address[:2]) for s in servers]
    rreg = jax_telemetry.Registry()
    router = JaxSessionRouter(jcfg, [addrs[0]], spares=[addrs[1]], registry=rreg)
    try:
        assert wait_until(lambda: snap_of(rreg)["router/backends_live"] == 1.0
                          and snap_of(rreg)["router/spares_available"] == 1.0)

        def kill():
            servers[0].close()
            engines[0].stop()

        served, finals = run_games_across_a_kill(
            lambda: ServeClient(*router.address[:2], pcfg, timeout_s=TIMEOUT_S, router=True),
            addrs[:1], kill, rows, kill_at)
    finally:
        router.close()
        for s, e in zip(servers, engines):
            s.close()
            e.stop()
    assert finals == [(1, addrs[1])]
    assert snap_of(rreg)["router/sessions_rehomed_total"] == 1.0
    assert regs[1].snapshot()["serve/carry_installs_total"] == 1.0
    check_against_the_jax_policy(jcfg, jparams, rows, served)


# -- the alert engine ----------------------------------------------------------------------


def test_alert_rules_are_the_references():
    assert [dataclasses.asdict(r) for r in alerts.RULES] == [dataclasses.asdict(r) for r in jax_alerts.RULES]
    names = [r.name for r in alerts.RULES]
    assert "serve_peer_dead" in names and "sessions_rehomed_burst" in names


def test_alert_engine_rejects_a_rule_without_a_runbook_anchor():
    with pytest.raises(ValueError, match="runbook"):
        alerts.AlertEngine(rules=(alerts.AlertRule("x", key="k", kind="threshold", value=1.0),),
                           registry=telemetry.Registry())


def snapshot_stream(seed, n=120):
    """A seeded stream of (now, snapshot) over every rule's key (two keys
    for each pattern): monotone counters with jumps and an occasional reset,
    levels around each threshold, now and then a key missing."""
    rng = np.random.default_rng(seed)
    keys = []
    for rule in alerts.RULES:
        if "*" in rule.key:
            keys += [(rule, rule.key.replace("*", p)) for p in ("s1", "s2")]
        else:
            keys.append((rule, rule.key))
    counters = {k: 0.0 for _, k in keys}
    now, out = 1000.0, []
    for _ in range(n):
        now += float(rng.choice([0.5, 2.0, 7.0, 20.0, 70.0]))
        snap = {}
        for rule, k in keys:
            if rng.random() < 0.1:
                continue
            if rule.kind == "rate":
                if rng.random() < 0.05:
                    counters[k] = 0.0
                counters[k] += float(rng.choice([0.0, 0.0, 1.0, 5.0, 40.0]))
                snap[k] = counters[k]
            elif rule.kind == "stale":
                counters[k] += float(rng.random() < 0.2)
                snap[k] = counters[k]
            else:
                snap[k] = float(rule.value + rng.choice([-1.0, 0.0, 1.0]) * max(abs(rule.value), 1.0) * rng.random())
        out.append((now, snap))
    return out


def run_engine(module, reg_module, stream_):
    reg, events = reg_module.Registry(), []
    engine = module.AlertEngine(registry=reg, emit=events.append)
    ticks = [engine.evaluate(snap, now=now) for now, snap in stream_]
    return ticks, events, reg.counters_and_gauges(), engine.active_rules()


@pytest.mark.parametrize("seed", range(4))
def test_alert_engines_fire_and_resolve_alike(seed):
    stream_ = snapshot_stream(seed)
    ours = run_engine(alerts, telemetry, stream_)
    theirs = run_engine(jax_alerts, jax_telemetry, stream_)
    assert ours == theirs
    assert any(fired for fired, _ in ours[0]) and any(resolved for _, resolved in ours[0])


def test_alert_engine_pages_a_dead_serve_peer():
    """The router's own registry: ``serve_peer_dead`` fires on the first
    snapshot with a dead backend and resolves when none is; the re-home
    counter's rise warns."""
    stream_ = [(0.0, {"router/backends_dead": 0.0, "router/sessions_rehomed_total": 0.0}),
               (1.0, {"router/backends_dead": 1.0, "router/sessions_rehomed_total": 16.0}),
               (2.0, {"router/backends_dead": 0.0, "router/sessions_rehomed_total": 16.0})]
    ticks, events, (counters, gauges), active = run_engine(alerts, telemetry, stream_)
    assert ticks == [([], []), (["serve_peer_dead", "sessions_rehomed_burst"], []), ([], ["serve_peer_dead"])]
    assert [(e["rule"], e["state"], e["severity"], e["runbook"]) for e in events] == [
        ("serve_peer_dead", "fired", "page", "rb:serve-peer-dead"),
        ("sessions_rehomed_burst", "fired", "warn", "rb:sessions-rehomed"),
        ("serve_peer_dead", "resolved", "page", "rb:serve-peer-dead")]
    assert counters == {"alerts/fired_total": 2.0, "alerts/resolved_total": 1.0}
    assert gauges == {"alerts/active": 1.0} and active == ["sessions_rehomed_burst"]
    assert run_engine(jax_alerts, jax_telemetry, stream_)[:2] == (ticks, events)


def test_counters_gauges_and_event_lines_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    lines = []
    for name, mod in (("port", telemetry), ("jax", jax_telemetry)):
        reg = mod.Registry()
        reg.counter("router/backend_deaths_total").inc()
        reg.counter("router/sessions_rehomed_total").inc(16)
        reg.gauge("router/backends_dead").set(1)
        reg.timer("span/x").observe(0.5)  # timers stay out
        sink = mod.JsonlSink(str(tmp_path / f"{name}.jsonl"))
        counters, gauges = reg.counters_and_gauges()
        sink.emit(3, {**counters, **gauges})
        sink.emit_event({"event": "ALERT", "rule": "serve_peer_dead", "value": 1.0, "state": "fired"})
        sink.close()
        lines.append(((tmp_path / f"{name}.jsonl").read_text(), counters, gauges))
    assert lines[0] == lines[1]
    assert json.loads(lines[0][0].splitlines()[1]) == {"ts": 1234.5, "event": "ALERT", "rule": "serve_peer_dead",
                                                      "value": 1.0, "state": "fired"}


# -- the router CLI ---------------------------------------------------------------------


def test_router_cli_pages_a_dead_backend_in_its_jsonl(tmp_path):
    """The router CLI on a thread over fake backends: a backend dies, its
    JSONL gets the page, and a KeyboardInterrupt (what SIGINT raises) ends
    it with its totals line."""
    backends = [FakeBackend() for _ in range(3)]
    path = tmp_path / "router.jsonl"
    out, result = Lines(), {}
    tel = telemetry.get_registry()
    before = {k: tel.counter(k).value for k in ("router/backend_deaths_total", "router/sessions_rehomed_total")}

    def run():
        with contextlib.redirect_stdout(out):
            result["rc"] = router_cli.main([
                "--backends", ",".join(f"{h}:{p}" for h, p in (b.address for b in backends[:2])),
                "--spares", "%s:%d" % backends[2].address, "--metrics-jsonl", str(path),
                "--serve", "router_probe_s=0.1,router_dead_after_s=0.4", "--interval", "0.1"])

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        assert wait_until(lambda: any(l.startswith("ROUTER_LISTENING ") for l in out.lines()))
        addr = json.loads(next(l for l in out.lines() if l.startswith("ROUTER_LISTENING "))[len("ROUTER_LISTENING "):])

        class Addr:
            address = (addr["host"], addr["port"])

        assert wait_until(lambda: sum(b["live"] for b in call(Addr, {"op": "status"})["backends"]) == 3)
        homes = [call(Addr, {"op": "attach"})["addr"] for _ in range(3)]
        backends[0].close()

        def alerts_in_jsonl():
            return [json.loads(l) for l in path.read_text().splitlines() if '"event"' in l] if path.exists() else []

        assert wait_until(lambda: any(e["rule"] == "serve_peer_dead" for e in alerts_in_jsonl()))
    finally:
        # raised in the CLI's thread at its next bytecode, as SIGINT raises it in a main thread
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(thread.ident), ctypes.py_object(KeyboardInterrupt))
        thread.join(TIMEOUT_S)
        for b in backends:
            b.close()
    assert not thread.is_alive() and result["rc"] == 0
    final = json.loads(out.lines()[-1])
    assert final["router_backend_deaths"] - before["router/backend_deaths_total"] == 1.0
    doomed = homes.count(list(backends[0].address))
    assert doomed == 2 and final["router_sessions_rehomed"] - before["router/sessions_rehomed_total"] == doomed
    fired = [e for e in alerts_in_jsonl() if e["state"] == "fired"]
    assert {"serve_peer_dead", "sessions_rehomed_burst"} <= {e["rule"] for e in fired}
    lines = path.read_text().splitlines()
    assert validate_lines(lines, extra_required=ROUTER_KEYS, base_required=()) == []

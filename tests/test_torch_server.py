"""The port's socket serving lane, on the CPU, held against the JAX package.

Cross-talk both ways: a JAX ``ServeClient`` is served by the port's
``PolicyServer``, and the port's ``ServeClient`` by a JAX one. The port
server's reply log-probs equal the JAX policy's log-prob of the replied
actions over each game's own observation stream (Flax params, the port
holding ``convert`` of them, f32 compute, atol 1e-5). The rest mirrors the
socket-lane cases of ``tests/test_serve.py`` on the port: the two restore
sources agree bitwise, slots are reclaimed fresh after a disconnect and a
quarantine, a skewed request poisons its connection only, weights frames
from a JAX publisher swap in, a request that is never answered ends in
``ServeDeadlineError`` inside its budget, and the serve CLI runs on the CPU
only when asked. Every socket has a timeout and every server is closed in
``finally``.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.models import distributions as JD
from dotaclient_tpu.serve import PolicyServer as JaxPolicyServer
from dotaclient_tpu.serve import ServeClient as JaxServeClient
from dotaclient_tpu.serve import ServeEngine as JaxServeEngine
from dotaclient_tpu.serve import make_inference_policy as jax_inference_policy
from dotaclient_tpu.transport.serialize import encode_weights as jax_encode_weights
from dotaclient_tpu.transport.socket_transport import TransportServer as JaxTransportServer
from dotaclient_tpu.utils import telemetry as jax_telemetry
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models import distributions as PD
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.serve import (
    PolicyServer,
    ServeClient,
    ServeDeadlineError,
    ServeEngine,
    load_inference_params,
    make_inference_policy,
    slice_train_params,
    weights_frame_to_params,
)
from dotaclient_tpu_torch.serve import __main__ as serve_cli
from dotaclient_tpu_torch.serve.server import ATTACH_REQUEST_ID, KIND_SERVE_REPLY, KIND_SERVE_REQUEST, encode_reply
from dotaclient_tpu_torch.train.ppo import init_train_state
from dotaclient_tpu_torch.transport.serialize import encode_rollout_bytes, frame_crc32
from dotaclient_tpu_torch.transport.shm_transport import ShmTransportServer
from dotaclient_tpu_torch.transport.socket_transport import SocketTransport, _send_frame
from dotaclient_tpu_torch.utils import telemetry
from dotaclient_tpu_torch.utils import tracing as ptracing
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_common import flax_params, jax_policy, obs_row, random_obs, tiny_configs

ATOL = 1e-5
TIMEOUT_S = 10.0


def configs(**serve):
    base = dict(max_batch=2, batch_window_ms=0.0, max_slots=4, request_deadline_s=TIMEOUT_S)
    return tiny_configs(**{**base, **serve})


def with_poison_limit(cfg, n):
    return dataclasses.replace(cfg, transport=dataclasses.replace(cfg.transport, poison_frame_limit=n))


def wait_until(pred, timeout=TIMEOUT_S):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.01)
    return pred()


def is_legal(obs, packed):
    """Legal under the masks (an all-illegal row samples as all-legal)."""
    a_type, move_x, move_y, target, ability = (int(v) for v in packed)

    def ok(mask, i):
        mask = np.asarray(mask)
        return 0 <= i < mask.size and (mask[i] or not mask.any())

    if not ok(obs["mask_action_type"], a_type) or not (0 <= move_x < 9 and 0 <= move_y < 9):
        return False
    if a_type in (2, 3) and not ok(obs["mask_cast_target" if a_type == 3 else "mask_target_unit"], target):
        return False
    return a_type != 3 or ok(obs["mask_ability"], ability)


@contextlib.contextmanager
def port_stack(pcfg, params, registry=None, version=0):
    reg = registry if registry is not None else telemetry.Registry()
    engine = ServeEngine(pcfg, make_inference_policy(pcfg, device="cpu"), params, version=version,
                         registry=reg, device="cpu")
    server = PolicyServer(engine, pcfg, port=0, registry=reg)
    try:
        yield reg, engine, server
    finally:
        server.close()
        engine.stop()


def stream(pcfg, n, seed):
    obs = random_obs(pcfg, (n,), seed=seed)
    return [obs_row(obs, i) for i in range(n)]


def jax_logps_over_stream(jcfg, jparams, rows, actions):
    """The JAX policy's joint log-prob of each replied action, stepping one
    game through its own stream from a zero carry."""
    policy, jstep, _ = jax_policy(jcfg, value_head=False)
    carry = jax.tree.map(jnp.asarray, policy.initial_state(1))
    out = []
    for row, packed in zip(rows, actions):
        ob = {k: jnp.asarray(np.asarray(v)[None]) for k, v in row.items()}
        logits, _, carry = jstep(jparams, ob, carry)
        acts = {h: jnp.asarray([int(packed[i])]) for i, h in enumerate(JD.HEADS)}
        out.append(float(JD.log_prob(logits, ob, acts)[0]))
    return np.asarray(out)


# -- cross-talk ---------------------------------------------------------------------


def test_jax_client_is_served_by_the_port_server_with_jax_logps():
    jcfg, pcfg = configs()
    jparams = flax_params(jcfg, seed=1, value_head=False)
    games, steps = 2, 4
    rows = [stream(pcfg, steps, seed=10 + g) for g in range(games)]
    with port_stack(pcfg, convert(jparams), version=3) as (reg, _, server):
        clients = [JaxServeClient(*server.address, jcfg, timeout_s=TIMEOUT_S) for _ in range(games)]
        try:
            assert sorted(c.slot for c in clients) == [0, 1]
            served = [[], []]
            for t in range(steps):
                for g, c in enumerate(clients):
                    c.step(rows[g][t], reset=t == 0)
                    assert c.last_version == 3
                    served[g].append((c.last_packed.copy(), c.last_logp))
        finally:
            for c in clients:
                c.close()
        assert reg.snapshot()["serve/dispatch_errors_total"] == 0.0
    for g in range(games):
        assert all(is_legal(row, packed) for row, (packed, _) in zip(rows[g], served[g]))
        want = jax_logps_over_stream(jcfg, jparams, rows[g], [p for p, _ in served[g]])
        np.testing.assert_allclose([lp for _, lp in served[g]], want, rtol=0, atol=ATOL)


def test_port_client_is_served_by_a_jax_server():
    jcfg, pcfg = configs()
    jparams = flax_params(jcfg, seed=2, value_head=False)
    reg = jax_telemetry.Registry()
    engine = JaxServeEngine(jcfg, jax_inference_policy(jcfg), jparams, version=5, registry=reg)
    server = JaxPolicyServer(engine, jcfg, port=0, registry=reg)
    rows = stream(pcfg, 3, seed=20)
    try:
        client = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        try:
            assert client.slot == 0 and client.last_version == 5
            actions = []
            for t, row in enumerate(rows):
                acts = client.step(row, reset=t == 0)
                assert list(acts) == list(PD.HEADS) and client.last_version == 5
                assert is_legal(row, client.last_packed)
                actions.append(client.last_packed.copy())
            want = jax_logps_over_stream(jcfg, jparams, rows, actions)
            assert client.last_logp == pytest.approx(want[-1], abs=ATOL)
        finally:
            client.close()
    finally:
        server.close()
        engine.stop()


def test_bf16_request_wire_is_served():
    """The narrowed request wire decodes, upcasts and serves like f32."""
    jcfg, pcfg = configs(request_wire_dtype="bfloat16")
    with port_stack(pcfg, convert(flax_params(jcfg, seed=3, value_head=False))) as (reg, _, server):
        for cls, cfg in ((ServeClient, pcfg), (JaxServeClient, jcfg)):
            client = cls(*server.address, cfg, timeout_s=TIMEOUT_S)
            try:
                row = stream(pcfg, 1, seed=30)[0]
                client.step(row, reset=True)
                assert is_legal(row, client.last_packed)
            finally:
                client.close()
        assert reg.snapshot()["serve/replies_total"] == 2.0


# -- restore sources -------------------------------------------------------------------


def save_checkpoint(pcfg, jparams, directory, step=7):
    policy = Policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    policy.load_state_dict(convert(jparams))
    state = init_train_state(policy, pcfg.ppo)
    state.step, state.version = step, step
    mgr = CheckpointManager(directory, registry=telemetry.Registry())
    assert mgr.save(state, pcfg, force=True)
    mgr.wait()   # the write lands after save returns


def test_checkpoint_and_weights_frame_restore_agree_bitwise(tmp_path):
    jcfg, pcfg = configs()
    jparams = flax_params(jcfg, seed=4)
    save_checkpoint(pcfg, jparams, str(tmp_path / "ckpt"))
    ck_cfg, ck_params, ck_step = load_inference_params(str(tmp_path / "ckpt"))
    assert ck_cfg == pcfg and ck_step == 7
    fr_version, fr_params = weights_frame_to_params(jax_encode_weights(jparams, version=9))
    assert fr_version == 9
    assert set(ck_params) == set(fr_params) and not any(k.startswith("head_value") for k in ck_params)
    for k in ck_params:
        assert torch.equal(ck_params[k], fr_params[k]), k
    engine = ServeEngine(pcfg, make_inference_policy(pcfg, device="cpu"), ck_params,
                         registry=telemetry.Registry(), device="cpu")
    try:
        row = stream(pcfg, 1, seed=40)[0]
        a = engine.reference_step([row], [0], [1.0], engine.initial_carries(), 0)
        b = engine.reference_step([row], [0], [1.0], engine.initial_carries(), 0, params=fr_params)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    finally:
        engine.stop()


# -- slots, poison, quarantine ------------------------------------------------------


def test_slot_reuse_after_disconnect_starts_fresh():
    jcfg, pcfg = configs(max_batch=1, max_slots=2)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=5, value_head=False))) as (reg, engine, server):
        warm, probe = stream(pcfg, 2, seed=50)
        a = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        assert a.slot == 0
        a.step(warm, reset=True)  # drive slot 0's carry off zero
        a.step(warm)
        a.close()
        assert wait_until(lambda: server.n_connected == 0)
        b = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        try:
            assert b.slot == 0  # the lowest free slot: reclaimed
            idx = int(reg.snapshot()["serve/dispatches_total"])
            b.step(probe, reset=False)  # only the release's zeroing makes it fresh
            fresh = engine.reference_step([probe], [0], [0.0], engine.initial_carries(), idx)
            np.testing.assert_array_equal(fresh[0][0], b.last_packed)
            assert float(fresh[1][0]) == b.last_logp
            # teeth: from the old game's carry the same request differs
            carries = engine.initial_carries()
            for i, z in enumerate((1.0, 0.0)):
                _, _, carries = engine.reference_step([warm], [0], [z], carries, i)
            stale = engine.reference_step([probe], [0], [0.0], carries, idx)
            assert float(stale[1][0]) != b.last_logp
        finally:
            b.close()


def test_concurrent_attach_and_detach_keep_the_slot_pool_whole():
    """More clients than slots attach and detach at once, with the thread
    switch interval shortened: every slot comes back to the pool exactly
    once."""
    jcfg, pcfg = configs(max_slots=3, request_deadline_s=2.0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with port_stack(pcfg, convert(flax_params(jcfg, seed=6, value_head=False))) as (reg, _, server):
            attached = []

            def churn():
                for _ in range(5):
                    try:
                        client = ServeClient(*server.address, pcfg, timeout_s=2.0, max_reconnects=1)
                    except (ConnectionError, OSError):
                        continue  # shed: every slot was taken
                    attached.append(client.slot)
                    client.close()

            threads = [threading.Thread(target=churn, daemon=True) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT_S)
            assert not any(t.is_alive() for t in threads)
            assert wait_until(lambda: server.n_connected == 0)
            assert sorted(server._free_slots) == [0, 1, 2]
            assert set(attached) <= {0, 1, 2} and len(attached) + reg.snapshot()["serve/conns_rejected_total"] == 60
            assert reg.snapshot()["serve/slots_in_use"] == 0.0
    finally:
        sys.setswitchinterval(switch)


def test_slots_exhausted_rejects_the_joiner():
    jcfg, pcfg = configs(max_slots=1, request_deadline_s=2.0)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=6, value_head=False))) as (reg, _, server):
        a = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        try:
            with pytest.raises((ConnectionError, OSError)):
                ServeClient(*server.address, pcfg, timeout_s=2.0, max_reconnects=1)
            assert reg.snapshot()["serve/conns_rejected_total"] == 1.0
            assert reg.snapshot()["serve/slots_in_use"] == 1.0
        finally:
            a.close()


def test_quarantined_client_slot_reclaimed():
    jcfg, pcfg = configs(max_batch=1, max_slots=1)
    pcfg = with_poison_limit(pcfg, 2)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=7, value_head=False))) as (reg, _, server):
        a = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        payload = b"not a rollout"
        for _ in range(2):
            _send_frame(a._sock, KIND_SERVE_REQUEST, payload, crc=frame_crc32(payload) ^ 0xDEADBEEF)
        assert wait_until(lambda: server.n_connected == 0)
        snap = reg.snapshot()
        assert snap["transport/frames_corrupt_total"] == 2.0
        assert snap["transport/peers_quarantined"] == 1.0
        a.close()
        b = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        try:
            assert b.slot == 0
            row = stream(pcfg, 1, seed=70)[0]
            b.step(row, reset=True)
            assert is_legal(row, b.last_packed)
        finally:
            b.close()


def test_shape_skewed_request_poisons_not_crashes():
    jcfg, pcfg = configs()
    pcfg = with_poison_limit(pcfg, 2)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=8, value_head=False))) as (reg, _, server):
        skewed = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        good = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        try:
            bad = stream(pcfg, 1, seed=80)[0]
            bad["units"] = np.zeros((64, 7), np.float32)  # another ObsSpec
            payload = encode_rollout_bytes({"obs": bad, "reset": np.asarray(1.0, np.float32)},
                                           model_version=0, env_id=skewed.slot, rollout_id=1, length=1,
                                           total_reward=0.0)
            for _ in range(2):
                _send_frame(skewed._sock, KIND_SERVE_REQUEST, payload)
            assert wait_until(lambda: server.n_connected == 1)
            snap = reg.snapshot()
            assert snap["transport/peers_quarantined"] == 1.0
            assert snap["serve/dispatch_errors_total"] == 0.0  # never dispatched
            good.step(stream(pcfg, 1, seed=81)[0], reset=True)
            assert reg.snapshot()["serve/replies_total"] == 1.0
        finally:
            good.close()
            skewed.close()


def test_request_carrying_a_trace_entry_is_served():
    jcfg, pcfg = configs()
    with port_stack(pcfg, convert(flax_params(jcfg, seed=9, value_head=False))) as (reg, _, server):
        sock = socket.create_connection(server.address, timeout=TIMEOUT_S)
        try:
            from dotaclient_tpu_torch.transport.socket_transport import _recv_frame
            from dotaclient_tpu_torch.transport.serialize import decode_rollout_bytes

            assert decode_rollout_bytes(_recv_frame(sock)[1])[0]["rollout_id"] == ATTACH_REQUEST_ID
            row = stream(pcfg, 1, seed=90)[0]
            _send_frame(sock, KIND_SERVE_REQUEST, encode_rollout_bytes(
                {"obs": row, "reset": np.asarray(1.0, np.float32)}, model_version=0, env_id=0, rollout_id=5,
                length=1, total_reward=0.0, trace=b"\x01" * 32))
            kind, payload = _recv_frame(sock)
            meta, arrays = decode_rollout_bytes(payload)
            assert kind == KIND_SERVE_REPLY and meta["rollout_id"] == 5 and "trace_blob" not in meta
            assert is_legal(row, arrays["actions"])
        finally:
            sock.close()


# -- bounded failure ----------------------------------------------------------------


def test_deadline_error_against_a_server_that_never_replies():
    """The server attaches every connection and then stays silent: step()
    raises ServeDeadlineError within its budget."""
    _, pcfg = configs(request_deadline_s=0.6, request_retries=2)
    listener = socket.create_server(("127.0.0.1", 0))
    listener.settimeout(0.2)
    stop = threading.Event()
    held = []

    def accept():
        while not stop.is_set():
            try:
                sock, _ = listener.accept()
            except OSError:
                continue
            held.append(sock)
            _send_frame(sock, KIND_SERVE_REPLY, encode_reply(np.zeros(5, np.int32), 0.0, 0, 0, ATTACH_REQUEST_ID))

    thread = threading.Thread(target=accept, daemon=True)
    thread.start()
    try:
        client = ServeClient(*listener.getsockname(), pcfg, timeout_s=TIMEOUT_S)
        try:
            t0 = time.monotonic()
            with pytest.raises(ServeDeadlineError):
                client.step(stream(pcfg, 1, seed=100)[0], reset=True)
            assert time.monotonic() - t0 < 0.6 + 0.5
        finally:
            client.close()
    finally:
        stop.set()
        thread.join(TIMEOUT_S)
        listener.close()
        for s in held:
            s.close()


def test_carry_shadow_resend_resumes_the_game_after_a_reconnect():
    """The lane drops mid-game: the client reconnects onto a fresh slot and
    resends the carry row of its last reply, so the game's log-probs go on
    from the JAX policy's over its own stream, not from a reset."""
    jcfg, pcfg = configs(max_batch=1, carry_shadow=True)
    jparams = flax_params(jcfg, seed=18, value_head=False)
    rows, drop_at = stream(pcfg, 5, seed=180), 3
    with port_stack(pcfg, convert(jparams)) as (reg, _, server):
        client = ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S)
        try:
            served = []
            for t, row in enumerate(rows):
                if t == drop_at:
                    client._sock.shutdown(socket.SHUT_RDWR)
                client.step(row, reset=t == 0)
                served.append((client.last_packed.copy(), client.last_logp))
        finally:
            client.close()
        assert reg.snapshot()["serve/carry_installs_total"] == 1.0
    actions = [p for p, _ in served]
    want = jax_logps_over_stream(jcfg, jparams, rows, actions)
    np.testing.assert_allclose([lp for _, lp in served], want, rtol=0, atol=ATOL)
    # teeth: the same step from a reset carry reads otherwise
    reset = jax_logps_over_stream(jcfg, jparams, rows[drop_at:], actions[drop_at:])
    assert abs(reset[0] - want[drop_at]) > 100 * ATOL


def test_connect_with_backoff_retries_counts_and_stops():
    """Failed attempts are retried and counted until one succeeds; the
    schedule ends at ``max_attempts`` or when ``should_abort`` trips."""
    from dotaclient_tpu_torch.actor.backoff import connect_with_backoff

    def flaky(fails):
        calls = []

        def factory():
            calls.append(1)
            if len(calls) <= fails:
                raise ConnectionRefusedError("down")
            return len(calls)

        return factory

    tel = telemetry.get_registry()
    before = tel.snapshot().get("transport/reconnects_total", 0.0)
    assert connect_with_backoff(flaky(2), max_attempts=3, base_delay=0.01, max_delay=0.02) == 3
    assert tel.snapshot()["transport/reconnects_total"] == before + 2
    with pytest.raises(ConnectionError, match="after 3 attempts") as err:
        connect_with_backoff(flaky(3), max_attempts=3, base_delay=0.01, max_delay=0.02)
    assert isinstance(err.value.__cause__, ConnectionRefusedError)
    with pytest.raises(ConnectionError, match="stop requested"):
        connect_with_backoff(flaky(0), should_abort=lambda: True)


def test_connect_with_backoff_takes_the_callers_sleep_and_rng():
    """The caller's ``sleep`` and ``rng`` (the actor CLI seeds one from
    ``--seed``): the same seeded schedule in both packages, each retry k a
    draw from (0, min(max_delay, base_delay * 2^(k-1))]."""
    import random

    from dotaclient_tpu.actor.__main__ import connect_with_backoff as jax_backoff
    from dotaclient_tpu_torch.actor.backoff import connect_with_backoff

    def flaky(fails):
        calls = []

        def factory():
            calls.append(1)
            if len(calls) <= fails:
                raise ConnectionRefusedError("down")
            return len(calls)

        return factory

    slept = {}
    for name, fn in (("port", connect_with_backoff), ("jax", jax_backoff)):
        slept[name] = []
        assert fn(flaky(4), max_attempts=5, base_delay=0.5, max_delay=1.5, sleep=slept[name].append,
                  rng=random.Random(7)) == 5
    want_rng = random.Random(7)
    assert slept["port"] == slept["jax"] == [want_rng.uniform(0.0, d) for d in (0.5, 1.0, 1.5, 1.5)]


@contextlib.contextmanager
def hanging_up_server():
    """Attaches every connection, then closes it on its first request: each
    attempt of a step fails at once. Yields (address, connections seen)."""
    from dotaclient_tpu_torch.transport.socket_transport import _recv_frame

    listener = socket.create_server(("127.0.0.1", 0))
    listener.settimeout(0.2)
    stop = threading.Event()
    seen = [0]

    def serve():
        while not stop.is_set():
            try:
                sock, _ = listener.accept()
            except OSError:
                continue
            seen[0] += 1
            with sock:
                _send_frame(sock, KIND_SERVE_REPLY, encode_reply(np.zeros(5, np.int32), 0.0, 0, 0, ATTACH_REQUEST_ID))
                sock.settimeout(TIMEOUT_S)
                try:
                    _recv_frame(sock)
                except OSError:
                    pass

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    try:
        yield listener.getsockname(), seen
    finally:
        stop.set()
        thread.join(TIMEOUT_S)
        listener.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_serve_client_counts_retries_and_stops_on_the_callers_hook(package):
    """``retries_total`` counts every failed attempt: request_retries + 1
    of them before the deadline error. The caller's stop hook ends the
    step between attempts with a ConnectionError, the retries left unspent;
    the JAX client does the same."""
    from dotaclient_tpu.serve.client import ServeDeadlineError as JaxServeDeadlineError

    jcfg, pcfg = configs(request_deadline_s=5.0, request_retries=3)
    cls, cfg, deadline_error = ((ServeClient, pcfg, ServeDeadlineError) if package == "port"
                                else (JaxServeClient, jcfg, JaxServeDeadlineError))
    row = stream(pcfg, 1, seed=101)[0]
    with hanging_up_server() as (addr, seen):
        client = cls(*addr, cfg, timeout_s=TIMEOUT_S)
        try:
            with pytest.raises(deadline_error, match="after 4 attempt"):
                client.step(row, reset=True)
            assert client.retries_total == 4 and seen[0] == 4
        finally:
            client.close()
        n0 = seen[0]
        client = cls(*addr, cfg, timeout_s=TIMEOUT_S, should_abort=lambda: seen[0] >= n0 + 2)
        try:
            t0 = time.monotonic()
            with pytest.raises(ConnectionError, match="stop requested") as err:
                client.step(row, reset=True)
            assert not isinstance(err.value, deadline_error) and time.monotonic() - t0 < 5.0
            assert client.retries_total == 1 and seen[0] == n0 + 2
        finally:
            client.close()


def test_router_mode_is_not_ported():
    """``router=True`` needs a router: pointed at a plain backend, which
    skips route frames, the attach fails with a ConnectionError inside its
    budget, and the backend counts neither a request nor a corrupt frame."""
    jcfg, pcfg = configs(request_deadline_s=0.6)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=6, value_head=False))) as (reg, _, server):
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            ServeClient(*server.address, pcfg, timeout_s=TIMEOUT_S, router=True)
        assert time.monotonic() - t0 < 0.6 + 0.5
        snap = reg.snapshot()
        assert snap["serve/requests_total"] == 0.0 and snap["transport/frames_corrupt_total"] == 0.0


# -- weights subscription ------------------------------------------------------------


def test_weights_subscription_slices_and_swaps_a_jax_frame():
    jcfg, pcfg = configs(weights_poll_s=0.02)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=11, value_head=False))) as (reg, engine, server):
        class StubFanout:
            msg = None

            def latest_weights(self):
                return self.msg

        source = StubFanout()
        server.attach_weights_source(source)
        new = flax_params(jcfg, seed=12)  # a training tree, value head included
        source.msg = jax_encode_weights(new, version=9)
        assert wait_until(lambda: engine.version == 9)
        snap = reg.snapshot()
        assert snap["serve/weights_version"] == 9.0 and snap["serve/weight_swaps_total"] == 1.0
        want = slice_train_params(convert(new))
        assert all(torch.equal(engine._params[k], want[k]) for k in want)
        source.msg = jax_encode_weights(flax_params(jcfg, seed=13), version=4)  # older: never applied
        time.sleep(0.1)
        assert engine.version == 9


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_socket_transport_receives_a_jax_publish_and_the_server_swaps(wire):
    jcfg, pcfg = configs(weights_poll_s=0.02)
    publisher = JaxTransportServer(port=0, heartbeat_interval_s=0.2)
    try:
        with port_stack(pcfg, convert(flax_params(jcfg, seed=14, value_head=False))) as (reg, engine, server):
            transport = SocketTransport(*publisher.address, timeout=TIMEOUT_S, idle_timeout_s=TIMEOUT_S)
            try:
                server.attach_weights_source(transport)
                new = flax_params(jcfg, seed=15)
                assert wait_until(lambda: publisher.n_connected == 1)
                publisher.publish_weights(jax_encode_weights(new, version=21, wire_dtype=wire))
                assert wait_until(lambda: engine.version == 21)
                got = transport.latest_weights()
                assert got.version == 21
                assert all(torch.equal(engine._params[k], v) for k, v in weights_frame_to_params(got)[1].items())
            finally:
                transport.close()
    finally:
        publisher.close()


# -- the serve CLI ----------------------------------------------------------------------


class Lines(io.TextIOBase):
    """A thread-safe stdout that keeps what was printed."""

    def __init__(self):
        self.lock = threading.Lock()
        self.text = ""

    def write(self, s):
        with self.lock:
            self.text += s
        return len(s)

    def lines(self):
        with self.lock:
            return self.text.splitlines()


def test_serve_cli_serves_a_checkpoint_on_the_cpu(tmp_path):
    jcfg, pcfg = configs()
    save_checkpoint(pcfg, flax_params(jcfg, seed=16), str(tmp_path / "ckpt"), step=12)
    out = Lines()
    result = {}

    def run():
        with contextlib.redirect_stdout(out):
            result["rc"] = serve_cli.main(["--checkpoint", str(tmp_path / "ckpt"), "--device", "cpu",
                                           "--serve", "max_batch=1", "--duration", "2",
                                           "--serve-metrics-jsonl", str(tmp_path / "serve.jsonl")])

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert wait_until(lambda: any(l.startswith("SERVE_LISTENING ") for l in out.lines()))
    addr = json.loads(next(l for l in out.lines() if l.startswith("SERVE_LISTENING "))[len("SERVE_LISTENING "):])
    assert [l.split()[1] for l in out.lines()[:3]] == ["warm-up", "listening", '{"host":']
    client = ServeClient(addr["host"], addr["port"], pcfg, timeout_s=TIMEOUT_S)
    try:
        for t, row in enumerate(stream(pcfg, 3, seed=160)):
            client.step(row, reset=t == 0)
            assert client.last_version == 12 and is_legal(row, client.last_packed)
    finally:
        client.close()
    thread.join(TIMEOUT_S)
    assert not thread.is_alive() and result["rc"] == 0
    final = json.loads(out.lines()[-1])
    assert final["serve_weights_version"] == 12.0 and final["serve_requests_total"] >= 3.0
    assert set(final) == {"serve_requests_total", "serve_dispatches_total", "serve_p99_latency_ms",
                          "serve_weights_version", "lstm_seq_launches", "native_decodes", "native_encodes",
                          "proto_fallbacks"}
    # the requests and replies ran the native codec (the client's in this
    # process too)
    assert final["native_decodes"] >= 3 and final["native_encodes"] >= 3 and final["proto_fallbacks"] == 0
    assert final["lstm_seq_launches"] == 0  # CPU tensors take the plain version
    snaps = [json.loads(l) for l in (tmp_path / "serve.jsonl").read_text().splitlines()]
    assert snaps and snaps[-1]["scalars"]["serve/weights_version"] == 12.0


def test_warm_up_dispatch_moves_no_counter_or_carry():
    """The CLI's warm-up dispatch before SERVE_LISTENING leaves the first
    real dispatch exactly as it would be without it."""
    jcfg, pcfg = configs()
    params = convert(flax_params(jcfg, seed=19, value_head=False))
    reg = telemetry.Registry()
    engine = ServeEngine(pcfg, make_inference_policy(pcfg, device="cpu"), params, registry=reg, device="cpu")
    try:
        store = [c.clone() for c in engine._carries]
        assert engine.warm_up() > 0.0
        assert all(torch.equal(a[:-1], b[:-1]) for a, b in zip(engine._carries, store))  # the scratch row aside
        snap = reg.snapshot()
        assert snap["serve/dispatches_total"] == 0.0 and snap["serve/requests_total"] == 0.0
        row = stream(pcfg, 1, seed=190)[0]
        got = []
        engine.submit(1, row, True, lambda *reply, **_: got.append(reply))
        assert wait_until(lambda: got)
        want = engine.reference_step([row], [1], [1.0], engine.initial_carries(), 0)
        np.testing.assert_array_equal(got[0][0], want[0][0])
        assert got[0][1] == float(want[1][0]) and got[0][4] == 0  # dispatch index 0
    finally:
        engine.stop()


def test_serve_cli_refuses_what_is_not_there(tmp_path, monkeypatch):
    jcfg, pcfg = configs()
    save_checkpoint(pcfg, flax_params(jcfg, seed=17), str(tmp_path / "ckpt"))
    ck = ["--checkpoint", str(tmp_path / "ckpt")]
    # (--fleet-interval is ported: tests/test_torch_external.py drives it)
    # --trace-jsonl and --trace-sample are ported: they reach
    # tracing.configure, and its shutdown at exit (tests/test_torch_tracing.py
    # serves traced requests)
    traced = []
    monkeypatch.setattr(ptracing, "configure", lambda path, sample_n=None, registry=None: traced.append(
        (path, sample_n)))
    # --subscribe shm:// is ported: the CLI applies the version a learner's
    # shm lane publishes
    lane = ShmTransportServer(name=f"t-serve-{os.getpid()}", slots=2, ring_bytes=1 << 14, weights_bytes=1 << 22)
    try:
        lane.publish_weights(jax_encode_weights(flax_params(jcfg, seed=18), version=21))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert serve_cli.main(ck + ["--device", "cpu", "--subscribe", f"shm://{lane.address}",
                                        "--duration", "1.5", "--trace-jsonl", "t.jsonl", "--trace-sample", "3"]) == 0
        assert json.loads(out.getvalue().splitlines()[-1])["serve_weights_version"] == 21.0
        assert lane.n_connected == 0   # the subscriber's slot released at exit
    finally:
        lane.close()
    assert traced == [("t.jsonl", 3), (None, None)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(ck)

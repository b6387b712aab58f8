"""The port's same-host shared-memory lane, held against the JAX package's.

Mirrors ``tests/test_shm_transport.py`` on the port: the SPSC ring (FIFO,
wraparound, drop-newest when full, the deferred release that keeps drained
views intact), the seqlocked weights slab (latest wins, the cached parse,
the size check), slot claims, releases and reaping, the liveness beacon,
a restart over a dead learner's segments, and the metrics frames and CRC
quarantine shared with the socket lane. The slab carries a bf16 weights
frame (the narrow wire) byte for byte, and the actor widens it on decode
(``test_slab_carries_the_bf16_weights_frame``). Across packages, the
segment layout is the wire contract: a JAX ``ShmTransport`` feeds a port
server and a port actor a JAX server, with the same payload bytes and ring
counters both ways, and the weights slab read across too. The learner CLI
with ``--transport shm`` is in ``tests/test_torch_external.py``.

Everything runs in one process: a same-process attach shares the creator's
resource-tracker entry, so the cross-package cases add the lane's names to
the attaching package's set of names this process created.
"""

import os
import struct

import numpy as np
import pytest

from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu.transport import shm_transport as JS
from dotaclient_tpu_torch.transport import ShmTransport, ShmTransportServer
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.transport import shm_transport as PS
from dotaclient_tpu_torch.utils import faults, telemetry


def lane_name(tag: str) -> str:
    return f"t-pshm-{os.getpid()}-{tag}"


def make_lane(tag, slots=2, ring_bytes=1 << 16, weights_bytes=1 << 20, **kw):
    reg = telemetry.Registry()
    server = ShmTransportServer(name=lane_name(tag), slots=slots, ring_bytes=ring_bytes,
                                weights_bytes=weights_bytes, registry=reg, **kw)
    actor = ShmTransport(lane_name(tag), slots=slots, registry=reg)
    return server, actor, reg


def tiny_rollout(rid=0, n=16):
    return S.encode_rollout({"rewards": np.arange(n, dtype=np.float32) + rid}, model_version=0, env_id=0,
                            rollout_id=rid, length=n, total_reward=0.0)


def lane_files(name):
    return sorted(f for f in os.listdir("/dev/shm") if f.startswith(name))


# -- the rollout ring ----------------------------------------------------------------------------------------


def test_fifo_exactly_once():
    server, actor, reg = make_lane("fifo")
    try:
        for i in range(7):
            actor.publish_rollout(tiny_rollout(i))
        got = server.consume_rollouts(64, timeout=1.0)
        assert [r.rollout_id for r in got] == list(range(7))
        assert server.consume_rollouts(64, timeout=0.01) == []
        assert reg.snapshot()["transport/experience_published"] == 7.0
    finally:
        actor.close()
        server.close()
    assert lane_files(lane_name("fifo")) == []


def test_wraparound_many_laps():
    """Frames survive the ring edge: several ring sizes of data through a
    16 KiB ring, drained between bursts."""
    server, actor, _ = make_lane("wrap", ring_bytes=1 << 14)
    try:
        sent = 0
        received = []
        for _ in range(40):
            for _ in range(3):
                assert actor.publish_rollout_bytes(tiny_rollout(sent, n=200).SerializeToString())
                sent += 1
            received.extend(server.consume_rollouts(16, timeout=1.0))
        received.extend(server.consume_rollouts(16, timeout=0.2))
        assert [r.rollout_id for r in received] == list(range(sent))
    finally:
        actor.close()
        server.close()


def test_drop_newest_when_full_is_counted():
    server, actor, reg = make_lane("full", ring_bytes=1 << 12)
    try:
        wire = tiny_rollout(0, n=200).SerializeToString()
        sent = sum(1 for _ in range(20) if actor.publish_rollout_bytes(wire))
        assert 0 < sent < 20
        assert server.pending_rollouts == sent
        assert reg.snapshot()["transport/experience_dropped"] == 20 - sent
        assert len(server.consume_rollouts(64, timeout=1.0)) == sent
        server.consume_rollouts(1, timeout=0.01)   # releases the previous drain's space
        assert actor.publish_rollout_bytes(wire)
        server._publish_ring_telemetry()
        assert reg.snapshot()["shm/ring_dropped_total"] == 20 - sent
    finally:
        actor.close()
        server.close()


def test_deferred_release_protects_inflight_views():
    """Frames handed out by a drain stay intact while the producer keeps
    writing: their space is released only at the next drain."""
    server, actor, _ = make_lane("views", ring_bytes=1 << 14)
    try:
        wire = bytes(tiny_rollout(1, n=500).SerializeToString())
        n_fit = 0
        while actor.publish_rollout_bytes(wire):
            n_fit += 1
        views = server._drain(n_fit, timeout=1.0)
        assert len(views) == n_fit
        assert not actor.publish_rollout_bytes(wire)
        assert all(bytes(v) == wire for _ts, v in views)
    finally:
        actor.close()
        server.close()


def test_consume_decoded_roundtrip_and_byte_accounting():
    server, actor, reg = make_lane("dec", ring_bytes=1 << 20)
    try:
        tree = {"obs": {"units": np.random.default_rng(0).normal(size=(9, 8, 4)).astype(np.float32)},
                "rewards": np.arange(8, dtype=np.float32)}
        blob = S.encode_rollout_bytes(tree, 5, 0, 77, 8, 1.25)
        actor.publish_rollout_bytes(blob)
        actor.publish_rollout_bytes(b"\xff\xff not a rollout")
        out = server.consume_decoded(8, timeout=1.0)
        assert len(out) == 1 and server.bad_payloads == 1
        meta, arrays = out[0]
        assert meta["model_version"] == 5 and meta["rollout_id"] == 77
        np.testing.assert_array_equal(arrays["obs"]["units"], tree["obs"]["units"])
        np.testing.assert_array_equal(arrays["rewards"], tree["rewards"])
        snap = reg.snapshot()
        assert snap["transport/rollout_bytes_total"] == snap["transport/rollout_raw_bytes_total"] == len(blob)
        assert snap["transport/malformed_payloads_total"] == 1.0
    finally:
        actor.close()
        server.close()


def test_corrupt_frames_are_dropped_then_quarantine_the_slot():
    """The CRC quarantine shared with the socket lane: a frame with a bad
    trailer is dropped and counted, ``poison_frame_limit`` in a row
    quarantine the slot; a good frame between resets the streak."""
    server, actor, reg = make_lane("poison", poison_frame_limit=3)
    faults.configure("transport.corrupt_frame@1")
    try:
        actor._faults = faults.get()
        actor.publish_rollout(tiny_rollout(0))        # corrupted
        actor._faults = None
        actor.publish_rollout(tiny_rollout(1))        # good: the streak resets
        assert [r.rollout_id for r in server.consume_rollouts(8, timeout=0.5)] == [1]
        assert reg.snapshot()["transport/frames_corrupt_total"] == 1.0
        for i in range(3):   # three bad trailers in a row
            payload = tiny_rollout(10 + i).SerializeToString()
            actor._faults = type("F", (), {"value": lambda self, s: 0.0, "fire": lambda self, s: True})()
            actor.publish_rollout_bytes(payload)
        actor._faults = None
        actor.publish_rollout(tiny_rollout(20))
        assert server.consume_rollouts(8, timeout=0.2) == []
        snap = reg.snapshot()
        assert snap["transport/frames_corrupt_total"] == 4.0 and snap["transport/peers_quarantined"] == 1.0
    finally:
        faults.configure(None)
        actor.close()
        server.close()


def test_implausible_length_word_resyncs_the_ring():
    server, actor, reg = make_lane("resync")
    try:
        actor.publish_rollout(tiny_rollout(0))
        struct.pack_into("<I", actor._mv, PS._RING_HDR, 0x7FFFFFF0)   # the first frame's length word
        assert server.consume_rollouts(8, timeout=0.1) == []
        assert reg.snapshot()["transport/frames_corrupt_total"] == 1.0
        actor.publish_rollout(tiny_rollout(1))
        assert [r.rollout_id for r in server.consume_rollouts(8, timeout=1.0)] == [1]
    finally:
        actor.close()
        server.close()


def test_metrics_frames_go_to_the_handler_not_the_consume_path():
    server, actor, _ = make_lane("metrics")
    got = []
    server.metrics_handler = got.append
    try:
        assert actor.publish_metrics_bytes(b"snapshot-1")
        actor.publish_rollout(tiny_rollout(3))
        assert [r.rollout_id for r in server.consume_rollouts(8, timeout=1.0)] == [3]
        assert got == [b"snapshot-1"]
    finally:
        actor.close()
        server.close()


# -- the weights slab ------------------------------------------------------------------------------------------


def test_latest_wins_and_cache():
    server, actor, reg = make_lane("w")
    try:
        assert actor.latest_weights() is None
        for v in (1, 2, 3):
            server.publish_weights(S.encode_weights({"w": np.full(4, float(v), np.float32)}, v))
        msg = actor.latest_weights()
        assert msg.version == 3 and actor.latest_weights() is msg
        assert server.latest_weights().version == 3
        assert reg.snapshot()["transport/weights_published"] == 3.0
    finally:
        actor.close()
        server.close()


def test_slab_carries_the_bf16_weights_frame():
    """A bf16 weights frame crosses the slab byte for byte, its CRC
    checked, and the actor's decode widens it to the params rounded to
    bf16."""
    server, actor, _ = make_lane("wb")
    params = {"k": np.linspace(0, 1, 9, dtype=np.float32), "n": np.arange(3, dtype=np.int32)}
    try:
        frame = S.encode_weights(params, 4, wire_dtype="bfloat16")
        server.publish_weights(frame)
        msg = actor.latest_weights()
        # a map's entries serialize in hash order unless asked for a canonical one
        assert msg.version == 4 and msg.SerializeToString(deterministic=True) == frame.SerializeToString(
            deterministic=True)
        version, tree = S.decode_weights(msg)
        assert version == 4 and tree["k"].dtype == np.float32
        np.testing.assert_array_equal(tree["k"], S.bf16_bits_to_f32(S.f32_to_bf16_bits(params["k"])))
        np.testing.assert_array_equal(tree["n"], params["n"])
    finally:
        actor.close()
        server.close()


def test_attach_to_a_segment_not_yet_sized_is_refused_like_a_connect():
    """A segment its server has opened and not yet sized is a refused
    connect (the actor's backoff retries it), not a crash of the actor."""
    import _posixshmem

    name = f"t-unsized-{os.getpid()}"
    fd = _posixshmem.shm_open("/" + name, os.O_CREAT | os.O_EXCL | os.O_RDWR, mode=0o600)
    try:
        with pytest.raises(ConnectionError, match="not sized yet"):
            PS._attach(name)
    finally:
        os.close(fd)
        _posixshmem.shm_unlink("/" + name)


def test_oversized_weights_rejected():
    server, actor, _ = make_lane("wo", weights_bytes=1 << 10)
    try:
        with pytest.raises(ValueError, match="shm_weights_bytes"):
            server.publish_weights(S.encode_weights({"w": np.zeros(4096, np.float32)}, 1))
    finally:
        actor.close()
        server.close()


def test_corrupt_slab_is_counted_once_and_the_last_good_kept():
    server, actor, reg = make_lane("wc")
    try:
        server.publish_weights(S.encode_weights({"w": np.ones(4, np.float32)}, 1))
        good = actor.latest_weights()
        server.publish_weights(S.encode_weights({"w": np.ones(4, np.float32)}, 2))
        server._weights.buf[PS._SLAB_HDR + 4] ^= 0xFF   # flip a payload byte under a stable seq
        assert actor.latest_weights() is good and actor.latest_weights() is good
        assert reg.snapshot()["transport/frames_corrupt_total"] == 1.0
    finally:
        actor.close()
        server.close()


# -- slots ---------------------------------------------------------------------------------------------------


def test_two_actors_distinct_slots_and_release():
    server = ShmTransportServer(name=lane_name("claim"), slots=2, ring_bytes=1 << 14)
    try:
        a1 = ShmTransport(lane_name("claim"), slots=2)
        a2 = ShmTransport(lane_name("claim"), slots=2)
        assert {a1.slot, a2.slot} == {0, 1} and server.n_connected == 2
        with pytest.raises(ConnectionError, match="no free shm"):
            ShmTransport(lane_name("claim"), slots=2)
        a1.close()
        assert server.n_connected == 1
        a3 = ShmTransport(lane_name("claim"), slots=2)
        assert a3.slot == a1.slot
        a2.close()
        a3.close()
    finally:
        server.close()
    assert lane_files(lane_name("claim")) == []


def test_actor_detects_dead_learner():
    server, actor, _ = make_lane("alive")
    try:
        dead_pid = 2 ** 22 + 54321
        assert not PS._pid_alive(dead_pid)
        struct.pack_into("<Q", server._weights.buf, PS._OFF_SERVER_PID, dead_pid)
        actor._last_liveness = -1e9
        with pytest.raises(ConnectionError, match="learner process"):
            actor.latest_weights()
        actor._last_liveness = -1e9
        with pytest.raises(ConnectionError, match="learner process"):
            actor.publish_rollout_bytes(b"x" * 64)
    finally:
        actor.close()
        server.close()


def test_attach_to_dead_lane_raises():
    server = ShmTransportServer(name=lane_name("dead"), slots=1, ring_bytes=1 << 14)
    try:
        struct.pack_into("<Q", server._weights.buf, PS._OFF_SERVER_PID, 2 ** 22 + 99991)
        with pytest.raises(ConnectionError, match="learner process"):
            ShmTransport(lane_name("dead"), slots=1)
    finally:
        server.close()


def test_server_restart_reclaims_stale_lane():
    name = lane_name("restart")
    old = ShmTransportServer(name=name, slots=1, ring_bytes=1 << 14)
    struct.pack_into("<Q", old._weights.buf, PS._OFF_SERVER_PID, 2 ** 22 + 77777)
    # the crash: the segments stay, close() never runs
    PS._OWNED_BY_THIS_PROCESS.discard(f"{name}-w")
    PS._OWNED_BY_THIS_PROCESS.discard(f"{name}-r0")
    new = ShmTransportServer(name=name, slots=1, ring_bytes=1 << 14)
    try:
        actor = ShmTransport(name, slots=1)
        actor.publish_rollout(tiny_rollout(5))
        assert [r.rollout_id for r in new.consume_rollouts(4, timeout=1.0)] == [5]
        actor.close()
    finally:
        new.close()
    live = ShmTransportServer(name=name, slots=1, ring_bytes=1 << 14)
    try:
        with pytest.raises(FileExistsError, match="live learner"):
            ShmTransportServer(name=name, slots=1, ring_bytes=1 << 14)
    finally:
        live.close()


def test_crashed_actor_slot_is_reaped():
    reg = telemetry.Registry()
    server = ShmTransportServer(name=lane_name("reap"), slots=1, ring_bytes=1 << 14, registry=reg)
    try:
        actor = ShmTransport(lane_name("reap"), slots=1)
        struct.pack_into("<Q", server._rings[0].buf, PS._OFF_CLAIM, 2 ** 22 + 12345)
        actor._ring = None   # the crashed actor never unlocks
        with pytest.raises(ConnectionError):
            ShmTransport(lane_name("reap"), slots=1)
        server._publish_ring_telemetry()
        assert server.n_connected == 0 and reg.snapshot()["shm/slots_reaped"] == 1.0
        revived = ShmTransport(lane_name("reap"), slots=1)
        assert revived.slot == 0
        revived.close()
        actor._weights_shm.close()
    finally:
        server.close()


def test_both_claimed_rings_are_drained():
    server = ShmTransportServer(name=lane_name("multi"), slots=2, ring_bytes=1 << 16)
    try:
        a1 = ShmTransport(lane_name("multi"), slots=2)
        a2 = ShmTransport(lane_name("multi"), slots=2)
        for i in range(4):
            a1.publish_rollout(tiny_rollout(i))
            a2.publish_rollout(tiny_rollout(100 + i))
        got = server.consume_rollouts(64, timeout=1.0)
        assert sorted(r.rollout_id for r in got) == sorted(list(range(4)) + list(range(100, 104)))
        a1.close()
        a2.close()
    finally:
        server.close()


# -- across packages ---------------------------------------------------------------------------------------------


def lane_pair(server_mod, actor_mod, tag, ring_bytes=1 << 12):
    name = lane_name(tag)
    server = server_mod.ShmTransportServer(name=name, slots=2, ring_bytes=ring_bytes, weights_bytes=1 << 16)
    # the same process created these segments (see the module docstring)
    actor_mod._OWNED_BY_THIS_PROCESS.update({f"{name}-w", f"{name}-r0", f"{name}-r1"})
    actor = actor_mod.ShmTransport(name, slots=2)
    return name, server, actor


def run_lane(server_mod, actor_mod, tag):
    """The same frames through a 4 KiB ring (some dropped when full), one
    drain; returns (the drained payloads, the ring's header words, the
    weights read back)."""
    name, server, actor = lane_pair(server_mod, actor_mod, tag)
    try:
        for i in range(12):
            actor.publish_rollout_bytes(J.encode_rollout({"rewards": np.arange(100, dtype=np.float32) + i},
                                                         model_version=i, env_id=0, rollout_id=i, length=100,
                                                         total_reward=float(i)).SerializeToString())
        header = [struct.unpack_from("<Q", server._rings[actor.slot].buf, off)[0] for off in (8, 16, 24, 32)]
        drained = [bytes(v) for _ts, v in server._drain(64, timeout=1.0)]
        server.publish_weights(J.encode_weights({"w": np.arange(6, dtype=np.float32)}, 7))
        msg = actor.latest_weights()
        return drained, header[:3], header[3] == os.getpid(), msg.SerializeToString()
    finally:
        actor.close()
        server.close()
        actor_mod._OWNED_BY_THIS_PROCESS.difference_update({f"{name}-w", f"{name}-r0", f"{name}-r1"})


@pytest.mark.parametrize("direction", ["jax actor into a port server", "port actor into a jax server"])
def test_lanes_interoperate_with_the_jax_package(direction):
    want = run_lane(JS, JS, "jj")
    got = run_lane(PS, JS, "pj") if direction.startswith("jax") else run_lane(JS, PS, "jp")
    drained, header, claimed, weights = got
    assert drained == want[0] and 0 < len(drained) < 12   # the same frames kept, the same dropped
    assert header == want[1] and header[2] == 12 - len(drained)   # tail, frames, dropped words
    assert claimed and want[2]
    assert weights == want[3]
    version, tree = S.decode_weights(S.pb.ModelWeights.FromString(weights))
    assert version == 7 and np.array_equal(tree["w"], np.arange(6, dtype=np.float32))
    for i, payload in enumerate(drained):
        meta, arrays = S.decode_rollout_bytes(payload)
        assert meta["rollout_id"] == i and np.array_equal(arrays["rewards"], np.arange(100, dtype=np.float32) + i)


def test_a_jax_actor_feeds_the_port_learners_ingest():
    """A port learner in external mode on a port lane, fed by a JAX actor's
    frames: its ring ingests them with the wire byte accounting."""
    import dataclasses

    from dotaclient_tpu_torch.train import learner as plearner
    from tests.test_torch_buffered import buffered_configs, chunk
    from tests.test_torch_external import rows_of

    _, cfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    cfg = dataclasses.replace(cfg, learner=dataclasses.replace(cfg.learner, async_snapshots=False))
    reg = telemetry.Registry()
    name = lane_name("learner")
    server = ShmTransportServer(name=name, slots=2, ring_bytes=1 << 20, weights_bytes=1 << 22, registry=reg)
    JS._OWNED_BY_THIS_PROCESS.update({f"{name}-w", f"{name}-r0", f"{name}-r1"})
    try:
        learner = plearner.Learner(cfg, actor="external", device="cpu", registry=reg, transport=server)
        actor = JS.ShmTransport(name, slots=2)
        for meta, arrays in rows_of(chunk(cfg, 8, 31), [0] * 8):
            assert actor.publish_rollout_bytes(J.encode_rollout(arrays, **meta).SerializeToString())
        out = learner.train(2, refresh_every=1)
        assert out["optimizer_steps"] == 2.0 and learner.buffer.ingested == 8
        snap = reg.snapshot()
        assert snap["transport/rollout_bytes_total"] > 0 and snap["transport/weights_published"] == 4.0
        version, _ = J.decode_weights(actor.latest_weights())   # the JAX actor reads the port's slab
        assert version == 2
        actor.close()
        learner.close()
    finally:
        server.close()
        JS._OWNED_BY_THIS_PROCESS.difference_update({f"{name}-w", f"{name}-r0", f"{name}-r1"})
    assert lane_files(name) == []

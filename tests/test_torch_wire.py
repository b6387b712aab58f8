"""The port's wire codec and framing, held byte for byte against the JAX
package's.

The two packages register the same protobuf descriptor (the port's
``dota_pb2.py`` is a byte-identical copy), so their message classes are the
same objects and a test tells them apart only by the bytes they write. The
bf16 casts, done without ``ml_dtypes`` in the port, are held bitwise against
``ml_dtypes`` here.
"""

import pathlib
import re
import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from dotaclient_tpu.serve.client import serve_request_wire_kwargs as jax_wire_kwargs
from dotaclient_tpu.serve.server import encode_reply as jax_encode_reply
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu.transport import socket_transport as JT
from dotaclient_tpu_torch.serve import weights_frame_to_params
from dotaclient_tpu_torch.serve.client import serve_request_wire_kwargs
from dotaclient_tpu_torch.serve.server import encode_reply
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.transport import socket_transport as T
from tests.test_torch_common import flax_params, obs_row, random_obs, tiny_configs

BF16 = np.dtype(ml_dtypes.bfloat16)
SOCK_TIMEOUT_S = 10.0


def leaf_np(a):
    """A decoded leaf as numpy (a port bf16 tensor as ml_dtypes bf16)."""
    if isinstance(a, torch.Tensor):
        return S.bf16_tensor_to_bits(a).view(BF16)
    return np.asarray(a)


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
        return
    g, w = leaf_np(got), leaf_np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
    assert g.tobytes() == w.tobytes(), path


# -- bf16 without ml_dtypes ---------------------------------------------------------


def special_f32():
    """Normals, both zeros and infinities, NaNs with payloads and signs,
    subnormals, the largest finite value, and exact round-to-even ties."""
    rng = np.random.default_rng(0)
    bits = np.array([
        0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7FC00001,
        0xFFA00000, 0x7F800001, 0x00000001, 0x80000001, 0x00018000, 0x00008000, 0x00028000,
        0x007FFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F808000, 0x3F818000, 0x3F80C000, 0x7F7F8000,
    ], np.uint32)
    return np.concatenate([bits.view(np.float32), rng.normal(size=4096).astype(np.float32) * 10 ** rng.integers(
        -30, 30, size=4096).astype(np.float32), rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(
        np.uint32).view(np.float32)])


def test_f32_to_bf16_bitwise_against_ml_dtypes():
    x = special_f32()
    with np.errstate(invalid="ignore", over="ignore"):
        want = x.astype(BF16).view(np.uint16)
    np.testing.assert_array_equal(S.f32_to_bf16_bits(x), want)


def test_bf16_to_f32_bitwise_against_ml_dtypes():
    bits = np.arange(2 ** 16, dtype=np.uint32).astype(np.uint16)
    want = bits.view(BF16).astype(np.float32).view(np.uint32)
    np.testing.assert_array_equal(S.bf16_bits_to_f32(bits).view(np.uint32), want)


def test_no_port_module_imports_ml_dtypes():
    root = pathlib.Path(S.__file__).resolve().parents[1]
    offenders = [
        f"{p}:{i}" for p in root.rglob("*.py") for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.match(r"\s*(import|from)\s+ml_dtypes\b", line)
    ]
    assert not offenders, offenders


# -- framing --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 4099, 1_000_003])
def test_frame_crc32_matches_jax(n):
    payload = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    assert S.frame_crc32(payload) == J.frame_crc32(payload)
    view = memoryview(payload)
    for lo, hi in ((0, n), (min(3, n), n), (0, max(0, n - 5)), (n // 3, n - n // 7)):
        assert S.frame_crc32(view[lo:hi]) == J.frame_crc32(view[lo:hi]) == J.frame_crc32(payload[lo:hi])


def socket_bytes(send):
    """Every byte ``send(sock)`` writes, read on a thread as it goes."""
    a, b = socket.socketpair()
    a.settimeout(SOCK_TIMEOUT_S)
    b.settimeout(SOCK_TIMEOUT_S)
    chunks = []

    def drain():
        while True:
            chunk = b.recv(1 << 20)
            if not chunk:
                return
            chunks.append(chunk)

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        send(a)
        a.shutdown(socket.SHUT_WR)
        reader.join(SOCK_TIMEOUT_S)
        assert not reader.is_alive()
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("kind,n", [(0, 0), (1, 100), (3, 4096), (4, 5000), (2, 300_001)])
def test_send_frame_bytes_identical(kind, n):
    payload = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    port = socket_bytes(lambda s: T._send_frame(s, kind, payload))
    jax_ = socket_bytes(lambda s: JT._send_frame(s, kind, payload))
    assert port == jax_
    assert len(port) == 9 + n + 4
    assert T._HEARTBEAT_FRAME == JT._HEARTBEAT_FRAME


def frames_through(send):
    """Send with ``send(sock)``, receive every frame with the port's
    ``_recv_frame`` (an exception counts as one item)."""
    a, b = socket.socketpair()
    b.settimeout(SOCK_TIMEOUT_S)
    out = []
    try:
        send(a)
        a.shutdown(socket.SHUT_WR)
        while True:
            try:
                frame = T._recv_frame(b)
            except (T.FrameCorrupt, T.FramingLost) as e:
                out.append(e)
                if isinstance(e, T.FramingLost):
                    return out
                continue
            if frame is None:
                return out
            out.append(frame)
    finally:
        a.close()
        b.close()


def test_bad_trailer_drops_the_frame_and_bad_header_loses_the_stream():
    payload = b"x" * 5000

    def send(sock):
        JT._send_frame(sock, 3, payload, crc=J.frame_crc32(payload) ^ 0xDEADBEEF)  # bad trailer
        JT._send_frame(sock, 4, b"ok")                                             # stays in sync
        header = bytearray(JT._pack_header(3, 10))
        header[2] ^= 0x01                                                          # bad length word
        sock.sendall(bytes(header) + b"y" * 14)

    got = frames_through(send)
    assert isinstance(got[0], T.FrameCorrupt)
    assert got[1] == (4, b"ok")
    assert isinstance(got[2], T.FramingLost) and len(got) == 3


# -- rollout codec: requests, replies, shadow carries ---------------------------------


def request_tree(cfg, seed, carry=None):
    tree = {"obs": obs_row(random_obs(cfg, (1,), seed=seed), 0), "reset": np.asarray(1.0, np.float32)}
    if carry is not None:
        tree["carry"] = carry
    return tree


def carry_row(seed, H=8):
    rng = np.random.default_rng(seed)
    return {"c0": rng.normal(size=H).astype(np.float32), "c1": rng.normal(size=H).astype(np.float32)}


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("frame", ["request", "request_with_carry", "reply", "reply_with_carry"])
def test_serve_frames_bytes_identical(wire, frame):
    """Each package's protobuf encode writes the other's bytes, and so do
    the two native writers; across codecs the bytes are held by parse (a
    protobuf map's wire order follows its hash table)."""
    jcfg, pcfg = tiny_configs(request_wire_dtype=wire)
    if frame.startswith("request"):
        tree = request_tree(pcfg, seed=3, carry=carry_row(4) if frame.endswith("carry") else None)
        kw, jkw = serve_request_wire_kwargs(pcfg), jax_wire_kwargs(jcfg)
        assert kw == jkw
        port = S.encode_rollout(tree, 7, 2, 11, 1, 0.0, **kw).SerializeToString()
        jax_ = J.encode_rollout(tree, 7, 2, 11, 1, 0.0, **jkw).SerializeToString()
        assert S.encode_rollout_bytes(tree, 7, 2, 11, 1, 0.0, native=False, **kw) == port
        native = bytes(S.encode_rollout_bytes(tree, 7, 2, 11, 1, 0.0, **kw))
        assert native == bytes(J.encode_rollout_bytes(tree, 7, 2, 11, 1, 0.0, **jkw))
        assert S.pb.Rollout.FromString(native) == S.pb.Rollout.FromString(port)
        assert ("__wire_cast__" in S.decode_rollout_bytes(port)[0].get("wire_cast", {"__wire_cast__": 0})) == (
            wire == "float32")
    else:
        carry = carry_row(5) if frame.endswith("carry") else None
        args = (np.array([1, 4, 2, 9, 3], np.int32), -2.75, 12, 5, 33)
        reply = {"actions": args[0], "logp": np.asarray(args[1], np.float32), "dispatch_idx": np.asarray(8, np.int32),
                 **({"carry": carry} if carry is not None else {})}
        port = S.encode_rollout(reply, model_version=12, env_id=5, rollout_id=33, length=1,
                                total_reward=0.0).SerializeToString()
        jax_ = bytes(J.encode_rollout(reply, model_version=12, env_id=5, rollout_id=33, length=1,
                                      total_reward=0.0).SerializeToString())
        # each server's reply encoder (the native codec on both sides)
        native = bytes(jax_encode_reply(*args, dispatch_idx=8, carry=carry))
        assert bytes(encode_reply(*args, dispatch_idx=8, carry=carry)) == native
        assert S.pb.Rollout.FromString(native) == S.pb.Rollout.FromString(port)
        assert S.decode_rollout_bytes(native)[0] == S.decode_rollout_bytes(port)[0]
        assert_trees_equal(S.decode_rollout_bytes(native)[1], S.decode_rollout_bytes(port)[1])
    assert port == jax_


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_jax_bytes_decode_in_the_port_and_back(wire):
    jcfg, pcfg = tiny_configs(request_wire_dtype=wire)
    tree = request_tree(pcfg, seed=6, carry=carry_row(7))
    jkw = jax_wire_kwargs(jcfg)
    for jax_bytes in (
        J.encode_rollout(tree, 3, 1, 2, 1, 0.0, **jkw).SerializeToString(),
        bytes(J.encode_rollout_bytes(tree, 3, 1, 2, 1, 0.0, **jkw)),  # the native codec
    ):
        for upcast in (False, True):
            pm, pt = S.decode_rollout_bytes(jax_bytes, upcast=upcast)
            jm, jt = J.decode_rollout_bytes(jax_bytes, upcast=upcast, native=False)
            # the byte accounting of a narrowed payload included
            assert pm == jm
            assert_trees_equal(pt, jt)
    # the reverse: the port's bytes through both of the JAX decoders
    port_bytes = S.encode_rollout_bytes(tree, 3, 1, 2, 1, 0.0, **serve_request_wire_kwargs(pcfg))
    pm, pt = S.decode_rollout_bytes(port_bytes, upcast=True)
    for native in (False, True):
        jm, jt = J.decode_rollout_bytes(port_bytes, upcast=True, native=native)
        assert {k: jm[k] for k in pm} == pm
        assert_trees_equal(pt, jt)


def test_int_bound_is_verified_before_narrowing():
    _, pcfg = tiny_configs(request_wire_dtype="bfloat16")
    tree = request_tree(pcfg, seed=8)
    tree["obs"]["hero_id"] = np.asarray(300, np.int32)  # past its int8 bound
    with pytest.raises(ValueError, match="exceeds its declared int bound"):
        S.encode_rollout(tree, 0, 0, 1, 1, 0.0, **serve_request_wire_kwargs(pcfg))


def test_unflatten_tuple_levels_match_jax():
    flat = {"a/0": np.zeros(1), "a/1": np.ones(1), "b/00": np.zeros(2), "b/01": np.ones(2), "c": np.zeros(3)}
    got, want = S.unflatten_tree(flat), J.unflatten_tree(flat)
    assert isinstance(got["a"], tuple) and isinstance(got["b"], dict)
    assert_trees_equal(got, want)
    assert list(S.flatten_tree(got)) == list(J.flatten_tree(want))


# -- weights frames ---------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_weights_round_trip_across_packages(wire):
    jcfg, _ = tiny_configs()
    params = flax_params(jcfg, seed=9)
    port_msg = S.encode_weights(params, version=4, wire_dtype=wire)
    jax_msg = J.encode_weights(params, version=4, wire_dtype=wire)
    assert port_msg.SerializeToString() == jax_msg.SerializeToString()
    for upcast in (True, False):
        pv, pt = S.decode_weights(jax_msg, upcast=upcast)
        jv, jt = J.decode_weights(port_msg, upcast=upcast)
        assert pv == jv == 4
        assert_trees_equal(pt, jt)
    _, back = S.decode_weights(port_msg)
    if wire == "float32":
        assert_trees_equal(back, params)
    else:  # bf16 on the wire, f32 again after the exact upcast
        want = {k: v for k, v in J.decode_weights(jax_msg)[1].items()}
        assert_trees_equal(back, want)
        leaf = back["params"]["core"]["hi"]["kernel"]
        assert leaf.dtype == np.float32 and not np.array_equal(leaf, params["params"]["core"]["hi"]["kernel"])


def test_a_natively_bf16_leaf_keeps_its_dtype_and_converts_to_f32():
    """A frame from a learner whose params are bf16 carries no cast marker:
    the leaf decodes as bf16 (a ``torch.bfloat16`` tensor) and the serve
    path's conversion upcasts it exactly."""
    jcfg, _ = tiny_configs()
    params = flax_params(jcfg, seed=10, value_head=False)
    params["params"]["core"]["hi"]["kernel"] = params["params"]["core"]["hi"]["kernel"].astype(BF16)
    msg = J.encode_weights(params, version=2)
    leaf = S.decode_weights(msg)[1]["params"]["core"]["hi"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    _, sliced = weights_frame_to_params(msg)
    H = jcfg.model.hidden_dim
    want = params["params"]["core"]["hi"]["kernel"].astype(np.float32)
    np.testing.assert_array_equal(sliced["core.wh"][:, :H].numpy(), want)  # gate i of the hidden kernel

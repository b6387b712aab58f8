"""The port's native rollout codec against the JAX package's, case for case.

The cases of ``tests/test_native_codec.py``, each crossing the packages:
payloads the JAX package writes (protobuf and native) decode through the
port's native decoder, and the port's native bytes decode through both of
the JAX package's decoders, with arrays equal key by key. A bf16 leaf is an
``ml_dtypes`` array on the JAX side and a ``torch.bfloat16`` tensor on the
port's; they are compared by their bits. A protobuf map's wire order
follows its hash table, so native bytes are held against protobuf's by
parse; the two native writers are held byte for byte.
"""

import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu_torch.native import build as native_build
from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.transport import serialize as S

BF16 = np.dtype(ml_dtypes.bfloat16)
META = dict(model_version=7, env_id=3, rollout_id=123456789, length=16, total_reward=-2.5)


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    lib = native_build.load_library()
    assert lib is not None, native_build.load_error   # g++ is on this machine and the card's
    return lib


def leaf_np(a):
    """A decoded leaf as numpy (a port bf16 tensor as ml_dtypes bf16)."""
    if isinstance(a, torch.Tensor):
        return S.bf16_tensor_to_bits(a).view(BF16)
    return np.asarray(a)


def assert_flat_equal(got, want):
    """Two decoded trees equal leaf for leaf, key-sorted, dtype and bits."""
    g, w = S.flatten_tree(got), J.flatten_tree(want)
    assert sorted(g) == sorted(w)
    for name in sorted(w):
        a, b = leaf_np(g[name]), leaf_np(w[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def sample_arrays(seed=0, bf16=False):
    rng = np.random.default_rng(seed)
    units = rng.normal(size=(17, 32, 22)).astype(np.float32)
    arrays = {
        "obs": {
            "units": units.astype(BF16) if bf16 else units,
            "unit_mask": rng.random((17, 32)) > 0.5,
            "hero_id": np.arange(17, dtype=np.int32),
        },
        "rewards": rng.normal(size=(16,)).astype(np.float32),
        "scalar": np.float32(2.5),
        "carry0": (rng.normal(size=(128,)).astype(np.float32), rng.normal(size=(128,)).astype(np.float32)),
    }
    return arrays


def port_tree(arrays):
    """The JAX side's tree as the port holds it (bf16 leaves as tensors)."""
    flat = {n: (S.bits_to_bf16_tensor(np.asarray(a).view(np.uint16)) if np.asarray(a).dtype == BF16 else a)
            for n, a in J.flatten_tree(arrays).items()}
    return S.unflatten_tree(flat)


# -- the decoder (tests/test_native_codec.py TestNativeCodec) ----------------------------------


def test_exact_parity_with_protobuf():
    """A protobuf payload of either package through the port's native
    decoder: the JAX package's proto decode, key for key."""
    r = J.encode_rollout(sample_arrays(), **META)
    payload = r.SerializeToString()
    calls0 = S.codec_calls()
    m_nat, a_nat = S.decode_rollout_bytes(payload)
    assert S.codec_calls()["native_decodes"] == calls0["native_decodes"] + 1
    m_py, a_py = J.decode_rollout(r)
    assert m_nat == m_py
    assert_flat_equal(a_nat, a_py)
    m_port, a_port = S.decode_rollout_bytes(S.encode_rollout(sample_arrays(), **META).SerializeToString())
    assert m_port == m_py
    assert_flat_equal(a_port, a_py)


def test_bfloat16_payload():
    """A JAX package's bf16 leaf decodes natively into a ``torch.bfloat16``
    tensor of the same bits."""
    arrays = {"x": np.arange(8).astype(BF16)}
    payload = J.encode_rollout(arrays, model_version=0, env_id=0, rollout_id=0, length=1,
                               total_reward=0.0).SerializeToString()
    _, a = S.decode_rollout_bytes(payload)
    assert a["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(a["x"].float().numpy(), np.arange(8, dtype=np.float32))


def test_zero_copy_views():
    """f32 and int leaves view the payload (read-only for bytes); a bf16
    leaf is the one copy, into a tensor the caller may write."""
    payload = bytes(S.encode_rollout_bytes(port_tree(sample_arrays(bf16=True)), **META))
    _, a = S.decode_rollout_bytes(payload)
    units, mask = a["obs"]["units"], a["obs"]["unit_mask"]
    assert isinstance(units, torch.Tensor) and units.dtype == torch.bfloat16
    for arr in (mask, a["rewards"], a["carry0"][0]):
        assert arr.base is not None and not arr.flags.writeable
    # a writable buffer (the shm lane's memoryview) is viewed in place
    buf = bytearray(payload)
    _, b = S.decode_rollout_bytes(memoryview(buf))
    assert np.shares_memory(b["rewards"], np.frombuffer(buf, np.uint8))
    np.testing.assert_array_equal(b["rewards"], a["rewards"])


def test_malformed_input_falls_back_or_raises_cleanly():
    calls0 = S.codec_calls()
    with pytest.raises(Exception):
        S.decode_rollout_bytes(b"\xff\xff\xff\xff\x00garbage")
    # the native decoder refused it and protobuf had the last word, counted
    assert S.codec_calls()["proto_fallbacks"] == calls0["proto_fallbacks"] + 1
    with pytest.raises(Exception):
        J.decode_rollout_bytes(b"\xff\xff\xff\xff\x00garbage")


def test_python_fallback_matches():
    r = J.encode_rollout(sample_arrays(seed=3), **META)
    payload = r.SerializeToString()
    m1, a1 = S.decode_rollout_bytes(payload, native=False)
    m2, a2 = S.decode_rollout_bytes(payload, native=True)
    m3, a3 = J.decode_rollout_bytes(payload, native=False)
    assert m1 == m2 == m3
    assert_flat_equal(a1, a3)
    assert_flat_equal(a2, a3)


# -- the encoder (tests/test_native_codec.py TestNativeEncoder) ----------------------------------


def test_protobuf_parses_native_bytes_identically():
    """Protobuf parses the port's C writer's output to the message both
    packages' protobuf encoders build; the two C writers write the same
    bytes."""
    arrays = sample_arrays()
    calls0 = S.codec_calls()
    payload = S.encode_rollout_bytes(arrays, **META)
    assert isinstance(payload, memoryview)
    assert S.codec_calls()["native_encodes"] == calls0["native_encodes"] + 1
    got = pb.Rollout.FromString(bytes(payload))
    assert got == S.encode_rollout(arrays, **META) == J.encode_rollout(arrays, **META)
    assert bytes(payload) == bytes(J.encode_rollout_bytes(arrays, **META))


@pytest.mark.parametrize("bf16", [False, True])
def test_roundtrip_through_native_decoder(bf16):
    """Both ways across the packages: the port's native bytes through both
    JAX decoders, the JAX package's native bytes through the port's."""
    jarrays = sample_arrays(seed=5, bf16=bf16)
    port_bytes = bytes(S.encode_rollout_bytes(port_tree(jarrays), **META))
    jax_bytes = bytes(J.encode_rollout_bytes(jarrays, **META))
    assert port_bytes == jax_bytes
    pm, pa = S.decode_rollout_bytes(port_bytes)
    assert pm == {**META, "total_reward": pytest.approx(-2.5)}
    for native in (True, False):
        jm, ja = J.decode_rollout_bytes(port_bytes, native=native)
        assert jm == pm
        assert_flat_equal(pa, ja)
    qm, qa = S.decode_rollout_bytes(jax_bytes)
    assert qm == pm
    assert_flat_equal(qa, J.decode_rollout_bytes(jax_bytes)[1])


def test_zero_header_and_empty_array():
    arrays = {"empty": np.zeros((0, 4), np.float32), "x": np.ones((3,), np.int32)}
    meta = dict(model_version=0, env_id=0, rollout_id=0, length=0, total_reward=0.0)
    payload = S.encode_rollout_bytes(arrays, **meta)
    m, a = S.decode_rollout_bytes(payload)
    assert m == meta and a["empty"].shape == (0, 4)
    np.testing.assert_array_equal(a["x"], np.ones((3,), np.int32))
    jm, ja = J.decode_rollout_bytes(bytes(payload))
    assert jm == m and ja["empty"].shape == (0, 4)
    # protobuf leaves an empty tensor's data field out: the native decoder
    # reads it as empty, after a payload whose offsets ran past this one's
    S.decode_rollout_bytes(bytes(S.encode_rollout_bytes(sample_arrays(), **META)))
    proto = S.encode_rollout(arrays, **meta).SerializeToString()
    m2, a2 = S.decode_rollout_bytes(proto)
    assert m2 == m and a2["empty"].shape == (0, 4) and a2["x"].tolist() == [1, 1, 1]


def test_bfloat16_roundtrip():
    """A ``torch.bfloat16`` leaf: its address from ``data_ptr`` of the
    contiguous CPU tensor; the JAX decoder reads the same bf16 values."""
    t = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)[::2]   # a strided view: made contiguous
    payload = S.encode_rollout_bytes({"x": t}, model_version=1, env_id=0, rollout_id=0, length=1, total_reward=0.0)
    _, a = S.decode_rollout_bytes(payload)
    assert a["x"].dtype == torch.bfloat16 and torch.equal(a["x"], t)
    _, ja = J.decode_rollout_bytes(bytes(payload))
    assert ja["x"].dtype == BF16
    np.testing.assert_array_equal(np.asarray(ja["x"], np.float32), [0.0, 2.0, 4.0, 6.0])


def test_fallback_matches_native(monkeypatch):
    """``native=False``, and a process whose library cannot load (counted
    as a fallback), both write what the C writer's bytes parse to."""
    arrays = sample_arrays(seed=9)
    nat = S.encode_rollout_bytes(arrays, **META)
    py = S.encode_rollout_bytes(arrays, native=False, **META)
    assert isinstance(py, bytes) and pb.Rollout.FromString(bytes(nat)) == pb.Rollout.FromString(py)
    monkeypatch.setattr(S, "_native_lib", lambda: None)
    calls0 = S.codec_calls()
    missing = S.encode_rollout_bytes(arrays, **META)
    m, a = S.decode_rollout_bytes(missing)
    assert missing == py and m == S.decode_rollout_bytes(py, native=False)[0]
    assert S.codec_calls()["proto_fallbacks"] == calls0["proto_fallbacks"] + 2
    assert S.codec_calls()["native_encodes"] == calls0["native_encodes"]


def test_decoders_on_threads_keep_their_own_entry_tables():
    """The entry table is per thread and the call counters take a lock:
    more decoding threads than cores, switching often, each read their own
    payload, and no count is lost."""
    payloads = [bytes(S.encode_rollout_bytes({"x": np.full((64,), i, np.int32)}, i, 0, i, 1, 0.0))
                for i in range(16)]
    errors = []

    def work(i):
        for _ in range(100):
            m, a = S.decode_rollout_bytes(payloads[i])
            if m["rollout_id"] != i or not (a["x"] == i).all():
                errors.append(i)

    calls0 = S.codec_calls()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert S.codec_calls()["native_decodes"] == calls0["native_decodes"] + 16 * 100

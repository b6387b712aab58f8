"""The port's narrow (bf16) wires against the JAX package's, case for case.

The cases of ``tests/test_quantize.py``: the cast plan and its pinned f32
leaves, the ``__wire_cast__`` marker across the protobuf and native codecs
and across the packages (with the exact ``wire_bytes`` / ``raw_bytes``
accounting on both sides), the entry ceiling, the narrow ring (its store at
the wire dtypes, ``take`` bit for bit the f32 ring's, the bounds door, the
restores across wire dtypes), the device collect's narrow chunks beside the
fused path's full-width ones, the finiteness scan that never widens a bf16
leaf, narrow frames over the shm lane and the socket with their CRCs, and
the wire tier of the run record. Rows are the JAX test's (numpy, from a
seed; the narrowable f32 leaves pre-rounded to bf16 where a test asks for
bit equality); a port bf16 leaf is a ``torch.bfloat16`` tensor, compared by
its bits.
"""

import dataclasses
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu_torch import config as port_config
from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.train.ppo import example_batch
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.utils import faults, schema, telemetry
from dotaclient_tpu_torch.utils.tree import tree_map
from tests.test_quantize import META, real_row
from tests.test_quantize import make_buffer as jax_buffer
from tests.test_quantize import tiny_config as jax_tiny_config
from tests.test_quantize import wire_kwargs as jax_wire_kwargs

BF16 = np.dtype(ml_dtypes.bfloat16)


def tiny_config(wire="bfloat16", capacity=16):
    """The JAX test's tiny config in the port."""
    cfg = port_config.RunConfig()
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, n_envs=2, max_dota_time=30.0),
        ppo=dataclasses.replace(cfg.ppo, rollout_len=4, batch_rollouts=8),
        buffer=dataclasses.replace(cfg.buffer, capacity_rollouts=capacity, min_fill=8),
        transport=dataclasses.replace(cfg.transport, rollout_wire_dtype=wire),
        log_every=1000,
        checkpoint_every=1000,
    )


def wire_kwargs(cfg):
    return dict(wire_dtype=cfg.transport.rollout_wire_dtype, int_bounds=S.rollout_int_bounds(cfg))


def port_buffer(cfg):
    return TrajectoryBuffer(cfg, device="cpu", registry=telemetry.Registry())


def leaf_np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return S.bf16_tensor_to_bits(a).view(BF16)
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_flat_equal(got, want, exact_dtypes=True):
    """Two trees equal key by key (sorted), bit for bit."""
    g, w = S.flatten_tree(got), J.flatten_tree(want)
    assert sorted(g) == sorted(w)
    for name in sorted(w):
        a, b = leaf_np(g[name]), leaf_np(w[name])
        if exact_dtypes:
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape and np.array_equal(a.astype(np.float64) if a.dtype == BF16 else a,
                                                     b.astype(np.float64) if b.dtype == BF16 else b), name


def decoded_copies(cfg, row, n):
    """n independently decoded (meta, arrays) pairs of one row."""
    payload = bytes(S.encode_rollout_bytes(row, **META, **wire_kwargs(cfg)))
    out = []
    for i in range(n):
        meta, arrays = S.decode_rollout_bytes(payload)
        meta["rollout_id"] = i
        out.append((meta, arrays))
    return out


def the_row(seed=0, representable=True):
    return real_row(jax_tiny_config(), seed=seed, representable=representable)


# -- the cast plan ---------------------------------------------------------------------------------


def test_pinned_leaves_never_narrow():
    specs = {n: "float32" for n in ("behavior_logp", "rewards", "dones", "values", "carry0/0", "carry0/1",
                                    "obs/units")}
    plan = S.rollout_cast_plan(specs, "bfloat16", S.rollout_int_bounds(tiny_config()))
    jplan = J.rollout_cast_plan(specs, "bfloat16", J.rollout_int_bounds(jax_tiny_config()))
    assert plan == {"obs/units": "bfloat16"} and {n: J._dtype_name(d) for n, d in jplan.items()} == plan


def test_int_bounds_drive_exact_narrowing():
    bounds = S.rollout_int_bounds(tiny_config())
    assert bounds == J.rollout_int_bounds(jax_tiny_config())
    specs = {"actions/move_x": "int32", "obs/hero_id": "int32", "obs/unit_handles": "int32",
             "obs/unbounded": "int32"}
    plan = S.rollout_cast_plan(specs, "bfloat16", bounds)
    assert plan == {"actions/move_x": "int8", "obs/hero_id": "int8", "obs/unit_handles": "int16"}
    assert {n: np.dtype(d).name for n, d in J.rollout_cast_plan(specs, "bfloat16", bounds).items()} == plan


def test_f32_wire_is_empty_plan():
    assert S.rollout_cast_plan({"obs/units": "float32"}, "float32") == {}
    assert S.rollout_wire_kwargs(tiny_config("float32")) == {}


def test_unknown_wire_dtype_raises():
    for mod in (S, J):
        with pytest.raises(ValueError, match="rollout_wire_dtype"):
            mod.rollout_cast_plan({}, "float16")


@pytest.mark.parametrize("native", [True, False])
def test_out_of_bound_int_fails_loudly(native):
    """The int bound is a promise of the config: a value past it raises at
    encode in both codecs, never wraps."""
    arrays = {"actions": {"move_x": np.array([300], np.int32)}, "rewards": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="move_x"):
        S.encode_rollout_bytes(arrays, 0, 0, 0, 1, 0.0, native=native, wire_dtype="bfloat16",
                               int_bounds={"actions/move_x": 8})


def test_apply_cast_plan_on_numpy_and_torch_alike():
    """The one place the cast lands: numpy leaves and torch leaves narrow to
    the same bits (bf16 as ml_dtypes rounds), leaves off the plan pass."""
    rng = np.random.default_rng(4)
    f = rng.normal(size=(3, 5)).astype(np.float32)
    i = rng.integers(0, 9, size=(4,)).astype(np.int32)
    plan = {"f": "bfloat16", "i": "int8"}
    a = S.apply_cast_plan({"f": f, "i": i, "x": f}, plan)
    b = S.apply_cast_plan({"f": torch.from_numpy(f), "i": torch.from_numpy(i), "x": f}, plan)
    assert a["f"].dtype == b["f"].dtype == torch.bfloat16 and a["x"] is f and b["x"] is f
    np.testing.assert_array_equal(leaf_np(a["f"]), f.astype(BF16))
    np.testing.assert_array_equal(leaf_np(b["f"]), f.astype(BF16))
    assert a["i"].dtype == np.int8 and b["i"].dtype == torch.int8
    np.testing.assert_array_equal(a["i"], b["i"].numpy())


# -- the marker round trip ------------------------------------------------------------------------


def test_native_bytes_parity_with_f32_path():
    """encode -> wire -> decode -> upcast over the native codec equals the
    f32 path for bf16-representable rows; the port's narrow bytes are the
    JAX package's native writer's."""
    cfg, row = tiny_config(), the_row()
    b32 = bytes(S.encode_rollout_bytes(row, **META))
    bnar = bytes(S.encode_rollout_bytes(row, **META, **wire_kwargs(cfg)))
    assert len(bnar) < len(b32)
    assert bnar == bytes(J.encode_rollout_bytes(row, **META, **jax_wire_kwargs(jax_tiny_config())))
    m32, a32 = S.decode_rollout_bytes(b32)
    mn, an = S.decode_rollout_bytes(bnar, upcast=True)
    assert "wire_cast" not in m32 and mn["wire_cast"]
    assert_flat_equal(an, a32)


def test_proto_codec_parity():
    cfg, row = tiny_config(), the_row()
    r = S.encode_rollout(row, **META, **wire_kwargs(cfg))
    mn, an = S.decode_rollout(r, upcast=True)
    _, a32 = S.decode_rollout(S.encode_rollout(row, **META))
    assert mn["wire_cast"]
    assert_flat_equal(an, a32)
    jm, ja = J.decode_rollout(r, upcast=True)
    assert jm["wire_cast"] == mn["wire_cast"]
    assert_flat_equal(an, ja)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_codec_parity(writer):
    """A narrow protobuf payload of either package decodes alike through
    the port's native and protobuf decoders and the JAX package's, with the
    same marker and byte accounting, narrow or upcast."""
    row = the_row()
    mod, kw = (S, wire_kwargs(tiny_config())) if writer == "port" else (J, jax_wire_kwargs(jax_tiny_config()))
    payload = mod.encode_rollout(row, **META, **kw).SerializeToString()
    for upcast in (False, True):
        m_native, a_native = S.decode_rollout_bytes(payload, upcast=upcast)
        m_proto, a_proto = S.decode_rollout_bytes(payload, native=False, upcast=upcast)
        m_jax, a_jax = J.decode_rollout_bytes(payload, native=False, upcast=upcast)
        assert m_native == m_proto == m_jax
        assert_flat_equal(a_native, a_jax)
        assert_flat_equal(a_proto, a_jax)


def test_pinned_leaves_byte_identical():
    """Pinned f32 leaves cross a narrow wire byte for byte, even values a
    bf16 cast would round."""
    cfg = tiny_config()
    row = the_row(representable=False)
    _, decoded = S.decode_rollout_bytes(bytes(S.encode_rollout_bytes(row, **META, **wire_kwargs(cfg))))
    for name in ("behavior_logp", "rewards", "dones"):
        assert decoded[name].dtype == np.float32 and decoded[name].tobytes() == row[name].tobytes()
    for got, want in zip(decoded["carry0"], row["carry0"]):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("native", [True, False])
def test_meta_accounting(native):
    """raw_bytes is exact: what this frame costs at full width, an f32
    encode of the same row byte for byte, from both decoders and equal to
    the JAX package's accounting."""
    cfg, row = tiny_config(), the_row()
    payload = bytes(S.encode_rollout_bytes(row, **META, **wire_kwargs(cfg)))
    meta, _ = S.decode_rollout_bytes(payload, native=native)
    assert meta["wire_bytes"] == len(payload)
    assert meta["raw_bytes"] == len(bytes(S.encode_rollout_bytes(row, **META))) > meta["wire_bytes"]
    assert meta == J.decode_rollout_bytes(payload, native=native)[0]
    assert meta["wire_cast"]["obs/units"] == "float32" and meta["wire_cast"]["obs/unit_handles"] == "int32"
    assert not any(S.rollout_leaf_pinned(n) for n in meta["wire_cast"])


def test_f32_wire_unchanged():
    """An f32 wire: no marker, the bytes of the call without wire kwargs."""
    cfg, row = tiny_config("float32"), the_row()
    assert wire_kwargs(cfg)["wire_dtype"] == "float32"
    assert bytes(S.encode_rollout_bytes(row, **META)) == bytes(S.encode_rollout_bytes(row, **META,
                                                                                       **wire_kwargs(cfg)))


def test_zero_length_payload_cannot_zero_divide_the_gauge():
    """A zero-byte payload parses as an empty Rollout (0 wire and raw
    bytes); the ratio gauge stays put, and real payloads count after."""
    reg = telemetry.Registry()
    totals = [0, 0]
    out, bad = S.decode_drained_payloads([b""], reg, totals)
    assert bad == 0 and len(out) == 1 and totals == [0, 0]
    cfg = tiny_config()
    payload = S.encode_rollout_bytes(the_row(), **META, **wire_kwargs(cfg))
    out, bad = S.decode_drained_payloads([payload], reg, totals)
    assert bad == 0 and totals[0] > 0 and totals[1] > totals[0]
    from dotaclient_tpu.utils import telemetry as jtel

    jtotals = [0, 0]
    assert J.decode_drained_payloads([b"", bytes(payload)], jtel.Registry(), jtotals)[1] == 0
    assert jtotals == totals


# -- the entry ceiling ------------------------------------------------------------------------------


def _big_tree(n):
    return {"obs": {f"x{i}": np.zeros((2,), np.float32) for i in range(n)}}


def test_encode_raises_with_count():
    for native in (True, False):
        with pytest.raises(ValueError, match="70"):
            S.encode_rollout_bytes(_big_tree(70), 0, 0, 0, 1, 0.0, native=native)
    with pytest.raises(ValueError, match="70"):
        S.encode_rollout(_big_tree(70), 0, 0, 0, 1, 0.0)


def test_decode_raises_with_count():
    r = S.pb.Rollout(model_version=0)
    for i in range(70):
        r.arrays[f"x{i}"].CopyFrom(S.tensor_to_proto(np.zeros((2,), np.float32)))
    payload = r.SerializeToString()
    for native in (True, False):
        with pytest.raises(ValueError, match="70"):
            S.decode_rollout_bytes(payload, native=native)


def test_marker_counts_toward_ceiling():
    tree = _big_tree(S._MAX_TENSORS)
    S.encode_rollout_bytes(tree, 0, 0, 0, 1, 0.0)   # at the ceiling: fine
    with pytest.raises(ValueError, match=str(S._MAX_TENSORS + 1)):
        S.encode_rollout_bytes(tree, 0, 0, 0, 1, 0.0, wire_dtype="bfloat16")


# -- the narrow ring --------------------------------------------------------------------------------


def test_store_is_narrow_and_take_is_f32():
    cfg = tiny_config()
    buf = port_buffer(cfg)
    stored = S.flatten_tree(buf._store)
    jstored = J.flatten_tree(jax_buffer(jax_tiny_config())._store)
    assert sorted(stored) == sorted(jstored)
    for name, t in stored.items():
        want = jstored[name].dtype
        assert (t.dtype == torch.bfloat16) if want == BF16 else (np.dtype(str(t.dtype)[6:]) == want), name
    assert stored["obs/units"].dtype == torch.bfloat16 and stored["actions/move_x"].dtype == torch.int8
    assert stored["obs/unit_handles"].dtype == torch.int16 and stored["behavior_logp"].dtype == torch.float32
    assert buf.add(decoded_copies(cfg, the_row(), 8), 0) == 8
    flat = S.flatten_tree(buf.take(batch_size=8, current_version=0))
    assert flat["obs/units"].dtype == torch.float32 and flat["actions/move_x"].dtype == torch.int32
    assert flat["obs/unit_handles"].dtype == torch.int32


def test_upcast_bit_identical_to_f32_path():
    """The narrow ring's batch equals the f32 ring's for bf16-representable
    rows, and the JAX narrow ring's: the train step cannot tell the wire
    was narrow."""
    row = the_row()
    batches = {}
    for wire in ("float32", "bfloat16"):
        cfg = tiny_config(wire, capacity=8)
        buf = port_buffer(cfg)
        assert buf.add(decoded_copies(cfg, row, 8), 0) == 8
        batches[wire] = tree_map(lambda t: t.numpy(), buf.take(batch_size=8, current_version=0))
    assert_flat_equal(batches["bfloat16"], batches["float32"])
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, buffer=dataclasses.replace(jcfg.buffer, capacity_rollouts=8))
    jbuf = jax_buffer(jcfg)
    payload = bytes(J.encode_rollout_bytes(row, **META, **jax_wire_kwargs(jcfg)))
    assert jbuf.add([J.decode_rollout_bytes(payload) for _ in range(8)], 0) == 8
    import jax

    assert_flat_equal(batches["bfloat16"], jax.tree.map(np.asarray, jbuf.take(batch_size=8, current_version=0)))


def test_full_width_payload_admitted_to_narrow_ring():
    """A full-width row (an in-process actor, an f32 actor) is rounded into
    the narrow ring as the wire rounds it, not dropped as skew."""
    cfg = tiny_config(capacity=8)
    row = the_row(representable=False)
    buf = port_buffer(cfg)
    assert buf.add([(dict(META), row)] * 8, 0) == 8 and buf.dropped_skew == 0
    wire = port_buffer(cfg)
    assert wire.add(decoded_copies(cfg, row, 8), 0) == 8
    assert_flat_equal(tree_map(lambda t: t.numpy(), buf.take(8, 0)), tree_map(lambda t: t.numpy(), wire.take(8, 0)))


def test_full_width_out_of_bounds_rejected_at_narrow_ring():
    cfg = tiny_config()
    buf = port_buffer(cfg)
    jbuf = jax_buffer(jax_tiny_config())
    flat = S.flatten_tree(the_row())
    name = next(n for n, d in buf._wire_plan.items() if d == "int8")
    arr = np.array(flat[name])
    arr.flat[0] = 300   # wraps to 44 under a silent int8 cast
    bad = S.unflatten_tree({**flat, name: arr})
    for b in (buf, jbuf):
        assert b.add([(dict(META), bad)], 0) == 0
        assert b.dropped_bounds == 1 and b.dropped_skew == 0
        assert b.add([(dict(META), the_row())], 0) == 1
    assert buf._tel.snapshot()["buffer/intbound_rejected_total"] == 1.0


def test_narrow_payload_admitted_to_f32_ring():
    buf = port_buffer(tiny_config("float32"))
    meta, arrays = S.decode_rollout_bytes(bytes(S.encode_rollout_bytes(the_row(), **META,
                                                                       **wire_kwargs(tiny_config()))))
    assert buf.add([(meta, arrays)], 0) == 1 and buf.dropped_skew == 0


def test_genuine_skew_still_drops():
    buf = port_buffer(tiny_config())
    row = the_row()
    assert buf.add([(dict(META), {**row, "rewards": row["rewards"].astype(np.float64)})], 0) == 0
    assert buf.dropped_skew == 1
    assert buf.add([(dict(META), {**row, "rewards": row["rewards"][:-1]})], 0) == 0
    assert buf.dropped_skew == 2


def test_snapshot_restores_across_wire_dtypes():
    """A narrow ring's snapshot restores into an f32 ring (exact) and back
    (the same bits)."""
    cfg = tiny_config()
    buf = port_buffer(cfg)
    assert buf.add(decoded_copies(cfg, the_row(), 1), 0) == 1
    wide = port_buffer(tiny_config("float32"))
    wide.load_state_dict(buf.state_dict())
    assert S.flatten_tree(wide._store)["obs/units"].dtype == torch.float32 and wide.size == 1
    back = port_buffer(cfg)
    back.load_state_dict(wide.state_dict())
    for name, t in S.flatten_tree(back._store).items():
        assert torch.equal(t, S.flatten_tree(buf._store)[name]), name


def test_restore_frees_out_of_range_slots_instead_of_wrapping():
    """An f32 ring's snapshot into a narrow ring runs the bounds door: the
    slot whose int values do not fit is freed and counted, never wrapped,
    as in the JAX package."""
    narrow = port_buffer(tiny_config())
    wide = port_buffer(tiny_config("float32"))
    assert wide.add([(dict(META), the_row())], 0) == 1
    bad = S.flatten_tree(the_row(seed=1))
    name = next(n for n, d in narrow._wire_plan.items() if d == "int8")
    arr = np.array(bad[name])
    arr.flat[0] = 300
    bad[name] = arr
    assert wide.add([(dict(META, rollout_id=1), S.unflatten_tree(bad))], 0) == 1   # no guards at full width
    narrow.load_state_dict(wide.state_dict())
    assert narrow.size == 1 and narrow.dropped_bounds == 1
    slot = list(narrow._order)[0]
    np.testing.assert_array_equal(S.flatten_tree(narrow._store)[name][slot].numpy(),
                                  S.flatten_tree(the_row())[name].astype(np.int8))


# -- the device collect ---------------------------------------------------------------------------


def test_collect_emits_narrow_chunks_fused_path_untouched():
    cfg = dataclasses.replace(tiny_config(), model=port_config.ModelConfig(unit_embed_dim=8, hidden_dim=8,
                                                                           hero_embed_dim=4))
    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(0))
    actor = DeviceActor(cfg, policy, seed=0, device="cpu", registry=telemetry.Registry())
    chunk, _ = actor.collect(policy)
    flat = S.flatten_tree(chunk)
    # the JAX package's plan for the same layout
    jplan = J.rollout_cast_plan({n: np.dtype(str(t.dtype)[6:]) for n, t in S.flatten_tree(
        example_batch(cfg, 1, device="cpu")).items()}, "bfloat16", S.rollout_int_bounds(cfg))
    assert {n for n, t in flat.items() if t.dtype == torch.bfloat16} == {n for n, d in jplan.items() if d == BF16}
    assert flat["actions/move_x"].dtype == torch.int8 and flat["behavior_logp"].dtype == torch.float32
    buf = port_buffer(dataclasses.replace(cfg, buffer=dataclasses.replace(cfg.buffer, capacity_rollouts=8)))
    assert buf.add_device(chunk, 0) == flat["valid"].shape[0]
    # the fused path calls _rollout_impl itself: full width there
    _, raw, _ = actor._rollout_impl(policy, actor.state, policy)
    assert S.flatten_tree(raw)["obs/units"].dtype == torch.float32


# -- finiteness ----------------------------------------------------------------------------------------


def test_bf16_nan_rejected_at_the_door():
    cfg = tiny_config()
    buf = port_buffer(cfg)
    meta, arrays = S.decode_rollout_bytes(bytes(S.encode_rollout_bytes(the_row(), **META, **wire_kwargs(cfg))))
    units = arrays["obs"]["units"].clone()
    units[0, 0, 0] = float("nan")   # a bf16 NaN is still a NaN
    arrays = {**arrays, "obs": {**arrays["obs"], "units": units}}
    assert buf.add([(meta, arrays)], 0) == 0 and buf.dropped_nonfinite == 1


class _Outputs(TorchDispatchMode):
    """Every aten op's outputs (dtype, elements) while it is on."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((t.dtype, t.numel(), t.untyped_storage().data_ptr()))
        return out


def test_finiteness_scan_never_upcasts():
    """The scan reads a bf16 leaf at its own width, in slices: no op makes
    an f32 tensor, and none but views of the leaf one as large as the leaf
    (an f32 copy would be 2x its bytes)."""
    buf = port_buffer(tiny_config())
    leaf = torch.zeros((1 << 20,), dtype=torch.bfloat16)
    with _Outputs() as ops:
        assert buf._payload_finite({"obs/units": leaf})
    made = [s for s in ops.seen if s[2] != leaf.untyped_storage().data_ptr()]
    assert made and not [s for s in made if s[0] == torch.float32 or s[1] >= leaf.numel()]
    leaf[-1] = float("inf")
    assert not buf._payload_finite({"obs/units": leaf})


# -- narrow frames on the lanes -----------------------------------------------------------------------


def _shm_lane(tag):
    from dotaclient_tpu_torch.transport.shm_transport import ShmTransport, ShmTransportServer

    name = f"t-pquant-{os.getpid()}-{tag}"
    reg = telemetry.Registry()
    server = ShmTransportServer(name=name, slots=1, ring_bytes=1 << 20, weights_bytes=1 << 20, registry=reg)
    return server, ShmTransport(name), reg


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_narrow_frames_roundtrip_and_count(writer):
    """Narrow payloads of either package over the shm lane: decoded narrow,
    counted at their wire and full-width bytes, the ratio above 1.3."""
    cfg, row = tiny_config(), the_row()
    server, actor, reg = _shm_lane(f"n{writer}")
    try:
        for i in range(3):
            meta = dict(META, rollout_id=i)
            payload = (S.encode_rollout_bytes(row, **meta, **wire_kwargs(cfg)) if writer == "port" else
                       J.encode_rollout_bytes(row, **meta, **jax_wire_kwargs(jax_tiny_config())))
            assert actor.publish_rollout_bytes(payload)
        got = server.consume_decoded(16, timeout=1.0)
        assert [m["rollout_id"] for m, _ in got] == [0, 1, 2]
        assert S.flatten_tree(got[0][1])["obs/units"].dtype == torch.bfloat16
        snap = reg.snapshot()
        assert snap["transport/rollout_raw_bytes_total"] > snap["transport/rollout_bytes_total"] > 0
        assert snap["transport/rollout_compression_ratio"] > 1.3
    finally:
        actor.close()
        server.close()


def test_crc_quarantine_unchanged_on_narrow_frames():
    """A bit-flipped narrow frame drops and counts as an f32 one does."""
    cfg, row = tiny_config(), the_row()
    faults.configure("transport.corrupt_frame@2")
    server, actor, reg = _shm_lane("crc")
    try:
        for i in range(4):
            assert actor.publish_rollout_bytes(S.encode_rollout_bytes(row, **dict(META, rollout_id=i),
                                                                      **wire_kwargs(cfg)))
        got = server.consume_decoded(16, timeout=1.0)
        assert [m["rollout_id"] for m, _ in got] == [0, 2, 3]
        assert reg.snapshot()["transport/frames_corrupt_total"] == 1.0
    finally:
        faults.configure(None)
        actor.close()
        server.close()


def test_narrow_frames_over_the_socket_with_their_crcs():
    """The native encoder's narrow bytes over TCP: the server's CRC check
    passes them, decodes them narrow and counts the ratio."""
    import time

    from dotaclient_tpu_torch.transport.socket_transport import SocketTransport, TransportServer

    cfg, row = tiny_config(), the_row()
    reg = telemetry.Registry()
    server = TransportServer(port=0, registry=reg)
    actor = SocketTransport(*server.address)
    try:
        for i in range(3):
            actor.publish_rollout_bytes(S.encode_rollout_bytes(row, **dict(META, rollout_id=i), **wire_kwargs(cfg)))
        got, deadline = [], time.time() + 10.0
        while len(got) < 3 and time.time() < deadline:
            got += server.consume_decoded(16, timeout=0.1)
        assert sorted(m["rollout_id"] for m, _ in got) == [0, 1, 2]
        meta, arrays = got[0]
        _, want = S.decode_rollout_bytes(bytes(S.encode_rollout_bytes(row, **META, **wire_kwargs(cfg))))
        assert_flat_equal(arrays, want)
        snap = reg.snapshot()
        assert snap["transport/rollout_compression_ratio"] > 1.3 and snap["transport/frames_corrupt_total"] == 0.0
    finally:
        actor.close()
        server.close()


# -- the wire tier of the record ---------------------------------------------------------------------------


def _line(scalars):
    return json.dumps({"ts": 1.0, "step": 0, "scalars": scalars})


def _base(keys):
    out = {k: 1.0 for k in keys}
    for k in list(out):
        if k.startswith("span/"):
            root = k.rsplit("/", 1)[0]
            out.update({f"{root}/{leaf}": 1.0 for leaf in schema.TIMER_LEAVES})
    return out


def test_wire_keys_required_only_on_request():
    from scripts import check_telemetry_schema as script

    assert schema.WIRE_KEYS == script.WIRE_KEYS and schema.IN_PROC_ACTOR_KEYS == script.IN_PROC_ACTOR_KEYS
    line = _line(_base(schema.REQUIRED_KEYS))
    assert schema.validate_lines([line]) == []
    assert any("rollout_compression_ratio" in e for e in schema.validate_lines([line], schema.WIRE_KEYS))
    full = _line({**_base(schema.REQUIRED_KEYS), **{k: 0.0 for k in schema.WIRE_KEYS}})
    assert schema.validate_lines([full], schema.WIRE_KEYS) == []


def test_external_transport_run_waives_in_proc_actor_keys():
    from scripts import check_telemetry_schema as script

    scalars = _base([k for k in schema.REQUIRED_KEYS if k not in schema.IN_PROC_ACTOR_KEYS])
    scalars.update({k: 0.0 for k in schema.WIRE_KEYS})
    errors = schema.validate_lines([_line(scalars)], schema.WIRE_KEYS)
    assert any("frames_shipped" in e for e in errors)
    scalars["transport/actors_connected"] = 1.0
    for check in (schema.validate_lines, script.validate_lines):
        assert check([_line(scalars)], extra_required=schema.WIRE_KEYS) == []


def test_both_servers_eager_create_wire_keys():
    from dotaclient_tpu_torch.transport.socket_transport import TransportServer

    reg = telemetry.Registry()
    srv = TransportServer(port=0, registry=reg)
    try:
        snap = reg.snapshot()
        assert all(k in snap for k in schema.WIRE_KEYS) and snap["transport/rollout_compression_ratio"] >= 1.0
    finally:
        srv.close()
    server, actor, reg = _shm_lane("tier")
    try:
        assert all(k in reg.snapshot() for k in schema.WIRE_KEYS)
    finally:
        actor.close()
        server.close()


# -- the learner ------------------------------------------------------------------------------------------


def test_short_run_losses_agree_within_bf16_tolerance():
    """Two buffered learners from one seed, a narrow and an f32 ring: their
    first batches differ only by the ring's bf16 rounding of the
    observations, so their losses agree to bf16's tolerance; the narrow
    learner's ring stores bf16."""
    from dotaclient_tpu_torch.train.learner import Learner

    losses = {}
    for wire in ("float32", "bfloat16"):
        cfg = dataclasses.replace(
            tiny_config(wire, capacity=8),
            model=port_config.ModelConfig(unit_embed_dim=8, hidden_dim=8, hero_embed_dim=4),
            env=dataclasses.replace(tiny_config().env, n_envs=2, max_dota_time=2.0),
            buffer=dataclasses.replace(tiny_config().buffer, capacity_rollouts=8, min_fill=8),
            learner=port_config.LearnerConfig(async_snapshots=False), log_every=1)
        learner = Learner(cfg, actor="device", seed=3, device="cpu", registry=telemetry.Registry())
        try:
            losses[wire] = learner.train(1)["loss"]
            stored = S.flatten_tree(learner.buffer._store)["obs/units"].dtype
            assert stored == (torch.bfloat16 if wire == "bfloat16" else torch.float32)
        finally:
            learner.close()
    assert np.isfinite(losses["float32"]) and np.isfinite(losses["bfloat16"])
    assert losses["bfloat16"] == pytest.approx(losses["float32"], rel=0.05, abs=5e-3)

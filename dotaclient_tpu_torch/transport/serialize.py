"""Wire codec: host trees of arrays <-> ``Rollout`` / ``ModelWeights`` protos.

Counterpart of ``dotaclient_tpu/transport/serialize.py``. The bytes are the
JAX package's: a tree flattens to slash-joined leaf names in the same order
(``flatten_tree``), each leaf becomes a ``TensorProto`` (shape, numpy dtype
name, raw little-endian bytes), and map entries are written in that order.
Frames carry the same integrity trailer (``frame_crc32``, defined beside
the framing in ``socket_transport.py`` and re-exported here).

Two codecs write and read the same message. ``encode_rollout_bytes`` and
``decode_rollout_bytes`` take the native one by default (``native=True``):
the port's single-pass C++ encoder and decoder (``native/rollout_codec.cc``,
built at first use, loaded with ctypes). Decode hands out numpy views into
the payload with no copy (read-only when the payload is; the ring's
staging copies them), but a bf16 leaf, which it copies once into a
``torch.bfloat16`` tensor; encode writes the payload from the leaves'
buffers, one copy a leaf, and returns a memoryview. Only when the library
cannot be built or loaded, or the native decoder finds a payload malformed,
does a call take the protobuf codec, and ``CODEC_CALLS`` counts every call
by the path it took (``codec_calls()`` reads it). ``native=False`` asks
for protobuf. A payload past the native entry table (``_MAX_TENSORS``)
raises, naming its count. A protobuf map's wire order follows its hash
table, so the two codecs' bytes are held equal by parse, never byte for
byte.

bfloat16 without ``ml_dtypes``: on the host the port holds a bf16 leaf as a
``torch.bfloat16`` CPU tensor. f32 -> bf16 rounds to nearest even with
integer ops on the f32 bits (a NaN becomes the quiet NaN of its sign,
0x7FC0 or 0xFFC0); bf16 -> f32 is the exact 16-bit shift. Both match
``ml_dtypes`` bit for bit, subnormals included.

The narrow rollout wire (``transport.rollout_wire_dtype="bfloat16"``):
``rollout_cast_plan`` names the leaves that narrow and ``apply_cast_plan``
casts them, the one place the cast lands (the host encode, the ring's
narrow store, the device collect), on numpy arrays and torch tensors alike.

The learner's side of the rollout wire: ``decode_drained_payloads`` decodes
a transport drain (malformed payloads counted and dropped) and keeps the
wire byte accounting, ``transport/rollout_bytes_total``,
``transport/rollout_raw_bytes_total`` and
``transport/rollout_compression_ratio``; a narrowed payload's meta carries
``wire_bytes`` and ``raw_bytes`` (what the same payload costs at full
width, to the byte), a full-width one counts its own length for both.
``rollout_wire_kwargs`` is the one derivation of an encoder's kwargs from a
config.

Trace records (``utils/tracing.py``) ride as the in-band ``__trace__``
entry: ``encode_rollout(trace=)`` on a sampled chunk or serve frame,
``encode_weights(trace=)`` on a tracing learner's weights frame, read back
by ``decode_rollout`` into ``meta["trace_blob"]`` and by ``weights_trace``.
A tracing learner's ``decode_drained_payloads`` stamps a chunk's ``recv``
and ``consume`` hops.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.native import build as native_build
from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.transport.socket_transport import frame_crc32  # noqa: F401  (re-exported)
from dotaclient_tpu_torch.utils import tracing

BF16 = "bfloat16"

# -- bfloat16 on the host ----------------------------------------------------


def f32_to_bf16_bits(a: Any) -> np.ndarray:
    """f32 values -> bf16 bit patterns (uint16), round to nearest even."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    lsb = (u >> np.uint32(16)) & np.uint32(1)
    rounded = ((u + np.uint32(0x7FFF) + lsb) >> np.uint32(16)).astype(np.uint16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = (((u >> np.uint32(16)) & np.uint32(0x8000)) | np.uint32(0x7FC0)).astype(np.uint16)
    return np.where(nan, quiet, rounded)


def bf16_bits_to_f32(bits: Any) -> np.ndarray:
    """bf16 bit patterns (uint16) -> f32 values (exact)."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def bits_to_bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits, np.uint16).view(np.int16).copy()).view(torch.bfloat16)


def _own_bits_as_bf16(bits: np.ndarray) -> torch.Tensor:
    """A fresh, contiguous uint16 array the caller gives up, as a bf16
    tensor over the same memory (no copy)."""
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def bf16_tensor_to_bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


def _to_f32(a: Any) -> np.ndarray:
    """A leaf as f32 numpy (a bf16 tensor upcast exactly)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return bf16_bits_to_f32(bf16_tensor_to_bits(a))
        return a.detach().cpu().numpy().astype(np.float32)
    return np.asarray(a, dtype=np.float32)


_DTYPE_NAMES: Dict[Any, str] = {}


def _dtype_name(a: Any) -> str:
    """The wire's dtype string of a leaf (numpy dtype names; ``bfloat16``)."""
    dtype = a.dtype
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        if isinstance(dtype, torch.dtype):
            name = BF16 if dtype == torch.bfloat16 else np.dtype(str(dtype).replace("torch.", "")).name
        else:
            name = np.dtype(dtype).name
        _DTYPE_NAMES[dtype] = name
    return name


# -- trees --------------------------------------------------------------------


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict/tuple tree of arrays to slash-joined names."""
    out: Dict[str, Any] = {}
    _flatten_into(tree, prefix, out)
    return out


_LEAF_TYPES = (np.ndarray, torch.Tensor)


def _flatten_into(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    # exact types first: the ABC checks cost more than the walk
    kind = type(tree)
    if kind is dict or (kind not in _LEAF_TYPES and isinstance(tree, Mapping)):
        for k, v in tree.items():
            _flatten_into(v, f"{prefix}{k}/", out)
    elif kind is tuple or kind is list or (kind not in _LEAF_TYPES and isinstance(tree, (tuple, list))):
        for i, v in enumerate(tree):
            _flatten_into(v, f"{prefix}{i}/", out)
    else:
        out[prefix.rstrip("/")] = tree if hasattr(tree, "dtype") and hasattr(tree, "shape") else np.asarray(tree)


# the nesting of each set of leaf names seen, its leaves the names (a tree
# has few layouts; the cache is dropped if it ever grows past the bound)
_UNFLATTEN_PLANS: Dict[tuple, Any] = {}
_UNFLATTEN_PLANS_MAX = 1024


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree`: a level whose keys are exactly the
    unpadded indices 0..n-1 becomes a tuple."""
    names = tuple(flat)
    plan = _UNFLATTEN_PLANS.get(names)
    if plan is None:
        if len(_UNFLATTEN_PLANS) >= _UNFLATTEN_PLANS_MAX:
            _UNFLATTEN_PLANS.clear()
        plan = _UNFLATTEN_PLANS[names] = _nest(names)
    return _fill(plan, flat)


def _nest(names: Iterable[str]) -> Any:
    """The nesting of ``names`` (dicts and tuples), each leaf its name."""
    nested: Dict[str, Any] = {}
    for name in names:
        parts = name.split("/")
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = name

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() and str(int(k)) == k for k in node) and set(node) == {
            str(i) for i in range(len(node))
        }:
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(nested)


def _fill(plan: Any, flat: Mapping[str, Any]) -> Any:
    kind = type(plan)
    if kind is str:
        return flat[plan]
    if kind is dict:
        return {k: _fill(v, flat) for k, v in plan.items()}
    return tuple(_fill(v, flat) for v in plan)


# -- rollout wire narrowing ----------------------------------------------------
#
# With wire_dtype="bfloat16", f32 leaves off the pinned list narrow to bf16
# and integer leaves whose config bound fits narrow to int8/int16; the
# in-band "__wire_cast__" entry lists each narrowed leaf as
# "name=orig_dtype", and decode(upcast=True) restores the original dtypes
# exactly. behavior_logp, rewards, dones, values and the initial carries
# stay f32 whatever the wire.

ROLLOUT_WIRE_DTYPES = ("float32", "bfloat16")
_ROLLOUT_PINNED_NAMES = frozenset({"behavior_logp", "rewards", "dones", "values"})
_ROLLOUT_PINNED_PREFIXES = ("carry0/",)

# in-band pseudo-entries, intercepted by name at decode
_WIRE_CAST_MARKER = "__wire_cast__"
_TRACE_MARKER = "__trace__"
# the native codec's entry table (this package's and the JAX package's)
# holds at most this many entries; a payload past it raises
_MAX_TENSORS = 64


def rollout_leaf_pinned(name: str) -> bool:
    """True iff this rollout leaf must cross the wire at full width."""
    return name in _ROLLOUT_PINNED_NAMES or name.startswith(_ROLLOUT_PINNED_PREFIXES)


def rollout_int_bounds(config) -> Dict[str, int]:
    """Max values the config guarantees for integer-like rollout leaves:
    what licenses their exact int8/int16 narrowing."""
    bounds = {f"actions/{head}": size - 1 for head, size in config.actions.head_sizes.items()}
    bounds["obs/hero_id"] = config.model.n_hero_ids - 1
    # unit handles are sim-assigned identities; the encode verifies the
    # range before casting
    bounds["obs/unit_handles"] = np.iinfo(np.int16).max
    return bounds


def rollout_wire_kwargs(config) -> Dict[str, Any]:
    """The encode kwargs this config's rollout wire needs: ``{}`` for a
    full-width wire."""
    if config.transport.rollout_wire_dtype == "float32":
        return {}
    return dict(wire_dtype=config.transport.rollout_wire_dtype, int_bounds=rollout_int_bounds(config))


def rollout_cast_plan(
    specs: Mapping[str, Any],
    wire_dtype: str,
    int_bounds: Optional[Mapping[str, int]] = None,
) -> Dict[str, str]:
    """``leaf name -> narrow dtype name`` for the leaves that change on the
    wire. ``specs`` maps flat leaf names to dtype names."""
    if wire_dtype not in ROLLOUT_WIRE_DTYPES:
        raise ValueError(
            f"unknown rollout_wire_dtype {wire_dtype!r} (expected one of {ROLLOUT_WIRE_DTYPES})"
        )
    if wire_dtype == "float32":
        return {}
    plan: Dict[str, str] = {}
    for name, dname in specs.items():
        if rollout_leaf_pinned(name) or dname == BF16:
            continue
        dtype = np.dtype(dname)
        if dtype == np.float32:
            plan[name] = BF16
        elif dtype.kind == "i" and int_bounds and name in int_bounds:
            bound = int(int_bounds[name])
            if 0 <= bound <= np.iinfo(np.int8).max and dtype.itemsize > 1:
                plan[name] = "int8"
            elif 0 <= bound <= np.iinfo(np.int16).max and dtype.itemsize > 2:
                plan[name] = "int16"
    return plan


def _cast_leaf(a: Any, narrow: str) -> Any:
    """One leaf at its narrow dtype: a host bf16 leaf as a ``torch.bfloat16``
    CPU tensor (rounded as ``ml_dtypes`` rounds), a device tensor cast on
    its device, an int leaf by ``astype`` / ``to`` (callers verify the
    bound first)."""
    if isinstance(a, torch.Tensor):
        if narrow == BF16 and a.device.type == "cpu":
            return _own_bits_as_bf16(f32_to_bf16_bits(_to_f32(a)))
        return a.to(getattr(torch, narrow))
    if narrow == BF16:
        return _own_bits_as_bf16(f32_to_bf16_bits(_to_f32(a)))
    return np.asarray(a).astype(narrow)


def apply_cast_plan(flat: Mapping[str, Any], plan: Mapping[str, str]) -> Dict[str, Any]:
    """A :func:`rollout_cast_plan` applied to a flat leaf dict, the one
    place the cast lands: the host encode, the ring's narrow store and the
    device collect all come here, so the actor, the ring and the wire agree
    on every dtype. Leaves are numpy arrays or torch tensors (on any
    device); leaves off the plan pass through."""
    return {n: (_cast_leaf(a, plan[n]) if n in plan else a) for n, a in flat.items()}


_CAST_PLAN_CACHE: Dict[tuple, tuple] = {}


def _narrow_rollout_flat(
    flat: Dict[str, Any], wire_dtype: str, int_bounds: Optional[Mapping[str, int]]
) -> Tuple[Dict[str, Any], Optional[bytes]]:
    """Apply the cast plan; returns ``(flat', marker blob or None)``. Plan
    and marker are memoized per (names, dtypes, wire dtype, bounds); an int
    leaf is verified against its bound before it narrows."""
    if wire_dtype == "float32":
        return flat, None
    names = tuple((n, _dtype_name(a)) for n, a in flat.items())
    key = (names, wire_dtype, tuple(sorted(int_bounds.items())) if int_bounds else None)
    cached = _CAST_PLAN_CACHE.get(key)
    if cached is None:
        plan = rollout_cast_plan(dict(names), wire_dtype, int_bounds)
        dnames = dict(names)
        marker = "\n".join(f"{n}={dnames[n]}" for n in plan).encode() if plan else None
        _CAST_PLAN_CACHE[key] = cached = (plan, marker)
    plan, marker = cached
    if not plan:
        return flat, None
    for name, narrow in plan.items():
        if narrow == BF16:
            continue
        arr = np.asarray(flat[name])
        info = np.iinfo(narrow)
        if arr.size and (arr.min() < info.min or arr.max() > info.max):
            raise ValueError(
                f"rollout leaf {name!r} exceeds its declared int bound ({info.max}): observed range "
                f"[{arr.min()}, {arr.max()}] does not fit {info.dtype}"
            )
    return apply_cast_plan(flat, plan), marker


def _parse_cast_marker(blob: bytes) -> Dict[str, str]:
    """Marker blob -> ``{leaf name: original dtype name}``."""
    cast: Dict[str, str] = {}
    for line in blob.decode().split("\n"):
        if line:
            name, _, orig = line.partition("=")
            cast[name] = orig
    return cast


def _upcast_flat(flat: Dict[str, Any], cast: Mapping[str, str]) -> Dict[str, Any]:
    """Restore narrowed leaves to their original dtypes (exact)."""
    for name, orig in cast.items():
        arr = flat.get(name)
        if arr is None:
            continue
        if isinstance(arr, torch.Tensor):
            flat[name] = _to_f32(arr).astype(orig)
        else:
            flat[name] = arr.astype(orig)
    return flat


# -- tensors ---------------------------------------------------------------------


def tensor_to_proto(a: Any) -> "pb.TensorProto":
    """One leaf (numpy array, or CPU tensor; bf16 as ``torch.bfloat16``)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            bits = bf16_tensor_to_bits(a)
            return pb.TensorProto(shape=list(bits.shape), dtype=BF16, data=bits.tobytes())
        a = a.detach().cpu().numpy()
    arr = np.ascontiguousarray(a)
    return pb.TensorProto(shape=list(arr.shape), dtype=arr.dtype.name, data=arr.tobytes())


def proto_to_tensor(t: "pb.TensorProto") -> Any:
    """A ``TensorProto`` -> numpy array (a bf16 leaf -> ``torch.bfloat16``)."""
    shape = tuple(t.shape)
    if t.dtype == BF16:
        return bits_to_bf16_tensor(np.frombuffer(t.data, np.uint16).reshape(shape))
    return np.frombuffer(t.data, dtype=np.dtype(t.dtype)).reshape(shape).copy()


def _raise_too_many_tensors(n_entries: int, side: str) -> None:
    raise ValueError(
        f"rollout payload carries {n_entries} tensor entries at {side}; the native wire codec's entry "
        f"table holds at most {_MAX_TENSORS}: flatten fewer leaves"
    )


# -- rollouts (and the serve lane's requests and replies) --------------------------


def encode_rollout(
    arrays: Any,
    model_version: int,
    env_id: int,
    rollout_id: int,
    length: int,
    total_reward: float,
    wire_dtype: str = "float32",
    int_bounds: Optional[Mapping[str, int]] = None,
    trace: Optional[bytes] = None,
) -> "pb.Rollout":
    """Serialize one tree of host arrays. ``wire_dtype="bfloat16"`` narrows
    per :func:`rollout_cast_plan` and adds the ``__wire_cast__`` entry;
    ``trace`` rides as the ``__trace__`` entry."""
    r = pb.Rollout(
        model_version=model_version,
        env_id=env_id,
        rollout_id=rollout_id,
        length=length,
        total_reward=total_reward,
    )
    flat, marker = _narrow_rollout_flat(flatten_tree(arrays), wire_dtype, int_bounds)
    n_entries = len(flat) + (marker is not None) + (trace is not None)
    if n_entries > _MAX_TENSORS:
        _raise_too_many_tensors(n_entries, "encode")
    for name, arr in flat.items():
        r.arrays[name].CopyFrom(tensor_to_proto(arr))
    if marker is not None:
        r.arrays[_WIRE_CAST_MARKER].CopyFrom(pb.TensorProto(shape=[len(marker)], dtype="marker", data=marker))
    if trace is not None:
        r.arrays[_TRACE_MARKER].CopyFrom(pb.TensorProto(shape=[len(trace)], dtype="marker", data=trace))
    return r


def decode_rollout(r: "pb.Rollout", upcast: bool = False) -> Tuple[Dict[str, Any], Any]:
    """Deserialize -> (meta, tree of arrays). Narrowed leaves keep their
    wire dtypes unless ``upcast``; the marker lands in ``meta["wire_cast"]``
    and a trace entry in ``meta["trace_blob"]``."""
    meta: Dict[str, Any] = {
        "model_version": r.model_version,
        "env_id": r.env_id,
        "rollout_id": r.rollout_id,
        "length": r.length,
        "total_reward": r.total_reward,
    }
    flat: Dict[str, Any] = {}
    cast: Dict[str, str] = {}
    for name, t in r.arrays.items():
        if name == _WIRE_CAST_MARKER:
            cast = _parse_cast_marker(t.data)
        elif name == _TRACE_MARKER:
            meta["trace_blob"] = t.data
        else:
            flat[name] = proto_to_tensor(t)
    if cast:
        meta["wire_cast"] = cast
        if upcast:
            flat = _upcast_flat(flat, cast)
    return meta, unflatten_tree(flat)


# -- the native codec -----------------------------------------------------------------
#
# The C structs of native/rollout_codec.cc as numpy records: the decoder
# fills a table of TensorEntry rows (one a thread, read back in one
# ``tolist``), the encoder reads a table of EncodeTensor rows built once a
# rollout layout (``_SPEC_CACHE``: names, dtypes, shapes, lengths) with
# only the data pointers written a call. ``align=True`` is the C compiler's
# layout, checked against ctypes at each native encode.

_ENTRY_DTYPE = np.dtype([
    ("name_off", "<u4"), ("name_len", "<u4"), ("dtype_off", "<u4"), ("dtype_len", "<u4"),
    ("data_off", "<u4"), ("data_len", "<u4"), ("shape", "<i4", (8,)), ("ndim", "<i4"),
])
_ENC_DTYPE = np.dtype([
    ("name_off", "<u4"), ("name_len", "<u4"), ("dtype_off", "<u4"), ("dtype_len", "<u4"),
    ("data_ptr", "<u8"), ("data_len", "<u8"), ("shape", "<i4", (8,)), ("ndim", "<i4"),
], align=True)
_DTYPE_CACHE: Dict[str, np.dtype] = {}
_SPEC_CACHE: Dict[tuple, tuple] = {}
_tls = threading.local()

# every call of encode_rollout_bytes / decode_rollout_bytes, by the path it
# took: "native_encodes" and "native_decodes" ran the C codec,
# "proto_fallbacks" asked for it and ran protobuf (no library, a malformed
# payload, a leaf past 8 dims); native=False calls are not counted
CODEC_CALLS: Dict[str, int] = {"native_encodes": 0, "native_decodes": 0, "proto_fallbacks": 0}
_calls_lock = threading.Lock()


def _count(kind: str) -> None:
    with _calls_lock:
        CODEC_CALLS[kind] += 1


def codec_calls() -> Dict[str, int]:
    """A copy of ``CODEC_CALLS``."""
    with _calls_lock:
        return dict(CODEC_CALLS)


def _native_lib():
    return native_build.load_library()


def _decode_state() -> tuple:
    """This thread's decoder table and header, with their ctypes pointers
    made once."""
    state = getattr(_tls, "decode", None)
    if state is None:
        entries = np.zeros(_MAX_TENSORS, _ENTRY_DTYPE)
        hdr = native_build.RolloutHeader()
        state = _tls.decode = (entries, entries.ctypes.data_as(ctypes.POINTER(native_build.TensorEntry)), hdr,
                               ctypes.byref(hdr))
    return state


def _wire_dtype(name: str) -> np.dtype:
    """A wire dtype string as the numpy dtype its bytes are read as (bf16
    as its uint16 bits)."""
    dtype = _DTYPE_CACHE.get(name)
    if dtype is None:
        dtype = _DTYPE_CACHE[name] = np.dtype(np.uint16 if name == BF16 else name)
    return dtype


def _decode_native(lib, payload, upcast: bool) -> Optional[Tuple[Dict[str, Any], Any]]:
    """One C pass over ``payload``; None when the decoder finds it
    malformed (the protobuf parser then has the last word)."""
    entries, entries_ptr, hdr, hdr_ref = _decode_state()
    # c_void_p takes bytes as they are; any other buffer by its address
    # (kept alive by ``payload``)
    src = payload if isinstance(payload, bytes) else ctypes.c_void_p(np.frombuffer(payload, np.uint8).ctypes.data)
    n = lib.dota_decode_rollout(src, len(payload), hdr_ref, entries_ptr, _MAX_TENSORS)
    if n == -2:
        # the entry table overflowed: raise with the real count when
        # protobuf reads the payload; else its own parse error decides
        r = pb.Rollout()
        try:
            r.ParseFromString(bytes(payload))
        except Exception:  # noqa: BLE001 - not a Rollout: the protobuf path raises for it
            return None
        _raise_too_many_tensors(len(r.arrays), "decode")
    if n < 0:
        return None
    flat: Dict[str, Any] = {}
    cast: Dict[str, str] = {}
    meta: Dict[str, Any] = {"model_version": hdr.model_version, "env_id": hdr.env_id,
                            "rollout_id": hdr.rollout_id, "length": hdr.length, "total_reward": hdr.total_reward}
    for name_off, name_len, dtype_off, dtype_len, data_off, data_len, shape, ndim in entries[:n].tolist():
        name = str(payload[name_off:name_off + name_len], "utf-8")
        if name == _WIRE_CAST_MARKER:
            cast = _parse_cast_marker(bytes(payload[data_off:data_off + data_len]))
            continue
        if name == _TRACE_MARKER:
            meta["trace_blob"] = bytes(payload[data_off:data_off + data_len])
            continue
        dname = str(payload[dtype_off:dtype_off + dtype_len], "ascii")
        dtype = _wire_dtype(dname)
        count = data_len // dtype.itemsize
        # an empty tensor's data field may be absent (protobuf omits empty
        # bytes), and the C parser leaves its offset as it found it
        arr = np.frombuffer(payload, dtype=dtype, count=count, offset=data_off if data_len else 0)
        if ndim != 1 or shape[0] != count:
            arr = arr.reshape(shape[:ndim])
        if dname == BF16:
            arr = bits_to_bf16_tensor(arr)   # the one copy: the port's host bf16 is a tensor
        flat[name] = arr
    if cast:
        meta["wire_cast"] = cast
        meta["wire_bytes"] = len(payload)
        raw = len(payload) - _wire_cast_overhead(cast)
        for name, orig in cast.items():
            if name in flat:
                raw += _leaf_raw_delta(name, tuple(flat[name].shape), _dtype_name(flat[name]), orig)
        meta["raw_bytes"] = raw
        if upcast:
            flat = _upcast_flat(flat, cast)
    return meta, unflatten_tree(flat)


def _encode_native(lib, flat: Dict[str, Any], marker: Optional[bytes], trace: Optional[bytes],
                   header: tuple) -> Optional[memoryview]:
    """One C pass writing the payload from the leaves' buffers; None when a
    leaf has more than 8 dims (the protobuf path takes it)."""
    if _ENC_DTYPE.itemsize != ctypes.sizeof(native_build.EncodeTensor):
        raise ValueError(f"EncodeTensor ABI mismatch: numpy row {_ENC_DTYPE.itemsize} bytes, C struct "
                         f"{ctypes.sizeof(native_build.EncodeTensor)}")
    names, arrs, dnames = [], [], []
    for name, a in flat.items():
        # the leaf as tensor_to_proto sees it: a bf16 tensor by its bits, a
        # tensor by its numpy view, a 0-d leaf as shape (1,)
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.bfloat16:
                arr, dname = np.ascontiguousarray(bf16_tensor_to_bits(a)), BF16
            else:
                arr = np.ascontiguousarray(a.detach().cpu().numpy())
                dname = _dtype_name(arr)
        else:
            arr = np.ascontiguousarray(a)
            dname = _dtype_name(arr)
        if arr.ndim > 8:
            return None
        names.append(name)
        arrs.append(arr)
        dnames.append(dname)
    for name, blob in ((_WIRE_CAST_MARKER, marker), (_TRACE_MARKER, trace)):
        if blob is not None:
            names.append(name)
            arrs.append(np.frombuffer(blob, np.uint8))
            dnames.append("marker")
    key = tuple((name, dname, a.shape) for name, dname, a in zip(names, dnames, arrs))
    cached = _SPEC_CACHE.get(key)
    if cached is None:
        specs = np.zeros(len(key), _ENC_DTYPE)
        pieces, pos, cap = [], 0, 64
        for i, (name, dname, shape) in enumerate(key):
            nb, db = name.encode(), dname.encode()
            pieces += [nb, db]
            specs["name_off"][i], specs["name_len"][i] = pos, len(nb)
            specs["dtype_off"][i], specs["dtype_len"][i] = pos + len(nb), len(db)
            pos += len(nb) + len(db)
            specs["data_len"][i] = arrs[i].nbytes
            specs["shape"][i, :len(shape)] = shape
            specs["ndim"][i] = len(shape)
            cap += arrs[i].nbytes + len(nb) + len(db) + 128
        cached = _SPEC_CACHE[key] = (specs, b"".join(pieces), cap)
    template, strings, cap = cached
    specs = template.copy()   # concurrent encoders do not share the table
    specs["data_ptr"] = [a.ctypes.data for a in arrs]
    hdr = native_build.RolloutHeader(*header)
    spec_ptr = specs.ctypes.data_as(ctypes.POINTER(native_build.EncodeTensor))
    out = np.empty(cap, np.uint8)
    written = lib.dota_encode_rollout(ctypes.byref(hdr), strings, spec_ptr, len(key), out.ctypes.data, cap)
    if written > cap:   # the estimate fell short: once more at the size the writer asked for
        out = np.empty(written, np.uint8)
        written = lib.dota_encode_rollout(ctypes.byref(hdr), strings, spec_ptr, len(key), out.ctypes.data,
                                          written)
    del arrs   # kept the leaves' buffers alive across the C calls
    if written < 0:
        raise ValueError("the native encoder refused the rollout (a leaf's rank out of range)")
    return out[:written].data


def encode_rollout_bytes(
    arrays: Any,
    model_version: int,
    env_id: int,
    rollout_id: int,
    length: int,
    total_reward: float,
    native: bool = True,
    wire_dtype: str = "float32",
    int_bounds: Optional[Mapping[str, int]] = None,
    trace: Optional[bytes] = None,
):
    """One rollout straight to wire bytes (bytes-like). With ``native`` the
    C encoder writes it from the leaves' buffers and a memoryview comes
    back; it parses to what :func:`encode_rollout` builds. The narrowing,
    the bound check and the entry ceiling are :func:`encode_rollout`'s."""
    if native:
        lib = _native_lib()
        if lib is not None:
            flat, marker = _narrow_rollout_flat(flatten_tree(arrays), wire_dtype, int_bounds)
            n_entries = len(flat) + (marker is not None) + (trace is not None)
            if n_entries > _MAX_TENSORS:
                _raise_too_many_tensors(n_entries, "encode")
            out = _encode_native(lib, flat, marker, trace,
                                 (model_version, env_id, rollout_id, length, total_reward))
            if out is not None:
                _count("native_encodes")
                return out
        _count("proto_fallbacks")
    return encode_rollout(arrays, model_version, env_id, rollout_id, length, total_reward, wire_dtype=wire_dtype,
                          int_bounds=int_bounds, trace=trace).SerializeToString()


def decode_rollout_bytes(payload, native: bool = True, upcast: bool = False) -> Tuple[Dict[str, Any], Any]:
    """Decode a serialized ``Rollout`` (bytes, or any buffer: the shm lane
    hands memoryviews into its ring). A narrowed payload's meta also gets
    ``wire_bytes`` and ``raw_bytes``; its leaves keep their wire dtypes
    unless ``upcast``. With ``native`` the C decoder's numpy leaves view
    ``payload`` (bf16 leaves are copied into tensors)."""
    if not isinstance(payload, (bytes, bytearray, memoryview)):
        payload = bytes(payload)
    if native:
        lib = _native_lib()
        if lib is not None:
            out = _decode_native(lib, payload, upcast)
            if out is not None:
                _count("native_decodes")
                return out
        _count("proto_fallbacks")
    r = pb.Rollout()
    r.ParseFromString(payload if isinstance(payload, bytes) else bytes(payload))
    if len(r.arrays) > _MAX_TENSORS:
        _raise_too_many_tensors(len(r.arrays), "decode")
    meta, arrays = decode_rollout(r, upcast=upcast)
    if meta.get("wire_cast"):
        meta["wire_bytes"] = len(payload)
        raw = len(payload) - _wire_cast_overhead(meta["wire_cast"])
        for name, orig in meta["wire_cast"].items():
            if name in r.arrays:   # `in` first: a map's __getitem__ inserts
                t = r.arrays[name]
                raw += _leaf_raw_delta(name, tuple(t.shape), t.dtype, orig)
        meta["raw_bytes"] = raw
    return meta, arrays


# -- wire byte accounting ----------------------------------------------------------


def _varint_size(n: int) -> int:
    """Bytes a proto3 varint of ``n`` occupies."""
    size = 1
    while n > 0x7F:
        n >>= 7
        size += 1
    return size


def _itemsize(dtype_name: str) -> int:
    return 2 if dtype_name == BF16 else np.dtype(dtype_name).itemsize


def _wire_cast_overhead(cast: Mapping[str, str]) -> int:
    """The exact wire footprint of the ``__wire_cast__`` entry (a
    full-width payload has none, so ``raw_bytes`` leaves it out): a
    TensorProto {shape=[blob_len], dtype="marker", data=blob} in a map
    entry in Rollout field 6, every tag one byte."""
    blob_len = sum(len(n) + 1 + len(o) for n, o in cast.items()) + max(0, len(cast) - 1)
    packed = _varint_size(blob_len)
    tensor = 1 + _varint_size(packed) + packed + 1 + 1 + len("marker") + 1 + _varint_size(blob_len) + blob_len
    key = len(_WIRE_CAST_MARKER)
    entry = 1 + _varint_size(key) + key + 1 + _varint_size(tensor) + tensor
    return 1 + _varint_size(entry) + entry


def _leaf_raw_delta(name: str, shape, narrow_name: str, orig_name: str) -> int:
    """The exact wire-byte difference between a leaf's full-width and narrow
    map entries: the data shrinks, the dtype string changes length, and
    every length varint may change width."""
    n = 1
    for d in shape:
        n *= int(d)
    packed = sum(_varint_size(int(d)) for d in shape)
    shape_field = (1 + _varint_size(packed) + packed) if len(shape) else 0
    key = len(name)

    def entry_total(dtype_name: str) -> int:
        dlen = n * _itemsize(dtype_name)
        ds = len(dtype_name)
        tensor = shape_field + 1 + _varint_size(ds) + ds + 1 + _varint_size(dlen) + dlen
        e = 1 + _varint_size(key) + key + 1 + _varint_size(tensor) + tensor
        return 1 + _varint_size(e) + e

    return entry_total(orig_name) - entry_total(narrow_name)


def decode_drained_payloads(payloads: Iterable[Any], tel, totals: List[int]) -> Tuple[list, int]:
    """Decode a transport drain's payloads with the wire byte accounting:
    ``totals`` is the server's ``[wire, raw]`` pair, updated in place.
    Returns ``(decoded (meta, arrays) pairs, malformed count)``: a payload
    that does not decode (a version-skewed actor, a port scanner) is
    counted and dropped. Items are payloads or ``(recv_ts, payload)``
    pairs, as the transports drain them. With a tracer configured, a traced
    payload gets its ``recv`` (the pair's stamp) and ``consume`` hops in
    ``meta["trace"]``; without one, a drain pays one pointer test."""
    tracer = tracing.get()
    out = []
    bad = 0
    wire = raw = 0
    for item in payloads:
        recv_ts, p = item if isinstance(item, tuple) else (None, item)
        try:
            meta, arrays = decode_rollout_bytes(p)
        except Exception:  # noqa: BLE001 - a malformed payload never kills the learner
            bad += 1
            continue
        if tracer is not None and "trace_blob" in meta:
            tracing.stamp_wire_hops(meta, recv_ts)
        wire += meta.get("wire_bytes", len(p))
        raw += meta.get("raw_bytes", len(p))
        out.append((meta, arrays))
    if out:
        totals[0] += wire
        totals[1] += raw
        tel.counter("transport/rollout_bytes_total").inc(wire)
        tel.counter("transport/rollout_raw_bytes_total").inc(raw)
        if totals[0]:
            tel.gauge("transport/rollout_compression_ratio").set(totals[1] / totals[0])
    return out, bad


# -- weights ------------------------------------------------------------------------


def weights_trace(msg: "pb.ModelWeights") -> Optional[bytes]:
    """The trace blob a tracing learner put on this weights frame, or None.
    ``in`` before indexing: a protobuf map's ``__getitem__`` inserts."""
    if _TRACE_MARKER in msg.params:
        return msg.params[_TRACE_MARKER].data
    return None


def encode_weights(
    params: Any, version: int, wire_dtype: str = "float32", trace: Optional[bytes] = None
) -> "pb.ModelWeights":
    """Serialize a param tree (host arrays or CPU tensors) for the weights
    fanout. ``wire_dtype="bfloat16"`` casts f32 leaves to bf16 and lists
    them in the ``__wire_cast__`` entry; other leaves pass unchanged.
    ``trace`` (a ``tracing.weights_record`` blob) rides as the
    ``__trace__`` entry."""
    if wire_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    msg = pb.ModelWeights(version=version)
    cast_names = []
    for name, arr in flatten_tree(params).items():
        if wire_dtype == BF16 and _dtype_name(arr) == "float32":
            arr = _cast_leaf(arr, BF16)
            cast_names.append(name)
        msg.params[name].CopyFrom(tensor_to_proto(arr))
    if cast_names:
        msg.params[_WIRE_CAST_MARKER].CopyFrom(
            pb.TensorProto(dtype="marker", data="\n".join(cast_names).encode())
        )
    if trace is not None:
        msg.params[_TRACE_MARKER].CopyFrom(pb.TensorProto(dtype="marker", data=trace))
    return msg


def decode_weights(msg: "pb.ModelWeights", upcast: bool = True) -> Tuple[int, Any]:
    """A weights fanout message -> ``(version, param tree)``. With
    ``upcast`` the leaves the encoder narrowed come back f32 (exact);
    leaves that were bf16 before encode keep their dtype."""
    cast_names = frozenset()
    # `in` before indexing: a protobuf map's __getitem__ inserts
    if _WIRE_CAST_MARKER in msg.params:
        cast_names = frozenset(msg.params[_WIRE_CAST_MARKER].data.decode().split("\n"))
    flat = {}
    for name, t in msg.params.items():
        if name in (_WIRE_CAST_MARKER, _TRACE_MARKER):
            continue
        arr = proto_to_tensor(t)
        if upcast and name in cast_names and isinstance(arr, torch.Tensor):
            arr = _to_f32(arr)
        flat[name] = arr
    return msg.version, unflatten_tree(flat)

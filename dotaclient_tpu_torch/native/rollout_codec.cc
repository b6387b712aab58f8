// The rollout wire codec in one pass each way, a plain C ABI for ctypes.
//
// The port's own copy of the JAX package's native codec
// (dotaclient_tpu/native/rollout_codec.cc), the same ABI and struct layouts,
// so the two packages write and read the same bytes. Decode walks a
// serialized `Rollout` once and reports each named tensor as (offset,
// length) pairs into the caller's buffer, so Python builds numpy views over
// it with no copy and no protobuf object tree; encode writes proto3 wire
// format straight from the callers' buffers, one memcpy a tensor. The
// message is the `Rollout` of dotaclient_tpu_torch/protos/dota.proto:
//
//   message TensorProto { repeated int32 shape = 1; string dtype = 2;
//                         bytes data = 3; }
//   message Rollout     { int32 model_version = 1; int32 env_id = 2;
//                         uint64 rollout_id = 3; int32 length = 4;
//                         float total_reward = 5;
//                         map<string, TensorProto> arrays = 6; }
//
// Build: python -m dotaclient_tpu_torch.native.build   (g++ -O2 -shared
// -fPIC -std=c++17, into dotaclient_tpu_torch/native/_build/).

#include <cstdint>
#include <cstring>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  void skip(uint64_t n) {
    if (static_cast<uint64_t>(end - p) < n) { ok = false; return; }
    p += n;
  }

  // Skip one field of the given wire type (after its tag was read).
  void skip_field(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); break;                    // varint
      case 1: skip(8); break;                     // fixed64
      case 2: skip(varint()); break;              // length-delimited
      case 5: skip(4); break;                     // fixed32
      default: ok = false;
    }
  }
};

}  // namespace

extern "C" {

// One decoded tensor entry: name and data are (offset, len) into the input
// buffer; shape is materialized (tensors are at most rank 4 here; 8 is slack).
struct TensorEntry {
  uint32_t name_off, name_len;
  uint32_t dtype_off, dtype_len;
  uint32_t data_off, data_len;
  int32_t shape[8];
  int32_t ndim;
};

struct RolloutHeader {
  int32_t model_version;
  int32_t env_id;
  uint64_t rollout_id;
  int32_t length;
  float total_reward;
};

// Parse one TensorProto body [p, p+len) relative to base buffer `base`.
static bool parse_tensor(const uint8_t* base, const uint8_t* p,
                         const uint8_t* end, TensorEntry* t) {
  Cursor c{p, end};
  t->ndim = 0;
  t->dtype_len = t->data_len = 0;
  while (c.ok && c.p < c.end) {
    uint64_t tag = c.varint();
    uint32_t field = tag >> 3, wt = tag & 7;
    if (field == 1 && wt == 2) {          // packed shape
      uint64_t n = c.varint();
      const uint8_t* stop = c.p + n;
      if (stop > c.end) return false;
      while (c.ok && c.p < stop && t->ndim < 8)
        t->shape[t->ndim++] = static_cast<int32_t>(c.varint());
      if (c.p != stop) return false;      // >8 dims unsupported
    } else if (field == 1 && wt == 0) {   // unpacked shape element
      if (t->ndim < 8) t->shape[t->ndim++] = static_cast<int32_t>(c.varint());
      else return false;
    } else if (field == 2 && wt == 2) {   // dtype
      uint64_t n = c.varint();
      t->dtype_off = static_cast<uint32_t>(c.p - base);
      t->dtype_len = static_cast<uint32_t>(n);
      c.skip(n);
    } else if (field == 3 && wt == 2) {   // data
      uint64_t n = c.varint();
      t->data_off = static_cast<uint32_t>(c.p - base);
      t->data_len = static_cast<uint32_t>(n);
      c.skip(n);
    } else {
      c.skip_field(wt);
    }
  }
  return c.ok;
}

// Decode a serialized Rollout. Returns the number of tensors found, or -1 on
// malformed input, or -2 if `max_entries` is too small. Header fields are
// written to *hdr.
int32_t dota_decode_rollout(const uint8_t* buf, uint64_t buf_len,
                            RolloutHeader* hdr, TensorEntry* entries,
                            int32_t max_entries) {
  Cursor c{buf, buf + buf_len};
  hdr->model_version = hdr->env_id = hdr->length = 0;
  hdr->rollout_id = 0;
  hdr->total_reward = 0.0f;
  int32_t count = 0;
  while (c.ok && c.p < c.end) {
    uint64_t tag = c.varint();
    if (!c.ok) return -1;
    uint32_t field = tag >> 3, wt = tag & 7;
    if (field == 1 && wt == 0) {
      hdr->model_version = static_cast<int32_t>(c.varint());
    } else if (field == 2 && wt == 0) {
      hdr->env_id = static_cast<int32_t>(c.varint());
    } else if (field == 3 && wt == 0) {
      hdr->rollout_id = c.varint();
    } else if (field == 4 && wt == 0) {
      hdr->length = static_cast<int32_t>(c.varint());
    } else if (field == 5 && wt == 5) {
      if (c.end - c.p < 4) return -1;
      std::memcpy(&hdr->total_reward, c.p, 4);
      c.skip(4);
    } else if (field == 6 && wt == 2) {   // map entry: key=1, value=2
      uint64_t n = c.varint();
      const uint8_t* stop = c.p + n;
      if (!c.ok || stop > c.end) return -1;
      if (count >= max_entries) return -2;
      TensorEntry* t = &entries[count];
      t->name_off = t->name_len = 0;
      Cursor m{c.p, stop};
      bool have_value = false;
      while (m.ok && m.p < m.end) {
        uint64_t mtag = m.varint();
        uint32_t mf = mtag >> 3, mwt = mtag & 7;
        if (mf == 1 && mwt == 2) {        // key
          uint64_t kn = m.varint();
          t->name_off = static_cast<uint32_t>(m.p - buf);
          t->name_len = static_cast<uint32_t>(kn);
          m.skip(kn);
        } else if (mf == 2 && mwt == 2) { // value: TensorProto
          uint64_t vn = m.varint();
          if (m.p + vn > m.end) return -1;
          if (!parse_tensor(buf, m.p, m.p + vn, t)) return -1;
          m.skip(vn);
          have_value = true;
        } else {
          m.skip_field(mwt);
        }
      }
      if (!m.ok || !have_value) return -1;
      ++count;
      c.p = stop;
    } else {
      c.skip_field(wt);
    }
  }
  return c.ok ? count : -1;
}

// ---------------------------------------------------------------------------
// Encoder: the actor→learner direction. Python hands one EncodeTensor per
// flattened pytree leaf (pointers into live numpy buffers — zero staging
// copies); the writer emits proto3 wire format that python-protobuf (and the
// decoder above) parse identically. Scalar header fields follow proto3
// default-omission, so byte streams match python-protobuf's own encoding of
// the same message modulo map-entry order (maps are unordered by contract).

// Filled on the Python side as ONE numpy structured array (per-field ctypes
// assignment is ~10x the cost of the whole C call); names/dtypes are offsets
// into a single concatenated strings blob, tensor payloads raw addresses of
// the (pinned) numpy buffers.
struct EncodeTensor {
  uint32_t name_off, name_len;    // into `strings`
  uint32_t dtype_off, dtype_len;  // into `strings`
  uint64_t data_ptr, data_len;    // raw buffer address
  int32_t shape[8];
  int32_t ndim;
};

namespace {

inline uint32_t varint_size(uint64_t v) {
  uint32_t n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

struct Writer {
  uint8_t* p;

  void varint(uint64_t v) {
    while (v >= 0x80) { *p++ = static_cast<uint8_t>(v) | 0x80; v >>= 7; }
    *p++ = static_cast<uint8_t>(v);
  }
  void tag(uint32_t field, uint32_t wire_type) {
    varint((static_cast<uint64_t>(field) << 3) | wire_type);
  }
  void bytes(const uint8_t* src, uint64_t n) {
    std::memcpy(p, src, n);
    p += n;
  }
};

// Sizes of the variable-length pieces, computed once and reused by the
// writer so the output is laid down in one forward pass.
struct TensorSizes {
  uint64_t shape_payload;  // packed varints of the dims
  uint64_t tensor_body;    // TensorProto body (shape + dtype + data fields)
  uint64_t entry_body;     // map-entry body (key + value fields)
};

void tensor_sizes(const EncodeTensor& t, TensorSizes* s) {
  s->shape_payload = 0;
  for (int32_t i = 0; i < t.ndim; ++i)
    s->shape_payload += varint_size(static_cast<uint64_t>(
        static_cast<int64_t>(t.shape[i])));
  s->tensor_body = 0;
  if (t.ndim > 0)
    s->tensor_body += 1 + varint_size(s->shape_payload) + s->shape_payload;
  s->tensor_body += 1 + varint_size(t.dtype_len) + t.dtype_len;
  s->tensor_body += 1 + varint_size(t.data_len) + t.data_len;
  s->entry_body = 1 + varint_size(t.name_len) + t.name_len +
                  1 + varint_size(s->tensor_body) + s->tensor_body;
}

}  // namespace

// Encode a Rollout. Returns the exact number of bytes required; the output
// is written only when `cap` is sufficient (call once with cap=0 to size, or
// overprovision and accept the returned length). Returns -1 on invalid
// input (ndim out of range).
int64_t dota_encode_rollout(const RolloutHeader* hdr, const uint8_t* strings,
                            const EncodeTensor* tensors, int32_t n_tensors,
                            uint8_t* out, uint64_t cap) {
  uint64_t need = 0;
  if (hdr->model_version != 0)
    need += 1 + varint_size(static_cast<uint64_t>(
        static_cast<int64_t>(hdr->model_version)));
  if (hdr->env_id != 0)
    need += 1 + varint_size(static_cast<uint64_t>(
        static_cast<int64_t>(hdr->env_id)));
  if (hdr->rollout_id != 0) need += 1 + varint_size(hdr->rollout_id);
  if (hdr->length != 0)
    need += 1 + varint_size(static_cast<uint64_t>(
        static_cast<int64_t>(hdr->length)));
  if (hdr->total_reward != 0.0f) need += 1 + 4;
  for (int32_t i = 0; i < n_tensors; ++i) {
    if (tensors[i].ndim < 0 || tensors[i].ndim > 8) return -1;
    TensorSizes s;
    tensor_sizes(tensors[i], &s);
    need += 1 + varint_size(s.entry_body) + s.entry_body;
  }
  if (need > cap) return static_cast<int64_t>(need);

  Writer w{out};
  // proto3 varints encode negative int32 as 10-byte two's complement; the
  // int64_t casts above/below reproduce that (header ids are never negative
  // in practice, but wire compatibility should not depend on it).
  if (hdr->model_version != 0) {
    w.tag(1, 0);
    w.varint(static_cast<uint64_t>(static_cast<int64_t>(hdr->model_version)));
  }
  if (hdr->env_id != 0) {
    w.tag(2, 0);
    w.varint(static_cast<uint64_t>(static_cast<int64_t>(hdr->env_id)));
  }
  if (hdr->rollout_id != 0) {
    w.tag(3, 0);
    w.varint(hdr->rollout_id);
  }
  if (hdr->length != 0) {
    w.tag(4, 0);
    w.varint(static_cast<uint64_t>(static_cast<int64_t>(hdr->length)));
  }
  if (hdr->total_reward != 0.0f) {
    w.tag(5, 5);
    std::memcpy(w.p, &hdr->total_reward, 4);
    w.p += 4;
  }
  for (int32_t i = 0; i < n_tensors; ++i) {
    const EncodeTensor& t = tensors[i];
    TensorSizes s;
    tensor_sizes(t, &s);
    w.tag(6, 2);                       // map entry
    w.varint(s.entry_body);
    w.tag(1, 2);                       // key
    w.varint(t.name_len);
    w.bytes(strings + t.name_off, t.name_len);
    w.tag(2, 2);                       // value: TensorProto
    w.varint(s.tensor_body);
    if (t.ndim > 0) {
      w.tag(1, 2);                     // packed shape
      w.varint(s.shape_payload);
      for (int32_t d = 0; d < t.ndim; ++d)
        w.varint(static_cast<uint64_t>(static_cast<int64_t>(t.shape[d])));
    }
    w.tag(2, 2);                       // dtype
    w.varint(t.dtype_len);
    w.bytes(strings + t.dtype_off, t.dtype_len);
    w.tag(3, 2);                       // data
    w.varint(t.data_len);
    w.bytes(reinterpret_cast<const uint8_t*>(t.data_ptr), t.data_len);
  }
  return static_cast<int64_t>(w.p - out);
}

}  // extern "C"

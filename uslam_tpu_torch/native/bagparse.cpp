// Native rosbag v2.0 hot-path parsing.
//
// The reference's data loader is ROS C++ (rosbag storage + TCPROS
// deserialization behind every subscriber, reference batch.py:319-326).
// This is the equivalent native layer here: Python handles file IO, chunk
// decompression (stdlib bz2) and schema discovery; these functions do the
// per-record and per-message byte crunching that dominates on real bags
// (a 1 h dive is ~10^6 records).
//
// Build: g++ -O2 -shared -fPIC bagparse.cpp -o libuslam_bagparse.so, run at
// first use by uslam_tpu_torch/native/__init__.py into uslam_tpu_torch/_build/
// (the JAX package's uslam_tpu/native/bagparse.cpp, copied unchanged below).

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Finds a field "name=" inside a record header [p, p+len); returns value
// pointer + length, or nullptr.
const uint8_t* find_field(const uint8_t* p, int64_t len, const char* name,
                          int64_t name_len, int64_t* out_len) {
  const uint8_t* end = p + len;
  while (p + 4 <= end) {
    uint32_t flen = rd_u32(p);
    p += 4;
    if (p + flen > end) return nullptr;
    if (flen > (uint32_t)name_len &&
        std::memcmp(p, name, name_len) == 0 && p[name_len] == '=') {
      *out_len = flen - name_len - 1;
      return p + name_len + 1;
    }
    p += flen;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Scan all records in a (decompressed chunk or top-level) buffer.
// Outputs per record: op, conn (-1 if absent), time seconds (0 if absent),
// header offset/len and data offset/len relative to buf. Returns record
// count (capped at cap).
int64_t bag_scan_records(const uint8_t* buf, int64_t len, int64_t cap,
                         int64_t* ops, int64_t* conns, double* times,
                         int64_t* h_off, int64_t* h_len,
                         int64_t* d_off, int64_t* d_len) {
  int64_t n = 0;
  int64_t pos = 0;
  while (pos + 8 <= len && n < cap) {
    uint32_t hlen = rd_u32(buf + pos);
    int64_t hstart = pos + 4;
    if (hstart + hlen + 4 > len) break;
    int64_t dlen_pos = hstart + hlen;
    uint32_t dlen = rd_u32(buf + dlen_pos);
    int64_t dstart = dlen_pos + 4;
    if (dstart + dlen > len) break;

    const uint8_t* hp = buf + hstart;
    int64_t vlen = 0;
    const uint8_t* v = find_field(hp, hlen, "op", 2, &vlen);
    ops[n] = (v && vlen >= 1) ? v[0] : 0;
    v = find_field(hp, hlen, "conn", 4, &vlen);
    conns[n] = (v && vlen >= 4) ? (int64_t)rd_u32(v) : -1;
    v = find_field(hp, hlen, "time", 4, &vlen);
    times[n] = (v && vlen >= 8)
                   ? (double)rd_u32(v) + 1e-9 * (double)rd_u32(v + 4)
                   : 0.0;
    h_off[n] = hstart;
    h_len[n] = hlen;
    d_off[n] = dstart;
    d_len[n] = dlen;
    ++n;
    pos = dstart + dlen;
  }
  return n;
}

// Op-program message decoder. Decodes n_msgs messages at offs[i] (absolute
// into buf), each writing exactly out_w doubles to out[i*out_w..]. The
// program is (opcode, arg) pairs:
//   0: skip arg bytes
//   1: skip a length-prefixed string (arg unused)
//   2: read ros time (2x u32) -> 1 double (seconds)
//   3: read arg float64 -> arg doubles
//   4: read arg float32 -> arg doubles
// Returns number of successfully decoded messages (stops at first overrun).
int64_t bag_decode_fixed(const uint8_t* buf, int64_t buf_len,
                         const int64_t* offs, const int64_t* lens,
                         int64_t n_msgs, const int64_t* prog,
                         int64_t prog_pairs, int64_t out_w, double* out) {
  for (int64_t i = 0; i < n_msgs; ++i) {
    const uint8_t* p = buf + offs[i];
    const uint8_t* end = p + lens[i];
    if (offs[i] < 0 || offs[i] + lens[i] > buf_len) return i;
    double* o = out + i * out_w;
    int64_t wrote = 0;
    for (int64_t k = 0; k < prog_pairs; ++k) {
      int64_t opc = prog[2 * k], arg = prog[2 * k + 1];
      switch (opc) {
        case 0:
          p += arg;
          break;
        case 1: {
          if (p + 4 > end) return i;
          p += 4 + rd_u32(p);
          break;
        }
        case 2: {
          if (p + 8 > end) return i;
          o[wrote++] = (double)rd_u32(p) + 1e-9 * (double)rd_u32(p + 4);
          p += 8;
          break;
        }
        case 3: {
          if (p + 8 * arg > end) return i;
          std::memcpy(o + wrote, p, 8 * arg);
          wrote += arg;
          p += 8 * arg;
          break;
        }
        case 4: {
          if (p + 4 * arg > end) return i;
          for (int64_t j = 0; j < arg; ++j) {
            float f;
            std::memcpy(&f, p + 4 * j, 4);
            o[wrote++] = (double)f;
          }
          p += 4 * arg;
          break;
        }
        default:
          return i;
      }
      if (p > end || wrote > out_w) return i;
    }
  }
  return n_msgs;
}

}  // extern "C"

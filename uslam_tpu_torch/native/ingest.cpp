// Native ingestion kernels for the sequence loader.
//
// The reference's transport/ingestion layer is C++ (ROS message_filters
// ApproximateTimeSynchronizer + nodelet plumbing, reference batch.py:321-326
// via roscpp). Here the corresponding host-side runtime work — the
// approximate time join, per-interval IMU sample slicing, and landmark id
// interning — runs as plain C over contiguous arrays, callable via ctypes.
// The port's main path keeps its numpy time join (io/timesync.py) and
// packing (graph/packing.py); these functions are held equal to them by
// tests/test_torch_surface.py.
//
// Build: g++ -O2 -shared -fPIC ingest.cpp -o libuslam_ingest.so, run at
// first use by uslam_tpu_torch/native/__init__.py into uslam_tpu_torch/_build/
// (the JAX package's uslam_tpu/native/ingest.cpp, copied unchanged below).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Greedy in-order approximate time join (semantics of
// message_filters.ApproximateTimeSynchronizer with slop, for sorted
// streams; mirrors io/timesync.py::approximate_time_join with two
// non-pivot streams).
//
// Returns number of accepted triples; writes pivot/other indices.
int64_t approx_time_join2(
    const double* pivot, int64_t n_pivot,
    const double* s1, int64_t n1,
    const double* s2, int64_t n2,   // pass n2 = 0 to join only one stream
    double slop,
    int64_t* out_pivot, int64_t* out_i1, int64_t* out_i2) {
  int64_t c1 = 0, c2 = 0, n_out = 0;
  const bool have2 = n2 > 0;
  for (int64_t p = 0; p < n_pivot; ++p) {
    const double t = pivot[p];
    // nearest unconsumed in stream 1
    int64_t lo1 = c1;
    while (lo1 + 1 < n1 && s1[lo1 + 1] <= t) ++lo1;
    int64_t j1 = lo1;
    if (lo1 + 1 < n1 && std::fabs(s1[lo1 + 1] - t) < std::fabs(s1[lo1] - t))
      j1 = lo1 + 1;
    if (j1 < c1) j1 = c1;
    if (j1 >= n1) break;
    int64_t j2 = -1;
    if (have2) {
      int64_t lo2 = c2;
      while (lo2 + 1 < n2 && s2[lo2 + 1] <= t) ++lo2;
      j2 = lo2;
      if (lo2 + 1 < n2 && std::fabs(s2[lo2 + 1] - t) < std::fabs(s2[lo2] - t))
        j2 = lo2 + 1;
      if (j2 < c2) j2 = c2;
      if (j2 >= n2) break;
    }
    double mn = t, mx = t;
    mn = std::fmin(mn, s1[j1]); mx = std::fmax(mx, s1[j1]);
    if (have2) { mn = std::fmin(mn, s2[j2]); mx = std::fmax(mx, s2[j2]); }
    if (mx - mn <= slop) {
      out_pivot[n_out] = p;
      out_i1[n_out] = j1;
      out_i2[n_out] = have2 ? j2 : -1;
      ++n_out;
      c1 = j1 + 1;
      if (have2) c2 = j2 + 1;
    }
  }
  return n_out;
}

// Intern arbitrary int64 ids to dense rows in first-appearance order.
// rows[i] = dense row of ids[i]; returns number of unique ids.
int64_t intern_ids(const int64_t* ids, int64_t n, int64_t* rows) {
  std::unordered_map<int64_t, int64_t> map;
  map.reserve(static_cast<size_t>(n) * 2 + 16);
  int64_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto it = map.find(ids[i]);
    if (it == map.end()) {
      map.emplace(ids[i], next);
      rows[i] = next++;
    } else {
      rows[i] = it->second;
    }
  }
  return next;
}

// Pad per-interval IMU samples: for interval i in [0, n_int), copy rows
// [lo[i], min(lo[i]+S, hi[i])) of the (T, 6) imu array into out[i, :, :6]
// and dt into out[i, :, 6]; zero-pad the rest. out shape (n_int, S, 7).
void pack_imu_intervals(
    const double* imu, int64_t T,
    const int64_t* lo, const int64_t* hi, int64_t n_int,
    int64_t S, double dt,
    double* out, double* mask) {
  std::memset(out, 0, sizeof(double) * static_cast<size_t>(n_int) * S * 7);
  for (int64_t i = 0; i < n_int; ++i) {
    int64_t a = lo[i], b = hi[i];
    if (b - a > S) b = a + S;
    int64_t cnt = b > a ? b - a : 0;
    for (int64_t s = 0; s < cnt; ++s) {
      const double* src = imu + (a + s) * 6;
      double* dst = out + (i * S + s) * 7;
      std::memcpy(dst, src, sizeof(double) * 6);
      dst[6] = dt;
    }
    mask[i] = cnt > 0 ? 1.0 : 0.0;
  }
}

}  // extern "C"

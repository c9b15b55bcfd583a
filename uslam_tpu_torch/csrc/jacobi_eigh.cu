// Eigendecomposition of a batch of small symmetric matrices by cyclic Jacobi.
//
// Replaces the symmetric eigensolver of the JAX package's online window step:
// `jnp.linalg.eigh` in uslam_tpu/solvers/fixed_lag.py `_window_step_core`
// (:677), which XLA compiles into the same device program as the rest of the
// keyframe. It has no Pallas counterpart. The port needs its own because
// `torch.linalg.eigh` checks its status on the host, so no CUDA graph can hold
// it; this kernel reads and writes nothing on the host.
//
// What it computes: for each (n, n) matrix A of the batch (n <= 32, float32 or
// float64; only its lower triangle is read, as `eigh` reads it), eigenvalues
// w ascending and the orthonormal V with A = V diag(w) V^T, column k of V
// belonging to w[k]; and the sweeps it ran. Ties keep their index order.
//
// Algorithm: the matrix is padded to even m (a zero row and column) and swept
// by round-robin ("chess tournament") ordering: each of a sweep's m - 1
// rounds rotates m / 2 disjoint pairs (p, q) at once, with the rotation that
// zeroes a_pq (Rutishauser's formulas: theta = (a_qq - a_pp) / (2 a_pq), t =
// sign(theta) / (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c;
// t = 0 where a_pq = 0), applied to the rows, then the columns of A and V,
// and a_pq set to 0. Before each sweep a matrix stops if its off-diagonal
// norm is <= eps ||A||_F (eps the type's machine epsilon, the norm of the
// input), or after `max_sweeps`: both deterministic. Every product, sum,
// quotient and root is rounded on its own (the _rn intrinsics, no
// contraction into FMAs), in the order of the plain version
// (uslam_tpu_torch/solvers/eig.py `sym_eigh_plain`), so the two agree bit for
// bit wherever they stop after the same sweep.
//
// What bounds it on an H100: the chain of dependent rounds. The main path
// sends one 15 x 15 float32 matrix per keyframe: 0.9 KB in and out, and a
// few 10^4-10^5 flops, nanoseconds at the card's rates; but its (m - 1) x
// sweeps rounds depend on each other. A round's latency is what the design
// cuts:
// - One warp per matrix (m <= 32: a lane per column), A and V in the warp's
//   own slice of shared memory (padded rows: no bank conflict down a
//   column). A block holds several warps, each with its own matrix, and
//   never synchronizes as a block: only __syncwarp inside the sweep loop.
// - A round is two warp barriers. First the (c, s) chain, one lane per
//   pair; then one fused pass: the round's pairs cut A into (m / 2)^2
//   disjoint 2 x 2 blocks (rows of pair k, columns of pair l), and the lane
//   that owns a block reads its four entries once, applies pair k's row
//   rotation, then pair l's column rotation to the rotated values (the
//   plain version's rows-then-columns order, each operation rounded on its
//   own), and writes a_pq = a_qp = 0 itself on a diagonal block (k = l). V's
//   2 x 2 block of the same rows and columns gets pair l's column rotation
//   in the same pass. The pairs' (c, s) and indices reach the block owners
//   by warp shuffles; a lane reads both of its blocks (m = 16: 64 blocks,
//   two a lane) before it writes either, so their reads overlap, and a lane
//   without a block works on the padding column, so the pass has no branch.
// - One warp leaves no latency hidden, so the round's chain is kept short:
//   a lane's blocks are divided out once per launch and the pairs' indices
//   advance by one per round (no integer division in the sweep loop), and a
//   pair whose a_pq is zero (the padded row's, once a round at n = 15)
//   takes c = 1, s = 0 without the chain's quotient by zero, which would
//   send the warp down the division's slow path.
// - The stop test sums A's squares in a fixed order (one column per lane,
//   then a shuffle tree), so every matrix stops after the same sweep at
//   every launch.
// Loads read the input's lower triangle row by row (consecutive lanes,
// consecutive addresses, eight of a lane's in flight at once: all of them
// for n <= 16); stores write w and each row of V the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr size_t kMaxShared = 48 * 1024;   // static limit without an opt-in

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float mag(float a) { return fabsf(a); }
  static constexpr float kEps = 1.1920928955078125e-07f;
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double mag(double a) { return fabs(a); }
  static constexpr double kEps = 2.220446049250313e-16;
};

// torch.sort's order: ascending, NaN last.
template <typename T>
__device__ __forceinline__ bool before(T a, T b) {
  return a < b || (isnan(b) && !isnan(a));
}

template <typename T>
__device__ __forceinline__ bool same(T a, T b) {
  return a == b || (isnan(a) && isnan(b));
}

// Sums over A (m x m, row stride ld) of the squares, all entries and the
// off-diagonal ones: lane j adds down column j, then a shuffle tree adds the
// lanes in a fixed order; every lane returns lane 0's totals.
template <typename T>
__device__ void squares(const T* A, int m, int ld, int lane, T* all, T* off) {
  using R = Rn<T>;
  T s = 0, o = 0;
  if (lane < m) {
    for (int i = 0; i < m; ++i) {
      const T x = A[i * ld + lane];
      const T sq = R::mul(x, x);
      s = R::add(s, sq);
      if (i != lane) o = R::add(o, sq);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    s = R::add(s, __shfl_down_sync(kFull, s, d));
    o = R::add(o, __shfl_down_sync(kFull, o, d));
  }
  *all = __shfl_sync(kFull, s, 0);
  *off = __shfl_sync(kFull, o, 0);
}

// (c, s) of the rotation that zeroes a_pq, from the current A. A zero a_pq
// gives t = 0, so c = 1 / sqrt(0 * 0 + 1) = 1 and s = 0 * 1 = +0 exactly:
// taken without the chain, whose quotient by zero would send the whole
// warp down the division's slow path (the padded row meets one pair in
// every round).
template <typename T>
__device__ __forceinline__ void rotation(const T* A, int ld, int p, int q, T* c, T* s) {
  using R = Rn<T>;
  const T apq = A[p * ld + q], app = A[p * ld + p], aqq = A[q * ld + q];
  if (apq == T(0)) {
    *c = T(1);
    *s = T(0);
    return;
  }
  const T theta = R::div(R::add(aqq, -app), R::mul(T(2), apq));
  const T sgn = theta >= T(0) ? T(1) : T(-1);
  const T t = R::div(sgn, R::add(R::mag(theta), R::root(R::add(R::mul(theta, theta), T(1)))));
  *c = R::div(T(1), R::root(R::add(R::mul(t, t), T(1))));
  *s = R::mul(t, *c);
}

// (c x - s y, s x + c y), each product and sum rounded on its own.
template <typename T>
__device__ __forceinline__ void rotate(T c, T s, T x, T y, T* u, T* v) {
  using R = Rn<T>;
  *u = R::add(R::mul(c, x), -R::mul(s, y));
  *v = R::add(R::mul(s, x), R::mul(c, y));
}

// The fused pass over two of this lane's 2 x 2 blocks, `own` (k | l << 8,
// or -1: none). Every lane runs the same instructions, with no branch: a
// lane without a block reads and writes the rows' padding column m, which
// nothing else reads. The four entries of A and of V of both blocks are
// read before either is written (the blocks are disjoint, which the
// compiler cannot see); then A's get pair k's row rotation and pair l's
// column rotation, V's pair l's column rotation.
template <typename T>
__device__ __forceinline__ void pass2(T* A, T* V, int m, int ld, T c, T s, int pq,
                                      const int own[2]) {
  T ck[2], sk[2], cl[2], sl[2], a[2][4], v[2][4];
  int idx[2][4];
  bool diag[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool live = own[j] >= 0;
    const int k = live ? own[j] & 0xff : 0, l = live ? own[j] >> 8 : 0;
    diag[j] = live && k == l;
    ck[j] = __shfl_sync(kFull, c, k);
    sk[j] = __shfl_sync(kFull, s, k);
    cl[j] = __shfl_sync(kFull, c, l);
    sl[j] = __shfl_sync(kFull, s, l);
    const int pk = __shfl_sync(kFull, pq, k), pl = __shfl_sync(kFull, pq, l);
    const int rp = (pk & 0xff) * ld, rq = (pk >> 8) * ld;
    const int cp = live ? pl & 0xff : m, cq = live ? pl >> 8 : m;
    idx[j][0] = rp + cp;
    idx[j][1] = rp + cq;
    idx[j][2] = rq + cp;
    idx[j][3] = rq + cq;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[j][e] = A[idx[j][e]];
      v[j][e] = V[idx[j][e]];
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    T x11, x12, x21, x22, y11, y12, y21, y22;  // rows p, q of pair k; columns p, q of pair l
    rotate(ck[j], sk[j], a[j][0], a[j][2], &x11, &x21);   // the rows
    rotate(ck[j], sk[j], a[j][1], a[j][3], &x12, &x22);
    rotate(cl[j], sl[j], x11, x12, &y11, &y12);           // then the columns
    rotate(cl[j], sl[j], x21, x22, &y21, &y22);
    if (diag[j]) y12 = y21 = T(0);                        // a diagonal block: a_pq = a_qp = 0
    T z11, z12, z21, z22;
    rotate(cl[j], sl[j], v[j][0], v[j][1], &z11, &z12);
    rotate(cl[j], sl[j], v[j][2], v[j][3], &z21, &z22);
    A[idx[j][0]] = y11;
    A[idx[j][1]] = y12;
    A[idx[j][2]] = y21;
    A[idx[j][3]] = y22;
    V[idx[j][0]] = z11;
    V[idx[j][1]] = z12;
    V[idx[j][2]] = z21;
    V[idx[j][3]] = z22;
  }
}

// kGroups: pairs of 2 x 2 blocks per lane, 1 for m <= 16 (the main path's
// 15 x 15: 64 blocks), 4 for m <= 32.
template <typename T, int kGroups>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
jacobi_eigh_kernel(const T* __restrict__ in, T* __restrict__ w_out, T* __restrict__ v_out,
                   int32_t* __restrict__ sweeps_out, int batch, int n, int max_sweeps) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char shared[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mat = blockIdx.x * (blockDim.x >> 5) + warp;
  if (mat >= batch) return;  // no block barrier anywhere: a warp without a matrix leaves
  const int m = n + (n & 1), half = m / 2, ld = m + 1;
  T* A = reinterpret_cast<T*>(shared) + static_cast<size_t>(warp) * 2 * m * ld;
  T* V = A + m * ld;
  const size_t base = static_cast<size_t>(mat) * n * n;
  const T* a = in + base;

  // The lower triangle, mirrored: eight loads in flight per lane before
  // any is stored (n = 15: all of them), not one load latency each.
  for (int t0 = 0; t0 < n * n; t0 += 8 * 32) {
    T x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + u * 32 + lane;
      x[u] = t < n * n ? a[t] : T(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + u * 32 + lane, i = t / n, j = t % n;
      if (t < n * n && i >= j) {
        A[i * ld + j] = x[u];
        A[j * ld + i] = x[u];
      }
    }
  }
  for (int t = lane; t < m * m; t += 32) {
    const int i = t / m, j = t % m;
    if (i >= n || j >= n) A[i * ld + j] = T(0);
    V[i * ld + j] = i == j ? T(1) : T(0);
  }
  // This lane's blocks (k, l) = divmod(b, m / 2), b = lane, lane + 32, ...:
  // the same in every round, so divided out once.
  const int blocks = half * half;
  int own[2 * kGroups];
#pragma unroll
  for (int j = 0; j < 2 * kGroups; ++j) {
    const int b = j * 32 + lane;
    own[j] = b < blocks ? (b / half) | ((b % half) << 8) : -1;
  }
  __syncwarp();
  T all, off;
  squares(A, m, ld, lane, &all, &off);
  const T tol2 = R::mul(R::mul(R::kEps, R::kEps), all);
  bool stop = off <= tol2;

  int sweep = 0;
  while (!stop && sweep < max_sweeps) {
    // Round-robin pairs: pair 0 is (m - 1, r); pair k > 0 is ((r + k) mod
    // (m - 1), (r - k) mod (m - 1)), each index one more (mod m - 1) per round.
    int pr = lane, qr = m - 1 - lane;
    for (int r = 0; r < m - 1; ++r) {
      T c = 0, s = 0;
      int pq = 0;
      if (lane < half) {
        int p = lane ? pr : m - 1, q = lane ? qr : r;
        if (p > q) {
          const int x = p;
          p = q;
          q = x;
        }
        rotation(A, ld, p, q, &c, &s);
        pq = p | (q << 8);
      }
      pr = pr + 1 == m - 1 ? 0 : pr + 1;
      qr = qr + 1 == m - 1 ? 0 : qr + 1;
      __syncwarp();  // every (c, s) read its entries before any block is written
#pragma unroll
      for (int g = 0; g < kGroups; ++g) pass2(A, V, m, ld, c, s, pq, own + 2 * g);
      __syncwarp();  // the round's writes before the next round's reads
    }
    ++sweep;
    squares(A, m, ld, lane, &all, &off);
    stop = off <= tol2;
  }

  int k = 0;
  if (lane < n) {
    const T wj = A[lane * ld + lane];
    for (int i = 0; i < n; ++i) {
      const T wi = A[i * ld + i];
      k += before(wi, wj) || (i < lane && same(wi, wj));
    }
    w_out[static_cast<size_t>(mat) * n + k] = wj;
    for (int i = 0; i < n; ++i) v_out[base + i * n + k] = V[i * ld + lane];
  }
  if (lane == 0) sweeps_out[mat] = sweep;
}

template <typename T>
int launch(const void* a, void* w, void* v, void* sweeps, int batch, int n, int max_sweeps,
           cudaStream_t stream) {
  const int m = n + (n & 1);
  const size_t per_warp = 2 * static_cast<size_t>(m) * (m + 1) * sizeof(T);
  int warps = static_cast<int>(kMaxShared / per_warp);
  warps = warps < kWarpsPerBlock ? warps : kWarpsPerBlock;
  warps = warps < batch ? warps : batch;
  const int grid = (batch + warps - 1) / warps;
  const T* in = static_cast<const T*>(a);
  if (m <= 16)
    jacobi_eigh_kernel<T, 1><<<grid, 32 * warps, warps * per_warp, stream>>>(
        in, static_cast<T*>(w), static_cast<T*>(v), static_cast<int32_t*>(sweeps), batch, n,
        max_sweeps);
  else
    jacobi_eigh_kernel<T, 4><<<grid, 32 * warps, warps * per_warp, stream>>>(
        in, static_cast<T*>(w), static_cast<T*>(v), static_cast<int32_t*>(sweeps), batch, n,
        max_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: float64. a: (batch, n, n); w: (batch, n); v: (batch,
// n, n); sweeps: (batch,) int32. Returns the launch's CUDA error code.
extern "C" int uslam_jacobi_eigh(int dtype, const void* a, void* w, void* v, void* sweeps,
                                 int batch, int n, int max_sweeps, void* stream) {
  if (batch <= 0 || n < 1 || n > kMaxN || max_sweeps < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, w, v, sweeps, batch, n, max_sweeps, s);
  return launch<double>(a, w, v, sweeps, batch, n, max_sweeps, s);
}

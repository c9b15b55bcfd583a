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
// Algorithm: the matrix is padded to even m (a zero row and column, never
// rotated) and swept by round-robin ("chess tournament") ordering: each of a
// sweep's m - 1 rounds rotates m / 2 disjoint pairs (p, q) at once, with the
// rotation that zeroes a_pq (Rutishauser's formulas: theta = (a_qq - a_pp) /
// (2 a_pq), t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), c = 1 /
// sqrt(t^2 + 1), s = t c; t = 0 where a_pq = 0), applied to the rows, then the
// columns of A and V, and a_pq set to 0. Before each sweep the block stops if
// the off-diagonal norm is <= eps ||A||_F (eps the type's machine epsilon, the
// norm of the input), or after `max_sweeps`: both deterministic. Every
// product, sum, quotient and root is rounded on its own (the _rn intrinsics,
// no contraction into FMAs), in the order of the plain version
// (uslam_tpu_torch/solvers/eig.py `sym_eigh_plain`), so the two agree bit
// for bit wherever they stop after the same sweep.
//
// What bounds it on an H100: the chain of dependent rounds. The main path
// sends one 15 x 15 float32 matrix per keyframe: 0.9 KB in and out, and a
// few 10^4-10^5 flops, nanoseconds at the card's rates; but its
// (m - 1) x sweeps rounds depend on each other, each a rotation (two
// quotients, two roots) and three passes over shared memory behind barriers.
// So the design is one block per matrix, the matrix and V in shared memory
// (padded rows, no bank conflicts down a column), one thread per (pair, row)
// of a round's updates (32 x 16 threads), and nothing read from device memory
// between the first load and the last store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxPairs = kMaxN / 2;
constexpr int kThreads = kMaxN * kMaxPairs;

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

// Sum over column j (< m) of A[i][j]^2, all rows and the off-diagonal ones,
// reduced over warp 0 in a fixed order; lane 0 returns both.
template <typename T>
__device__ void squares(const T (*A)[kMaxN + 1], int m, T* all, T* off) {
  using R = Rn<T>;
  const int j = threadIdx.x;
  T s = 0, o = 0;
  if (j < m) {
    for (int i = 0; i < m; ++i) {
      const T sq = R::mul(A[i][j], A[i][j]);
      s = R::add(s, sq);
      if (i != j) o = R::add(o, sq);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    s = R::add(s, __shfl_down_sync(0xffffffffu, s, d));
    o = R::add(o, __shfl_down_sync(0xffffffffu, o, d));
  }
  *all = s;
  *off = o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_eigh_kernel(const T* __restrict__ in, T* __restrict__ w_out, T* __restrict__ v_out,
                   int32_t* __restrict__ sweeps_out, int n, int max_sweeps) {
  using R = Rn<T>;
  __shared__ T A[kMaxN][kMaxN + 1];
  __shared__ T V[kMaxN][kMaxN + 1];
  __shared__ T cs[kMaxPairs], sn[kMaxPairs];
  __shared__ int P[kMaxPairs], Q[kMaxPairs];
  __shared__ int slot[kMaxN];
  __shared__ T tol2;
  __shared__ int stop;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kMaxN + tx;
  const int m = n + (n & 1);
  const int half = m / 2;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const T* a = in + base;

  for (int t = tid; t < m * m; t += kThreads) {
    const int i = t / m, j = t % m;
    T v = 0;
    if (i < n && j < n) v = i >= j ? a[i * n + j] : a[j * n + i];
    A[i][j] = v;
    V[i][j] = i == j ? T(1) : T(0);
  }
  __syncthreads();
  if (ty == 0) {
    T all, off;
    squares(A, m, &all, &off);
    if (tx == 0) {
      tol2 = R::mul(R::mul(R::kEps, R::kEps), all);
      stop = off <= tol2;
    }
  }
  __syncthreads();

  int sweep = 0;
  while (!stop && sweep < max_sweeps) {
    for (int r = 0; r < m - 1; ++r) {
      if (tid < half) {
        int p = m - 1, q = r;
        if (tid > 0) {
          p = (r + tid) % (m - 1);
          q = (r - tid + m - 1) % (m - 1);
        }
        if (p > q) {
          const int x = p;
          p = q;
          q = x;
        }
        const T app = A[p][p], aqq = A[q][q], apq = A[p][q];
        const T theta = R::div(R::add(aqq, -app), R::mul(T(2), apq));
        const T sgn = theta >= T(0) ? T(1) : T(-1);
        T t = R::div(sgn, R::add(R::mag(theta), R::root(R::add(R::mul(theta, theta), T(1)))));
        if (apq == T(0)) t = T(0);
        const T c = R::div(T(1), R::root(R::add(R::mul(t, t), T(1))));
        P[tid] = p;
        Q[tid] = q;
        cs[tid] = c;
        sn[tid] = R::mul(t, c);
      }
      __syncthreads();
      if (ty < half && tx < m) {  // rows p, q of A: thread (column tx, pair ty)
        const int p = P[ty], q = Q[ty];
        const T c = cs[ty], s = sn[ty];
        const T ap = A[p][tx], aq = A[q][tx];
        A[p][tx] = R::add(R::mul(c, ap), -R::mul(s, aq));
        A[q][tx] = R::add(R::mul(s, ap), R::mul(c, aq));
      }
      __syncthreads();
      if (ty < half && tx < m) {  // columns p, q of A and V: thread (row tx, pair ty)
        const int p = P[ty], q = Q[ty];
        const T c = cs[ty], s = sn[ty];
        const T ap = A[tx][p], aq = A[tx][q];
        A[tx][p] = R::add(R::mul(c, ap), -R::mul(s, aq));
        A[tx][q] = R::add(R::mul(s, ap), R::mul(c, aq));
        const T vp = V[tx][p], vq = V[tx][q];
        V[tx][p] = R::add(R::mul(c, vp), -R::mul(s, vq));
        V[tx][q] = R::add(R::mul(s, vp), R::mul(c, vq));
      }
      __syncthreads();
      if (tid < half) {
        A[P[tid]][Q[tid]] = T(0);
        A[Q[tid]][P[tid]] = T(0);
      }
      __syncthreads();
    }
    ++sweep;
    if (ty == 0) {
      T all, off;
      squares(A, m, &all, &off);
      if (tx == 0) stop = off <= tol2;
    }
    __syncthreads();
  }

  if (ty == 0 && tx < n) {
    const T wj = A[tx][tx];
    int k = 0;
    for (int i = 0; i < n; ++i) {
      const T wi = A[i][i];
      k += before(wi, wj) || (i < tx && same(wi, wj));
    }
    slot[tx] = k;
    w_out[static_cast<size_t>(blockIdx.x) * n + k] = wj;
  }
  __syncthreads();
  for (int t = tid; t < n * n; t += kThreads) {
    const int i = t / n, j = t % n;
    v_out[base + i * n + slot[j]] = V[i][j];
  }
  if (tid == 0) sweeps_out[blockIdx.x] = sweep;
}

}  // namespace

// dtype 0: float32, 1: float64. a: (batch, n, n); w: (batch, n); v: (batch,
// n, n); sweeps: (batch,) int32. Returns the launch's CUDA error code.
extern "C" int uslam_jacobi_eigh(int dtype, const void* a, void* w, void* v, void* sweeps,
                                 int batch, int n, int max_sweeps, void* stream) {
  if (batch <= 0 || n < 1 || n > kMaxN || max_sweeps < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kMaxN, kMaxPairs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    jacobi_eigh_kernel<float><<<batch, block, 0, s>>>(
        static_cast<const float*>(a), static_cast<float*>(w), static_cast<float*>(v),
        static_cast<int32_t*>(sweeps), n, max_sweeps);
  else
    jacobi_eigh_kernel<double><<<batch, block, 0, s>>>(
        static_cast<const double*>(a), static_cast<double*>(w), static_cast<double*>(v),
        static_cast<int32_t*>(sweeps), n, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}

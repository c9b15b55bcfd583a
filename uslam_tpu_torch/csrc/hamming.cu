// Batched Hamming distance matrices between 256-bit rBRIEF descriptors.
//
// Replaces the TPU kernel uslam_tpu/frontend/pallas_kernels.py
// `_hamming_kernel` (pallas_call in `hamming_matrix_pallas`), reached from
// uslam_tpu/frontend/match.py `hamming_distance_matrix` for every stereo and
// temporal match.
//
// What it computes: out[f, i, j] = sum over the 8 32-bit words w of
// popcount(a[f, i, w] ^ b[f, j, w]), for (B, Na, 8) x (B, Nb, 8) -> (B, Na, Nb)
// int32. The words arrive as int32 bit-views of the uint32 descriptors.
//
// What bounds it on an H100: launch latency. On the main path one launch
// takes both matrices of a chunk, B = 16 frames (8 stereo, 8 temporal) of
// 48 x 48 descriptors: 49 KB in, 147 KB out, 0.06 us at 3.35 TB/s, far
// below the few microseconds any launch costs. So the design makes the one
// launch finish in one short wave: one 256-thread block per frame matrix
// (per 64 x 64 tile of it), which stages its descriptors in shared memory
// with 16-byte loads (2 per descriptor); each thread then computes a 1 x 4
// patch of distances (XOR + __popc on words read as uint4) and writes it
// with one 16-byte store. The loops step by the block's shape: no integer
// division per element. Fusing the mutual/ratio match that consumes the
// distances is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // descriptors of A (and of B) per block
constexpr int kTx = 16;    // threads across the 16 groups of 4 columns
constexpr int kTy = 16;    // threads down the rows

__device__ __forceinline__ int dist(const uint4 (&a)[2], const uint4* b) {
  const uint4 b0 = b[0], b1 = b[1];
  return __popc(a[0].x ^ b0.x) + __popc(a[0].y ^ b0.y) + __popc(a[0].z ^ b0.z) +
         __popc(a[0].w ^ b0.w) + __popc(a[1].x ^ b1.x) + __popc(a[1].y ^ b1.y) +
         __popc(a[1].z ^ b1.z) + __popc(a[1].w ^ b1.w);
}

__global__ void __launch_bounds__(kTx * kTy)
hamming_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
               int32_t* __restrict__ out, int Na, int Nb) {
  __shared__ uint4 sa[kTile][2], sb[kTile][2];
  const int f = blockIdx.x;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.z * kTile;
  const int na = min(kTile, Na - i0), nb = min(kTile, Nb - j0);
  const int tid = threadIdx.y * kTx + threadIdx.x;

  const uint4* ga = a + (static_cast<size_t>(f) * Na + i0) * 2;
  const uint4* gb = b + (static_cast<size_t>(f) * Nb + j0) * 2;
  for (int t = tid; t < 2 * na; t += kTx * kTy) (&sa[0][0])[t] = ga[t];
  for (int t = tid; t < 2 * nb; t += kTx * kTy) (&sb[0][0])[t] = gb[t];
  __syncthreads();

  const bool vec = (Nb & 3) == 0;
  for (int i = threadIdx.y; i < na; i += kTy) {
    const uint4 ra[2] = {sa[i][0], sa[i][1]};
    int32_t* row = out + (static_cast<size_t>(f) * Na + i0 + i) * Nb + j0;
    for (int j = 4 * threadIdx.x; j < nb; j += 4 * kTx) {
      if (vec) {  // nb is then a multiple of 4 as well
        const int4 d = make_int4(dist(ra, sb[j]), dist(ra, sb[j + 1]), dist(ra, sb[j + 2]),
                                 dist(ra, sb[j + 3]));
        *reinterpret_cast<int4*>(row + j) = d;
      } else {
        for (int q = 0; q < 4 && j + q < nb; ++q) row[j + q] = dist(ra, sb[j + q]);
      }
    }
  }
}

}  // namespace

extern "C" int uslam_hamming(const int32_t* a, const int32_t* b, int32_t* out, int B, int Na,
                             int Nb, void* stream) {
  const dim3 grid(B, (Na + kTile - 1) / kTile, (Nb + kTile - 1) / kTile);
  hamming_kernel<<<grid, dim3(kTx, kTy), 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b), out, Na, Nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uslam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

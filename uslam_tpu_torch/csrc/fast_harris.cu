// Fused FAST-9 corner test + Harris response over a batch of images.
//
// Replaces the TPU kernel uslam_tpu/frontend/pallas_kernels.py
// `_fast_harris_kernel` (pallas_call in `_fast_harris_batched`, reached from
// `fast_harris_pallas`), which the ORB front end runs on every pyramid
// level of every image (uslam_tpu/frontend/orb.py, `_extract_orb_impl`).
//
// What it computes, per pixel of a (B, H, W) float32 batch:
//   corner = FAST-9: >= 9 contiguous pixels of the radius-3 Bresenham ring
//            all brighter than centre + t, or all darker than centre - t
//            (written as one byte, 0 or 1: a torch.bool);
//   harris = det(M) - k tr(M)^2, M the 7x7 box sums of gx^2, gy^2, gx*gy,
//            (gx, gy) the 3x3 Sobel gradients.
//
// What bounds it on an H100: bytes, 9 per pixel (4 in, 4 + 1 out); a chunk
// of 8 stereo pairs at 1080p over three pyramid levels is 43.5 Mpx, 0.39 GB,
// 0.117 ms at 3.35 TB/s. The ~92 float operations a pixel needs (Sobel, two
// exact-order 7-sums of three channels, 32 FAST compares) are 0.06 ms at the
// fp32 peak, but with the FAST bit packing, the register moves and the
// addressing the kernel issues ~7 warp-instructions per output pixel, and
// instruction issue, not memory, is what holds it (PERF.md has the counts).
// So the design spends no instruction it can avoid and keeps the integer
// (ALU) pipe, which runs at half the issue rate, for the compares.
//
// Design: one warp walks down a strip of `strip_rows` rows of a 128-column
// window; each lane owns 4 adjacent columns. The warp writes the middle 120
// columns (lanes 1..30); lanes 0 and 31 only supply the Sobel products that
// the 7-wide box needs left and right. 120 divides 1920, 960 and 480.
//   - Input rows stream into a 16-row shared-memory ring by cp.async (16 B
//     per lane; 4-byte copies with clamped addresses at the image border or
//     where W % 4 != 0), kAhead rows ahead of the row being computed.
//   - Each lane keeps, in registers, the running vertical sums of its 4
//     columns for the 6 output rows whose 7-row windows are open, each
//     added top to bottom as a new product row arrives: the same order
//     as the plain version, no product computed twice inside a strip, and
//     no sliding sum (which would change the rounding). Shifting the sums
//     to the next slot costs ~72 register moves a row at the loop's end;
//     unrolling the loop to rename them instead made the body several
//     times larger and the kernel slower.
//   - The vertical sums go through one shared row (double-buffered) for the
//     horizontal 7-sum; FAST reads its 16 ring pixels from the input ring,
//     the 4 pixels of a lane sharing their 16-byte row loads; each ring bit
//     is a compare into a predicate and a predicated OR.
//   - Harris leaves in 16-byte stores, the corner flags in 4-byte stores.
// Only __syncwarp() orders the work: the warps of a block are independent.
// At most 168 registers a thread (launch bounds): 3 blocks of 4 warps an SM.
//
// Borders are read with clamped addresses; pixels within 5 px of the border
// differ from the plain version (which wraps) and the callers mask them out.
//
// Rounding: every float operation is an explicit round-to-nearest intrinsic
// in the plain PyTorch version's order (uslam_tpu_torch/frontend/fast.py:
// Sobel as ((a - b) + 2 (c - d)) + (e - f), box rows top to bottom then
// columns left to right, det - (k tr) tr), so nvcc cannot contract a
// multiply-add into an FMA and the interior output equals the plain
// version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;                  // adjacent columns per lane
constexpr int kSpan = 32 * kCols;         // 128 columns of products per warp
constexpr int kOutW = kSpan - 2 * kCols;  // 120 output columns per warp
constexpr int kRow = kSpan + 2 * kCols;   // 136 staged input columns
constexpr int kRing = 16;                 // staged input rows (power of two)
constexpr int kAhead = 6;                 // rows in flight; <= 8 for this ring
constexpr int kWarps = 4;                 // independent warps per block
constexpr int kWarpFloats = kRing * kRow + 2 * 3 * kRow;
constexpr int kSmemBytes = kWarps * kWarpFloats * 4;

static_assert(kAhead <= kRing - 8, "a prefetched row would overwrite a row in use");

// Ring offsets (dy, dx) of bit b, clockwise from 12 o'clock
// (frontend/fast.py FAST_RING), as nibble b of a constant holding dy + 3
// (dx + 3): constant-folded once the bit loop is unrolled.
__device__ __forceinline__ constexpr int ring_dy(int b) {
  return static_cast<int>((0x0123456665432100ULL >> (4 * b)) & 0xF) - 3;
}
__device__ __forceinline__ constexpr int ring_dx(int b) {
  return static_cast<int>((0x2100012345666543ULL >> (4 * b)) & 0xF) - 3;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
}

// acc | w where a > b: a compare into a predicate and a predicated OR, 2
// instructions a bit (a compare into a register is a compare and a select).
__device__ __forceinline__ int or_if_gt(float a, float b, int w, int acc) {
  asm("{\n .reg .pred q;\n setp.gt.f32 q, %1, %2;\n @q or.b32 %0, %0, %3;\n}"
      : "+r"(acc) : "f"(a), "f"(b), "r"(w));
  return acc;
}

// Nonzero where the 16-bit ring mask holds >= 9 contiguous set bits around
// the circle: bit p of the result is set where bits p - 8 .. p of
// x = mask | mask << 16 all are, and p in 16..31 covers the 16 starting
// points. The shifts are multiplies, which issue to the FMA pipe and leave
// the ALU pipe to the compares.
__device__ __forceinline__ unsigned arc9(unsigned mask) {
  const unsigned x = mask * 0x10001u;
  const unsigned r2 = x & (x * 2u);
  const unsigned r4 = r2 & (r2 * 4u);
  const unsigned r8 = r4 & (r4 * 16u);
  return r8 & (x * 256u) & 0xFFFF0000u;
}

// dst[q] <- row[clamp(x + q)], q in [0, 4), by cp.async: one 16-byte copy
// where the 4 columns lie inside the row and are 16-byte aligned (`vec`),
// else 4 copies of 4 bytes with clamped columns.
__device__ __forceinline__ void stage4(float* dst, const float* row, int x, bool vec, int W) {
  if (vec) {
    cp_async16(dst, row + x);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) cp_async4(dst + q, row + min(max(x + q, 0), W - 1));
  }
}

// v[e] <- r[s - 4 + e], e in [0, 12): three 16-byte shared loads.
__device__ __forceinline__ void load12(const float* r, int s, float (&v)[12]) {
  const float4 a = *reinterpret_cast<const float4*>(r + s - 4);
  const float4 b = *reinterpret_cast<const float4*>(r + s);
  const float4 c = *reinterpret_cast<const float4*>(r + s + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
}

// What one warp knows about its strip.
struct Strip {
  const float* im;  // the image
  uint8_t* corner;  // the image's outputs
  float* harris;
  float* ring;      // [kRing][kRow] staged input rows
  float* vbuf;      // [2][3][kRow] vertical sums
  int H, W, x_lo, y0, n_in, s, x;
  bool vec, writer;
  // Staging: lane l copies ring columns 4l .. 4l + 3 (image columns
  // x_lo + 4l ..), lanes 0 and 1 also ring columns 128 + 4l .. 131 + 4l.
  bool vec0, vec1;
  float threshold, k;
};

// Input row j of the strip (image row y0 - 4 + j, clamped) into ring row
// j % kRing.
__device__ __forceinline__ void stage_row(const Strip& st, int j) {
  const int lane = threadIdx.x & 31;
  const float* row = st.im + static_cast<size_t>(min(max(st.y0 - 4 + j, 0), st.H - 1)) * st.W;
  float* dst = st.ring + (j & (kRing - 1)) * kRow + 4 * lane;
  stage4(dst, row, st.x_lo + 4 * lane, st.vec0, st.W);
  if (lane < kRow / 4 - 32) stage4(dst + 128, row, st.x_lo + 128 + 4 * lane, st.vec1, st.W);
}

// Iteration i of a strip: product row r = y0 - 3 + i, output row
// y = r - 3 = y0 + i - 6, from input rows j = i - 5 .. i + 2 (image rows
// y - 3 .. y + 4). On entry chain[d] holds, for output row r + 2 - d, the
// sum of its first d + 1 product rows (r - 1 - d .. r - 1), added top to
// bottom; adding row r to chain[5] completes the vertical 7-sum of row y,
// and chain[d] + row r becomes chain[d + 1].
__device__ __forceinline__ void row_step(const Strip& st, int i, float (&chain)[6][3][kCols]) {
  const float* ring = st.ring;
  const int s = st.s;
  {
    const int j = i + 2 + kAhead;
    if (j < st.n_in) stage_row(st, j);
    cp_commit();
  }
  cp_wait_ahead();
  __syncwarp();

  // Sobel products of product row y + 3 from image rows y + 2 .. y + 4.
  float a[12], m[12], c[12];
  load12(ring + (i & (kRing - 1)) * kRow, s, a);
  load12(ring + ((i + 1) & (kRing - 1)) * kRow, s, m);
  load12(ring + ((i + 2) & (kRing - 1)) * kRow, s, c);
  float p[3][kCols];
  float dv[6];  // c - a at columns s - 1 .. s + 4: shared by the gy of 3 columns
#pragma unroll
  for (int e = 3; e <= 8; ++e) dv[e - 3] = __fsub_rn(c[e], a[e]);
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int e = 4 + q;  // column s + q
    const float gx = __fadd_rn(
        __fadd_rn(__fsub_rn(a[e + 1], a[e - 1]), __fmul_rn(2.0f, __fsub_rn(m[e + 1], m[e - 1]))),
        __fsub_rn(c[e + 1], c[e - 1]));
    const float gy = __fadd_rn(__fadd_rn(dv[q], __fmul_rn(2.0f, dv[q + 1])), dv[q + 2]);
    p[0][q] = __fmul_rn(gx, gx);
    p[1][q] = __fmul_rn(gy, gy);
    p[2][q] = __fmul_rn(gx, gy);
  }
  // Vertical 7-sums of output row y (valid from i = 6 on), then the shift.
  float v[3][kCols];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      v[ch][q] = __fadd_rn(chain[5][ch][q], p[ch][q]);
#pragma unroll
      for (int d = 5; d >= 1; --d) chain[d][ch][q] = __fadd_rn(chain[d - 1][ch][q], p[ch][q]);
      chain[0][ch][q] = p[ch][q];
    }
  }
  if (i < 6) return;  // the first 6 product rows only fill the chains

  // FAST-9 on image rows y - 3 .. y + 3 (ring rows i - 5 .. i + 1; rows
  // y + 2 and y + 3 are the Sobel rows a and m already loaded).
  uint32_t flags = 0;
  if (st.writer) {
    float ctr[12];
    load12(ring + ((i - 2) & (kRing - 1)) * kRow, s, ctr);
    float hi[kCols], lo[kCols];
    int bright[kCols], dark[kCols];  // ring masks
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      hi[q] = __fadd_rn(ctr[4 + q], st.threshold);
      lo[q] = __fsub_rn(ctr[4 + q], st.threshold);
      bright[q] = 0;
      dark[q] = 0;
    }
#pragma unroll
    for (int dy = -3; dy <= 3; ++dy) {
      float r[12];
#pragma unroll
      for (int e = 0; e < 12; ++e) r[e] = dy == 0 ? ctr[e] : dy == 2 ? a[e] : m[e];
      if (dy < 0 || dy == 1) load12(ring + ((i - 2 + dy) & (kRing - 1)) * kRow, s, r);
#pragma unroll
      for (int bit = 0; bit < 16; ++bit) {
        if (ring_dy(bit) != dy) continue;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const float p = r[4 + q + ring_dx(bit)];
          bright[q] = or_if_gt(p, hi[q], 1 << bit, bright[q]);
          dark[q] = or_if_gt(lo[q], p, 1 << bit, dark[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      flags |= static_cast<uint32_t>((arc9(bright[q]) | arc9(dark[q])) != 0) << (8 * q);
  }

  float* vb = st.vbuf + (i & 1) * 3 * kRow;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    *reinterpret_cast<float4*>(vb + ch * kRow + s) = make_float4(v[ch][0], v[ch][1], v[ch][2], v[ch][3]);
  __syncwarp();
  if (!st.writer) return;

  // Horizontal 7-sums, columns left to right, and the Harris response.
  float sum[3][kCols];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float v[12];
    load12(vb + ch * kRow, s, v);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      float t = v[q + 1];  // column s + q - 3
#pragma unroll
      for (int d = 2; d <= 7; ++d) t = __fadd_rn(t, v[q + d]);
      sum[ch][q] = t;
    }
  }
  float hr[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const float det = __fsub_rn(__fmul_rn(sum[0][q], sum[1][q]), __fmul_rn(sum[2][q], sum[2][q]));
    const float tr = __fadd_rn(sum[0][q], sum[1][q]);
    hr[q] = __fsub_rn(det, __fmul_rn(__fmul_rn(st.k, tr), tr));
  }

  const size_t o = static_cast<size_t>(st.y0 + i - 6) * st.W + st.x;
  if (st.vec && st.x + 3 < st.W) {
    __stcs(reinterpret_cast<float4*>(st.harris + o), make_float4(hr[0], hr[1], hr[2], hr[3]));
    __stcs(reinterpret_cast<unsigned*>(st.corner + o), flags);
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (st.x + q < st.W) {
        st.harris[o + q] = hr[q];
        st.corner[o + q] = static_cast<uint8_t>(flags >> (8 * q));
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps, 3)
fast_harris_kernel(const float* __restrict__ img, uint8_t* __restrict__ corner,
                   float* __restrict__ harris, int H, int W, int strip_rows, int n_tiles,
                   int n_strips, long long n_items, float threshold, float k) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (item >= n_items) return;  // whole warp
  const int tile = static_cast<int>(item % n_tiles);
  item /= n_tiles;
  const int strip = static_cast<int>(item % n_strips);
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t off = static_cast<size_t>(item / n_strips) * plane;

  Strip st;
  st.im = img + off;
  st.corner = corner + off;
  st.harris = harris + off;
  st.ring = reinterpret_cast<float*>(smem4) + warp * kWarpFloats;
  st.vbuf = st.ring + kRing * kRow;
  st.H = H;
  st.W = W;
  st.x_lo = tile * kOutW - 2 * kCols;  // image column of ring[.][0]
  st.y0 = strip * strip_rows;
  const int rows = min(strip_rows, H - st.y0);
  st.n_in = rows + 8;                  // input rows y0 - 4 .. y0 + rows + 3
  st.s = kCols * (lane + 1);           // ring column of this lane's first column
  st.x = st.x_lo + st.s;               // its image column
  st.vec = (W & 3) == 0;
  st.writer = lane >= 1 && lane <= 30 && st.x < W;
  const int xs0 = st.x_lo + 4 * lane, xs1 = xs0 + 128;
  st.vec0 = st.vec && xs0 >= 0 && xs0 + 3 < W;
  st.vec1 = st.vec && xs1 >= 0 && xs1 + 3 < W;
  st.threshold = threshold;
  st.k = k;
  const int n_iter = rows + 6;         // product rows y0 - 3 .. y0 + rows + 2

  // Input row j (image row y0 - 4 + j) lives in ring row j % kRing.
#pragma unroll 1
  for (int j = 0; j < kAhead + 2; ++j) {
    if (j < st.n_in) stage_row(st, j);
    cp_commit();
  }

  float chain[6][3][kCols] = {};  // running vertical sums, see row_step
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) row_step(st, i, chain);
  // Drain the (empty) copy groups still committed before the warp exits.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

// Rows per strip: long strips amortise the 8-row vertical halo; shorter
// ones where a long strip would leave too few warps to fill the card.
extern "C" int uslam_fast_harris_strip_rows(int B, int H, int W) {
  const long long tiles = (W + kOutW - 1) / kOutW;
  const long long warps32 = static_cast<long long>(B) * tiles * ((H + 31) / 32);
  return warps32 >= 132LL * 24 ? 32 : 16;
}

extern "C" int uslam_fast_harris(const float* img, uint8_t* corner, float* harris, int B, int H,
                                 int W, float threshold, float k, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(fast_harris_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    cudaFuncSetAttribute(fast_harris_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    configured = true;
  }
  const int strip_rows = uslam_fast_harris_strip_rows(B, H, W);
  const int n_tiles = (W + kOutW - 1) / kOutW;
  const int n_strips = (H + strip_rows - 1) / strip_rows;
  const long long n_items = static_cast<long long>(B) * n_strips * n_tiles;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  fast_harris_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      img, corner, harris, H, W, strip_rows, n_tiles, n_strips, n_items, threshold, k);
  return static_cast<int>(cudaGetLastError());
}

// Direct-form FIR in "high" precision (bf16x3) on the tensor cores: the FIR
// as a matrix product that mma.sync takes as it is.  Stage 1 of kernel B1
// (fused_fir_resample.cu) and, through the block run at the end of this
// file, the whole of kernels B2 (block2_fir.cu) and B4 (halo_fir_fused.cu)
// at "high".
//
// The product.  With tile width N = FIR_MMA_N = 8,
//
//   Y[m][n] = y[8m + n] = sum_k X[m][k] * W[k][n],    k < kt,
//
//   X[m][k] = xw[8m + k]             an overlapping row-major view of the x
//                                    window in shared memory with leading
//                                    dimension 8: no copy, no im2col;
//   W[k][n] = h[n - k + kt - 8]      (0 outside the taps) the (kt, 8)
//                                    Toeplitz of the taps;
//   kt      = ntaps + 7 rounded up to 16, so that every tap of every
//             column has its row; xw[i] is the sample at y's index
//             i - (kt - 8).
//
// The waste over the dense FIR is the zero corner of W, (kt - ntaps) / kt:
// 1.5 % at 1024 taps.
//
// Precision.  x is split into bf16 hi/lo when it is staged, W's hi/lo tiles
// are built from the bf16 tap tables, and every 16-row chunk of k adds
// x_hi*w_hi, then x_lo*w_hi, then x_hi*w_lo (each product exact in fp32) with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.  Two chunks (32
// taps) are summed in a fresh accumulator, which is then added to the
// total in fp32, as fir_tile.cuh adds its 32-tap partial sums: the
// tensor cores' own adds then work on small partial sums (one running sum
// over 1024 taps costs 1.5 dB of SNR on the card, PERF.md).
//
// Sum order.  An output's sum depends on the tap index and on n = its index
// mod 8 (which chunk a tap falls in).  So two blocks, calls or shards
// compute bitwise the same y for the same stream position if, and only
// if, their windows start at a multiple of 8 of the ABSOLUTE stream index:
// the caller rounds its window's origin down to one and computes the few
// extra outputs.
//
// What bounds it: the rate at which a warp can issue dependent mma.sync and
// the ldmatrix loads that feed them, not the products themselves.  A 16x16
// A fragment is one ldmatrix.x4 (rows 16 bytes apart and contiguous, so
// conflict-free) for hi and one for lo; a warp owns MT m-tiles so that one
// ldmatrix.x4 of a W chunk (hi and lo) serves them all, and so that MT
// chains of dependent products are in flight.  The A fragments of
// neighbouring chunks repeat (X[m + 2][k - 16] = X[m][k]), and a ring of
// registers that loads each 8x8 matrix once was tried: it halves the
// loads, costs 40 registers more a thread, and bought nothing (PERF.md), so
// every fragment is loaded where it is used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int FIR_MMA_N = 8;       // outputs per row of Y
constexpr int FIR_MMA_TILE = 128;  // outputs per m-tile (16 rows)
constexpr int FIR_MMA_PART = 2;    // 16-row chunks per partial sum (32 taps)

// Rows of W: every tap of every column, rounded up to whole chunks.
__host__ __device__ __forceinline__ int fir_mma_kt(int ntaps) {
  return (ntaps + FIR_MMA_N - 1 + 15) / 16 * 16;
}

// W is held transposed, wt[n][k], rows this many elements apart: 8 more
// than kt, so that the eight rows of an ldmatrix lie in eight different
// 16-byte bank groups.
__host__ __device__ __forceinline__ int fir_mma_w_stride(int kt) {
  return kt + 8;
}

// W's hi and lo tiles into shared memory, (8, kt + 8) each, from the bf16
// tap tables: wt[n][k] = taps[n - k + kt - 8], zero outside [0, ntaps).
__device__ __forceinline__ void fir_mma_stage_w(
    __nv_bfloat16* wh, __nv_bfloat16* wl,
    const __nv_bfloat16* __restrict__ taps_hi,
    const __nv_bfloat16* __restrict__ taps_lo, int ntaps, int kt, int tid,
    int nthr) {
  const int ws = fir_mma_w_stride(kt);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < FIR_MMA_N * ws; i += nthr) {
    const int n = i / ws, k = i - n * ws;
    const int j = n - k + kt - FIR_MMA_N;
    const bool tap = k < kt && j >= 0 && j < ntaps;
    wh[i] = tap ? taps_hi[j] : zero;
    wl[i] = tap ? taps_lo[j] : zero;
  }
}

// v as bf16 hi + lo: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void fir_mma_split(float v, __nv_bfloat16* hi,
                                              __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

__device__ __forceinline__ void fir_mma_ldmatrix4(uint32_t r[4],
                                                  const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void fir_mma_16816(float d[4], const uint32_t a[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT m-tiles of one warp: acc[t][.] = Y rows 16 * (tile0 + t) .. + 15, i.e.
// outputs FIR_MMA_TILE * (tile0 + t) .. + 127 of the window.  Every lane of
// the warp must call it.  Lane l holds, of tile t, outputs
//   128 * (tile0 + t) + 8 * (l / 4) + 2 * (l % 4) + {0, 1}   in acc[t][0, 1],
//   the same + 64                                            in acc[t][2, 3].
// Requires 16-byte aligned xh, xl, wh, wl; xw readable up to index
// 128 * (tile0 + MT) - 8 + kt - 1; xw[0] at a multiple of 8 of the stream.
template <int MT>
__device__ __forceinline__ void fir_mma_tiles(
    const __nv_bfloat16* __restrict__ xh, const __nv_bfloat16* __restrict__ xl,
    const __nv_bfloat16* __restrict__ wh, const __nv_bfloat16* __restrict__ wl,
    int kt, int tile0, float acc[MT][4]) {
  const int lane = threadIdx.x & 31;
  const int ws = fir_mma_w_stride(kt);
  // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) in the order of the
  // fragment's registers; lane l addresses row l % 8 of matrix l / 8
  const int a_off = FIR_MMA_TILE * tile0 + 8 * (lane & 7) +
                    ((lane >> 3) & 1) * 64 + (lane >> 4) * 8;
  // B: hi k 0-7, hi k 8-15, lo k 0-7, lo k 8-15; row n = l % 8 of wt
  const __nv_bfloat16* b_row =
      (lane < 16 ? wh : wl) + (lane & 7) * ws + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;
  const int nk = kt / 16;
  for (int c0 = 0; c0 < nk; c0 += FIR_MMA_PART) {
    float part[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[t][r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < FIR_MMA_PART; ++cc) {
      const int c = c0 + cc;
      if (c < nk) {
        uint32_t b[4];
        fir_mma_ldmatrix4(b, b_row + 16 * c);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          uint32_t ah[4], al[4];
          const int off = a_off + FIR_MMA_TILE * t + 16 * c;
          fir_mma_ldmatrix4(ah, xh + off);
          fir_mma_ldmatrix4(al, xl + off);
          fir_mma_16816(part[t], ah, b[0], b[1]);  // x_hi * w_hi
          fir_mma_16816(part[t], al, b[0], b[1]);  // x_lo * w_hi
          fir_mma_16816(part[t], ah, b[2], b[3]);  // x_hi * w_lo
        }
      }
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][r] += part[t][r];
  }
}

// ---- a block's run (kernels B2 and B4) -------------------------------------
// A CUDA block of FIR_MMA_WARPS warps keeps W for its whole life and
// computes runs of FIR_MMA_WARPS * MT m-tiles, each from its own x window:
// the window is staged with guarded loads (fir_mma_stage_window), the warps
// compute their tiles (fir_mma_tiles) and write them to y (fir_mma_run).
// Shared memory: W hi, W lo, window hi, window lo, all bf16.

constexpr int FIR_MMA_WARPS = 8;
constexpr int FIR_MMA_THREADS = 32 * FIR_MMA_WARPS;

// Outputs of one run.
__host__ __device__ constexpr int fir_mma_run_len(int mt) {
  return FIR_MMA_WARPS * mt * FIR_MMA_TILE;
}

// Samples of a run's x window: its first output reads kt - 8 samples back.
__host__ __device__ constexpr int fir_mma_window_len(int run, int kt) {
  return run + kt - FIR_MMA_N;
}

// Bytes of a block's shared memory for runs of `run` outputs.
__host__ __device__ __forceinline__ size_t fir_mma_smem_bytes(int run,
                                                              int kt) {
  return sizeof(__nv_bfloat16) *
         (2 * (size_t)FIR_MMA_N * fir_mma_w_stride(kt) +
          2 * (size_t)fir_mma_window_len(run, kt));
}

// The window of a run whose first output is stream index n0 (a multiple of
// 8 of the absolute stream index): xw[m] = sample(n0 - (kt - 8) + m), split
// into bf16 hi/lo.  sample(j) returns the sample at stream index j and 0
// where the stream holds none: every element of the window is written, so
// that a zero row of W never meets a NaN left in shared memory.
template <typename Sample>
__device__ __forceinline__ void fir_mma_stage_window(__nv_bfloat16* xh,
                                                     __nv_bfloat16* xl,
                                                     int run, int kt, int n0,
                                                     Sample sample) {
  const int lx = fir_mma_window_len(run, kt);
  const int j0 = n0 - (kt - FIR_MMA_N);
  for (int m = threadIdx.x; m < lx; m += FIR_MMA_THREADS)
    fir_mma_split(sample(j0 + m), &xh[m], &xl[m]);
}

// One run: warp w computes m-tiles w * MT .. w * MT + MT - 1 of the window
// and writes outputs n0 .. n0 + run - 1 of the row yr (t outputs long) where
// they lie below t.  A lane's fragment is pairs of consecutive outputs:
// float2 stores, 64 contiguous floats a half-tile and warp, where the row
// is 8-byte aligned.  A warp whose tiles all lie beyond t computes nothing.
// Every thread of the block must call it, between two __syncthreads().
template <int MT>
__device__ __forceinline__ void fir_mma_run(
    const __nv_bfloat16* xh, const __nv_bfloat16* xl, const __nv_bfloat16* wh,
    const __nv_bfloat16* wl, int kt, float* __restrict__ yr, int n0, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = warp * MT;
  if (n0 + FIR_MMA_TILE * tile0 >= t) return;
  float acc[MT][4];
  fir_mma_tiles<MT>(xh, xl, wh, wl, kt, tile0, acc);
  const bool pairs = (reinterpret_cast<uintptr_t>(yr) & 7u) == 0;
#pragma unroll
  for (int q = 0; q < MT; ++q) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + FIR_MMA_TILE * (tile0 + q) + 64 * half +
                    8 * (lane >> 2) + 2 * (lane & 3);
      const float a = acc[q][2 * half], b = acc[q][2 * half + 1];
      if (pairs && n + 1 < t) {
        *reinterpret_cast<float2*>(yr + n) = make_float2(a, b);
      } else {
        if (n < t) yr[n] = a;
        if (n + 1 < t) yr[n + 1] = b;
      }
    }
  }
}

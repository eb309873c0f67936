// Direct-form FIR over a shared-memory window, four consecutive outputs per
// thread; the inner loop of kernels B1 (fused_fir_resample.cu, stage 1), B2
// (block2_fir.cu) and B4 (halo_fir_fused.cu), and the staging of B2's and
// B4's taps and samples into that window.
//
// Register window: for a chunk of FIR_CHUNK taps, the four outputs read
// FIR_CHUNK + 3 consecutive inputs.  A thread loads them once (nine aligned
// float4 loads; neighbouring threads read neighbouring 16-byte words, so no
// bank conflicts) and reads the taps as broadcast float4s, then does
// 4 * FIR_CHUNK FMAs from registers: about 17 shared loads per 128 FMAs
// where one load per FMA made shared-memory bandwidth the limit.
//
// Sum order: each output sums its taps in chunks of FIR_CHUNK, in ascending
// tap order within a chunk, the chunk's partial sum added to the total in
// turn.  The order depends on the tap index alone, so an output computed by
// two blocks (a halo) or at either side of a stream split is bitwise equal;
// the chunking keeps f32 rounding ~12 dB below one running sum at 1024 taps.
//
// "high" (HIGH = true): the window and taps are bf16 hi/lo parts held as
// floats; each tap adds x_hi*h_hi, then x_lo*h_hi, then x_hi*h_lo (each
// product exact in fp32) to the partial sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int FIR_CHUNK = 32;

// Taps into shared memory, zero-padded from ntaps to ntp: th (and tl in
// "high") as floats, from the f32 vector or from the bf16 hi/lo parts.
template <bool HIGH>
__device__ __forceinline__ void fir_stage_taps(
    float* th, float* tl, const float* __restrict__ taps_f32,
    const __nv_bfloat16* __restrict__ taps_hi,
    const __nv_bfloat16* __restrict__ taps_lo, int ntaps, int ntp, int tid,
    int nthr) {
  for (int k = tid; k < ntp; k += nthr) {
    if (HIGH) {
      th[k] = k < ntaps ? __bfloat162float(taps_hi[k]) : 0.f;
      tl[k] = k < ntaps ? __bfloat162float(taps_lo[k]) : 0.f;
    } else {
      th[k] = k < ntaps ? taps_f32[k] : 0.f;
    }
  }
}

// One sample into the window: as it is, or split into bf16 hi/lo in "high".
template <bool HIGH>
__device__ __forceinline__ void fir_stage_sample(float* xh, float* xl, int m,
                                                 float v) {
  if (HIGH) {
    const float hf = __bfloat162float(__float2bfloat16_rn(v));
    xh[m] = hf;
    xl[m] = __bfloat162float(__float2bfloat16_rn(v - hf));
  } else {
    xh[m] = v;
  }
}

// acc[r] = sum_j h[j] * xw[i0 + r + ntp - 1 - j] over the ntp (zero-padded)
// taps.  Requires i0 % 4 == 0, ntp % FIR_CHUNK == 0, 16-byte aligned xh, xl,
// th, tl, and xw readable up to index i0 + ntp + 3.
template <bool HIGH>
__device__ __forceinline__ void fir_out4(const float* __restrict__ xh,
                                         const float* __restrict__ xl,
                                         const float* __restrict__ th,
                                         const float* __restrict__ tl,
                                         int ntp, int i0, float acc[4]) {
  constexpr int W = FIR_CHUNK + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < ntp; c0 += FIR_CHUNK) {
    // window w[v] = xw[start + v]; output r at chunk tap kk reads
    // w[r + FIR_CHUNK - 1 - kk]
    const int start = i0 + ntp - FIR_CHUNK - c0;
    float wh[W];
    float wl[HIGH ? W : 1];
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xh + start)[q];
      wh[4 * q] = v.x;
      wh[4 * q + 1] = v.y;
      wh[4 * q + 2] = v.z;
      wh[4 * q + 3] = v.w;
      if (HIGH) {
        const float4 u = reinterpret_cast<const float4*>(xl + start)[q];
        wl[4 * q] = u.x;
        wl[4 * q + 1] = u.y;
        wl[4 * q + 2] = u.z;
        wl[4 * q + 3] = u.w;
      }
    }
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kq = 0; kq < FIR_CHUNK / 4; ++kq) {
      const float4 h4 = reinterpret_cast<const float4*>(th + c0)[kq];
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
      float lv[4] = {0.f, 0.f, 0.f, 0.f};
      if (HIGH) {
        const float4 l4 = reinterpret_cast<const float4*>(tl + c0)[kq];
        lv[0] = l4.x;
        lv[1] = l4.y;
        lv[2] = l4.z;
        lv[3] = l4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = 4 * kq + u;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = wh[r + FIR_CHUNK - 1 - kk];
          if (HIGH) {
            part[r] = fmaf(a, hv[u], part[r]);
            part[r] = fmaf(wl[r + FIR_CHUNK - 1 - kk], hv[u], part[r]);
            part[r] = fmaf(a, lv[u], part[r]);
          } else {
            part[r] = fmaf(a, hv[u], part[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] += part[r];
  }
}

// Direct-form FIR in fp32 ("highest") over a shared-memory window, four
// consecutive outputs per thread; the inner loop of kernels B2
// (block2_fir.cu) and B4 (halo_fir_fused.cu) at "highest", and of B1's
// stage 1 (fused_fir_resample.cu, fused_highest_kernel) at the shapes its
// wgmma path does not take (a down that is no multiple of 16, long
// filters); and the staging of B2's and B4's taps.  ("high", the three
// bf16 passes, runs on the tensor cores: fir_mma.cuh; B1's wgmma path at
// both precisions: fir_wgmma.cuh.)
//
// What bounds it: the CUDA cores' fp32 FMA rate, one FMA a tap and output.
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

#pragma once

#include <cuda_runtime.h>

constexpr int FIR_CHUNK = 32;

// Taps into shared memory, zero-padded from ntaps to ntp.
__device__ __forceinline__ void fir_stage_taps(float* th,
                                               const float* __restrict__ taps,
                                               int ntaps, int ntp, int tid,
                                               int nthr) {
  for (int k = tid; k < ntp; k += nthr) th[k] = k < ntaps ? taps[k] : 0.f;
}

// acc[r] = sum_j h[j] * xw[i0 + r + ntp - 1 - j] over the ntp (zero-padded)
// taps.  Requires i0 % 4 == 0, ntp % FIR_CHUNK == 0, 16-byte aligned xw and
// th, and xw readable up to index i0 + ntp + 3.
__device__ __forceinline__ void fir_out4(const float* __restrict__ xw,
                                         const float* __restrict__ th,
                                         int ntp, int i0, float acc[4]) {
  constexpr int W = FIR_CHUNK + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < ntp; c0 += FIR_CHUNK) {
    // window w[v] = xw[start + v]; output r at chunk tap kk reads
    // w[r + FIR_CHUNK - 1 - kk]
    const int start = i0 + ntp - FIR_CHUNK - c0;
    float w[W];
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xw + start)[q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kq = 0; kq < FIR_CHUNK / 4; ++kq) {
      const float4 h4 = reinterpret_cast<const float4*>(th + c0)[kq];
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kk = 4 * kq + u;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          part[r] = fmaf(w[r + FIR_CHUNK - 1 - kk], hv[u], part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] += part[r];
  }
}

// Kernel B2: causal FIR  y[n] = sum_k h[k] * x[n - k]  on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel llzlab_tpu/kernels/block2_fir.py
// (_kernel_high / _kernel_highest, entry block2_fir_pallas).  The TPU kernel
// evaluates the banded Toeplitz product y_j = [x_{j-1} | x_j] @ W per
// 128-column tile, because its matrix unit wants dense (8,128) tiles.  Every
// entry of W is a tap or 0, so this kernel reads the taps directly and
// computes the same products without a (nt, kb, 128) table per tile.
//
// What bounds it: 2*ntaps FLOP per output sample (6*ntaps in "high")
// against 8 bytes of device memory traffic, so it is compute-bound; this
// version runs on the CUDA cores' fp32 FMA (tensor cores - mma/wgmma on
// Toeplitz tiles - are later work).  The register window of fir_tile.cuh
// keeps shared-memory loads well below one per FMA.
//
// Design:
//   * one CUDA block per (run of RUN outputs, channel); the block stages the
//     contiguous input window (RUN + ntp samples) and the taps in shared
//     memory; the history block that the caller prepends supplies the left
//     context, so blocks are independent and run in any order;
//   * each thread computes four consecutive outputs (fir_tile.cuh), whose
//     sums run over the taps in an order fixed by the tap index alone, so a
//     stream split at any block boundary is bit-exact;
//   * "highest": fp32 FMA.  "high": x is split on load into bf16 hi/lo and
//     the product is x_hi*h_hi + x_lo*h_hi + x_hi*h_lo with fp32
//     accumulation; a bf16 x bf16 product is exact in fp32, so this is what
//     the TPU's three bf16 matrix passes compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = THREADS * 4;  // outputs per CUDA block

template <bool HIGH>
__global__ void __launch_bounds__(THREADS)
block2_fir_kernel(const float* __restrict__ xpad,
                  const float* __restrict__ taps_f32,
                  const __nv_bfloat16* __restrict__ taps_hi,
                  const __nv_bfloat16* __restrict__ taps_lo,
                  float* __restrict__ y, int t, int block, int ntaps,
                  int ntp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lx = RUN + ntp;
  float* th = smem;                       // [ntp] taps (hi in "high")
  float* tl = th + ntp;                   // [ntp] taps lo ("high" only)
  float* xh = HIGH ? tl + ntp : th + ntp; // [lx] x window (hi in "high")
  float* xl = xh + lx;                    // [lx] x lo ("high" only)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * RUN;
  const int row = block + t;
  const float* xr = xpad + (size_t)b * row;

  fir_stage_taps<HIGH>(th, tl, taps_f32, taps_hi, taps_lo, ntaps, ntp, tid,
                       THREADS);
  // xw[m] = xpad[block + n0 - (ntp - 1) + m]; zero outside the row (only
  // the zero-padded taps beyond ntaps or outputs beyond t ever see those).
  const int m0 = block + n0 - (ntp - 1);
  for (int m = tid; m < lx; m += THREADS) {
    const int idx = m0 + m;
    fir_stage_sample<HIGH>(xh, xl, m,
                           (idx >= 0 && idx < row) ? xr[idx] : 0.f);
  }
  __syncthreads();

  float acc[4];
  fir_out4<HIGH>(xh, xl, th, tl, ntp, 4 * tid, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + 4 * tid + r;
    if (n < t) y[(size_t)b * t + n] = acc[r];
  }
}

}  // namespace

// xpad: (batch, block + t) f32, one history block prepended.  y: (batch, t).
// high == 0: taps_a is (ntaps,) f32.  high == 1: taps_a / taps_b are the
// (ntaps,) bf16 hi / lo parts.  Returns cudaGetLastError() after the launch.
extern "C" int block2_fir_launch(const float* xpad, const void* taps_a,
                                 const void* taps_b, float* y, int batch,
                                 int t, int block, int ntaps, int high,
                                 void* stream) {
  if (batch <= 0 || t <= 0) return (int)cudaSuccess;
  const int ntp = (ntaps + FIR_CHUNK - 1) / FIR_CHUNK * FIR_CHUNK;
  const int lx = RUN + ntp;
  const size_t smem = sizeof(float) * (size_t)(high ? 2 * ntp + 2 * lx
                                                    : ntp + lx);
  const dim3 grid((t + RUN - 1) / RUN, batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (high) {
    auto kern = block2_fir_kernel<true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, THREADS, smem, s>>>(
        xpad, nullptr, (const __nv_bfloat16*)taps_a,
        (const __nv_bfloat16*)taps_b, y, t, block, ntaps, ntp);
  } else {
    auto kern = block2_fir_kernel<false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, THREADS, smem, s>>>(xpad, (const float*)taps_a, nullptr,
                                     nullptr, y, t, block, ntaps, ntp);
  }
  return (int)cudaGetLastError();
}

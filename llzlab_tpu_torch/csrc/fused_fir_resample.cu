// Kernel B1: fused FIR -> rational polyphase resample step on an H100
// (sm_90a).
//
// Replaces the Pallas TPU kernel llzlab_tpu/kernels/fused_fir_resample.py
// (_kernel, the v3 dataflow; entry fused_fir_resample_pallas).  It computes
//
//   y[n]          = sum_{k < ntaps} h[k] * xs[n - k]                (stage 1)
//   z[s*up + p]   = sum_{tau < down+K-1} R[p, tau] * y[s*down - (K-1) + tau]
//                                                                   (stage 2)
//
// where xs is the stream (carried history of 2*block samples, then x) and R
// is the dense (up, down+K-1) polyphase bank.  Row p of R holds only K
// nonzero entries, R[p, q_p + K-1-j] = rtaps[up*j + r_p] with
// q_p = (p*down) / up, so stage 2 sums those K terms: adding the zero
// products of the dense row changes nothing, and the dense form does 3.5x
// the work at 147/160.
//
// What bounds it: stage 1 costs ntaps FMAs per input sample and stage 2
// about K*up/down, so at the headline shape (1024 taps, 147/160, K = 64)
// the FIR is ~95% of the arithmetic, and the whole step is compute-bound
// (about 4 bytes of device memory per 2 kFLOP).  This version runs on the
// CUDA cores' fp32 FMA; stage 1 uses the register window of fir_tile.cuh,
// while stage 2 still reads two shared operands per FMA.
//
// Design (the TPU's choices - 20480-sample programs, lane-aligned group
// counts, a zeroed scratch tail - answer to VMEM and do not carry over):
//   * one CUDA block per (run of GS output groups, channel); a block finds
//     its own offsets and reads its left context straight from x, or from
//     the history for negative stream indices, so blocks are independent;
//   * stage 1 computes the run's y plus the K-1 samples of left halo into
//     shared memory.  The halo recomputes what the neighbouring block also
//     computes; both copies are bitwise equal because every y[n] is summed
//     over the taps in an order that depends on nothing but the tap index
//     (fir_tile.cuh, the same order as kernel B2);
//   * stage 2 maps consecutive threads to consecutive phases p of one
//     group; the bank (stored (K, up), 37 KB in bf16 hi/lo at the headline)
//     is read through the L1 cache in coalesced rows, which leaves shared
//     memory to the x and y windows (82 KB per block in "high" at the
//     headline, so two blocks fit on an SM);
//   * the run of GS groups is sized by the caller so that its y window
//     (GS*down + K-1 samples) just fits whole passes of STEP outputs;
//   * "highest": fp32 FMA.  "high": x and y are split into bf16 hi/lo on
//     load and each product is a_hi*w_hi + a_lo*w_hi + a_hi*w_lo with fp32
//     accumulation, as the TPU kernel's three bf16 matrix passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_tile.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int STEP = THREADS * 4;           // stage-1 outputs per pass
constexpr size_t SMEM_MAX = 232448;         // 227 KB per block on sm_90

struct Geometry {
  int ntp;   // taps rounded up to FIR_CHUNK (zero taps beyond ntaps)
  int ly;    // y samples a block needs: gs*down + k - 1
  int lyp;   // ly rounded up to STEP
  int lx;    // x window: lyp + ntp (the last sample is padding)
  size_t smem;  // mirrored by _smem_bytes in kernels/fused_fir_resample.py
};

Geometry geometry(int ntaps, int down, int k, int gs, int high) {
  Geometry g;
  g.ntp = (ntaps + FIR_CHUNK - 1) / FIR_CHUNK * FIR_CHUNK;
  g.ly = gs * down + k - 1;
  g.lyp = (g.ly + STEP - 1) / STEP * STEP;
  g.lx = g.lyp + g.ntp;
  const size_t words = (size_t)g.ntp + g.lx + g.ly;
  g.smem = sizeof(float) * words * (high ? 2 : 1);
  return g;
}

__device__ __forceinline__ void split_bf16(float v, float* hi, float* lo) {
  const float h = __bfloat162float(__float2bfloat16_rn(v));
  *hi = h;
  *lo = __bfloat162float(__float2bfloat16_rn(v - h));
}

template <bool HIGH>
__global__ void __launch_bounds__(THREADS)
fused_fir_resample_kernel(const float* __restrict__ x,
                          const float* __restrict__ hist,
                          const float* __restrict__ fir_f32,
                          const __nv_bfloat16* __restrict__ fir_hi,
                          const __nv_bfloat16* __restrict__ fir_lo,
                          const float* __restrict__ bank_f32,
                          const __nv_bfloat16* __restrict__ bank_hi,
                          const __nv_bfloat16* __restrict__ bank_lo,
                          float* __restrict__ z, int t, int hl, int ntaps,
                          int up, int down, int k, int gs, int s_total,
                          Geometry geo) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ntp = geo.ntp, ly = geo.ly, lyp = geo.lyp, lx = geo.lx;
  // The x windows and taps come first: their lengths are multiples of 32,
  // so the float4 loads of fir_tile.cuh stay 16-byte aligned.
  float* xh = smem;                   // [lx] input window (hi in "high")
  float* xl = xh + lx;                // [lx] lo ("high" only)
  float* th = HIGH ? xl + lx : xh + lx;  // [ntp] FIR taps
  float* tl = th + ntp;               // [ntp] lo ("high" only)
  float* yh = HIGH ? tl + ntp : th + ntp;  // [ly] FIR output window
  float* yl = yh + ly;                // [ly] lo ("high" only)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * gs;
  const float* xr = x + (size_t)b * t;
  const float* hr = hist + (size_t)b * hl;

  for (int i = tid; i < ntp; i += THREADS) {
    if (HIGH) {
      th[i] = i < ntaps ? __bfloat162float(fir_hi[i]) : 0.f;
      tl[i] = i < ntaps ? __bfloat162float(fir_lo[i]) : 0.f;
    } else {
      th[i] = i < ntaps ? fir_f32[i] : 0.f;
    }
  }
  // xw[m] = xs[m0 + m]: y_loc[i] = y[s0*down - (k-1) + i] needs
  // xs[s0*down - (k-1) + i - j] for taps j < ntp.  Negative stream indices
  // come from the history (the envelope keeps them >= -hl for real taps).
  const int m0 = s0 * down - (k - 1) - (ntp - 1);
  for (int m = tid; m < lx; m += THREADS) {
    const int sm = m0 + m;
    float v = 0.f;
    if (sm < 0) {
      if (sm >= -hl) v = hr[hl + sm];
    } else if (sm < t) {
      v = xr[sm];
    }
    if (HIGH) {
      split_bf16(v, &xh[m], &xl[m]);
    } else {
      xh[m] = v;
    }
  }
  __syncthreads();

  // ---- stage 1: FIR into shared memory --------------------------------
  for (int base = 0; base < lyp; base += STEP) {
    const int i0 = base + 4 * tid;
    float acc[4];
    fir_out4<HIGH>(xh, xl, th, tl, ntp, i0, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i0 + r < ly) {
        if (HIGH) {
          split_bf16(acc[r], &yh[i0 + r], &yl[i0 + r]);
        } else {
          yh[i0 + r] = acc[r];
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: polyphase bank over the shared y window ---------------
  // Group g of this block, phase p: y_loc index of R[p, tau] is
  // g*down + tau, and tau = q_p + k-1-j for the K nonzero entries.
  const int ng = min(gs, s_total - s0);
  const int nout = ng * up;
  float* zr = z + (size_t)b * s_total * up + (size_t)s0 * up;
  for (int o = tid; o < nout; o += THREADS) {
    const int g = o / up;
    const int p = o - g * up;
    const int top = g * down + (p * down) / up + k - 1;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float a = yh[top - j];
      if (HIGH) {
        const float w = __bfloat162float(__ldg(&bank_hi[j * up + p]));
        acc = fmaf(a, w, acc);
        acc = fmaf(yl[top - j], w, acc);
        acc = fmaf(a, __bfloat162float(__ldg(&bank_lo[j * up + p])), acc);
      } else {
        acc = fmaf(a, __ldg(&bank_f32[j * up + p]), acc);
      }
    }
    zr[o] = acc;
  }
}

}  // namespace

// x: (batch, t) f32, t % down == 0.  hist: (batch, hl) f32, the carried
// stream history (hl = 2*block).  z: (batch, t/down*up) f32.
// high == 0: fir_a (ntaps,) and bank_a (k, up) are f32.  high == 1: the
// *_a / *_b pointers are the bf16 hi / lo parts.  The bank is stored
// (k, up): bank[j][p] = R[p, (p*down)/up + k-1-j].
// Returns cudaGetLastError() after the launch.
extern "C" int fused_fir_resample_launch(const float* x, const float* hist,
                                         const void* fir_a, const void* fir_b,
                                         const void* bank_a,
                                         const void* bank_b, float* z,
                                         int batch, int t, int hl, int ntaps,
                                         int up, int down, int k, int gs,
                                         int high, void* stream) {
  if (batch <= 0 || t <= 0) return (int)cudaSuccess;
  const Geometry geo = geometry(ntaps, down, k, gs, high);
  if (geo.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int s_total = t / down;
  const dim3 grid((s_total + gs - 1) / gs, batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (high) {
    auto kern = fused_fir_resample_kernel<true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)geo.smem);
    kern<<<grid, THREADS, geo.smem, s>>>(
        x, hist, nullptr, (const __nv_bfloat16*)fir_a,
        (const __nv_bfloat16*)fir_b, nullptr, (const __nv_bfloat16*)bank_a,
        (const __nv_bfloat16*)bank_b, z, t, hl, ntaps, up, down, k, gs,
        s_total, geo);
  } else {
    auto kern = fused_fir_resample_kernel<false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)geo.smem);
    kern<<<grid, THREADS, geo.smem, s>>>(
        x, hist, (const float*)fir_a, nullptr, nullptr,
        (const float*)bank_a, nullptr, nullptr, z, t, hl, ntaps, up, down, k,
        gs, s_total, geo);
  }
  return (int)cudaGetLastError();
}

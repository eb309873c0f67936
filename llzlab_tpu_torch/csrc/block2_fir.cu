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
// against 8 bytes of device memory traffic, so it is compute-bound.
// "highest" runs on the CUDA cores' fp32 FMA; the register window of
// fir_tile.cuh keeps shared-memory loads well below one per FMA.  "high"
// runs on the tensor cores (mma.sync bf16, fir_mma.cuh) at 27 % of their
// bf16 rate.  What holds the tile there is not one thing: without the lo
// fragment's ldmatrix, without one product of the three, or without the
// window's staging the kernel gains 6 % or less each (PERF.md).
//
// Design, "highest":
//   * one CUDA block per (run of RUN outputs, channel); the block stages the
//     contiguous input window (RUN + ntp samples) and the taps in shared
//     memory; the history block that the caller prepends supplies the left
//     context, so blocks are independent and run in any order;
//   * each thread computes four consecutive outputs (fir_tile.cuh), whose
//     sums run over the taps in an order fixed by the tap index alone, so a
//     stream split at any block boundary is bit-exact.
//
// Design, "high":
//   * x is split on load into bf16 hi/lo, kept as bf16, and the product is
//     x_hi*w_hi + x_lo*w_hi + x_hi*w_lo with fp32 accumulation, W the (kt, 8)
//     Toeplitz tile of the taps: what the TPU's three bf16 matrix passes
//     compute (a bf16 x bf16 product is exact in fp32);
//   * a unit of work is one pass of PASS = 4096 outputs of one row: 8 warps,
//     MT = 4 m-tiles of 128 outputs each.  W (33.5 KB at 1024 taps) costs a
//     block about three times what one pass's x window costs to stage, and
//     is the same for every row, so a block stages it ONCE and then walks
//     units q = blockIdx.x, + gridDim.x, ... of the (row, pass) list with W
//     resident.  The grid is what the card holds at once (blocks an SM,
//     read from the occupancy API, times SMs: 3 x 132 on an H100, 71
//     registers a thread and 54 KB at 1024 taps), so a block walks units /
//     grid passes: 9 to 10 at 64 x 245 760, where W is then about 2 % of
//     the block's time (a window's staging is 5.7 % of a pass), and 207
//     at 1024 x 327 680.  Tried on the card
//     (PERF.md): four blocks an SM at 64 registers 2 to 4 % slower, two
//     m-tiles a warp 19 % slower, staging the window in pairs 1 % faster;
//   * the sum order depends on the tap and on the output index mod 8
//     (fir_mma.cuh), and every pass starts at a multiple of PASS counted
//     from output 0 of the call.  So a stream split at a multiple of 8
//     samples is bit-exact, which covers every split at a block boundary
//     (block % 128 == 0); other splits are not;
//   * the window reaches kt - 8 samples back, up to 15 more than the history
//     block holds; those and everything else outside the row are loaded as
//     zeros (guarded scalar loads: t and the row length may be ragged).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_mma.cuh"
#include "fir_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = THREADS * 4;  // "highest": outputs per CUDA block
constexpr int MT = 4;             // "high": m-tiles a warp owns in a pass
constexpr int PASS = FIR_MMA_WARPS * MT * FIR_MMA_TILE;  // 4096 outputs
constexpr size_t SMEM_MAX = 232448;  // 227 KB per block on sm_90

__global__ void __launch_bounds__(THREADS)
block2_fir_highest_kernel(const float* __restrict__ xpad,
                          const float* __restrict__ taps,
                          float* __restrict__ y, int t, int block, int ntaps,
                          int ntp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lx = RUN + ntp;
  float* th = smem;      // [ntp] taps
  float* xw = th + ntp;  // [lx] x window

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * RUN;
  const int row = block + t;
  const float* xr = xpad + (size_t)b * row;

  fir_stage_taps(th, taps, ntaps, ntp, tid, THREADS);
  // xw[m] = xpad[block + n0 - (ntp - 1) + m]; zero outside the row (only
  // the zero-padded taps beyond ntaps or outputs beyond t ever see those).
  const int m0 = block + n0 - (ntp - 1);
  for (int m = tid; m < lx; m += THREADS) {
    const int idx = m0 + m;
    xw[m] = (idx >= 0 && idx < row) ? xr[idx] : 0.f;
  }
  __syncthreads();

  float acc[4];
  fir_out4(xw, th, ntp, 4 * tid, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + 4 * tid + r;
    if (n < t) y[(size_t)b * t + n] = acc[r];
  }
}

__global__ void __launch_bounds__(FIR_MMA_THREADS)
block2_fir_high_kernel(const float* __restrict__ xpad,
                       const __nv_bfloat16* __restrict__ taps_hi,
                       const __nv_bfloat16* __restrict__ taps_lo,
                       float* __restrict__ y, int t, int block, int ntaps,
                       int kt, int passes, int units) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int wsz = FIR_MMA_N * fir_mma_w_stride(kt);
  // every length is a multiple of 8 elements: 16-byte aligned rows for
  // ldmatrix
  __nv_bfloat16* wh = smem;      // [8][kt + 8] Toeplitz of the taps, hi
  __nv_bfloat16* wl = wh + wsz;  //             lo
  __nv_bfloat16* xh = wl + wsz;  // [PASS + kt - 8] x window, hi
  __nv_bfloat16* xl = xh + fir_mma_window_len(PASS, kt);  //   lo

  fir_mma_stage_w(wh, wl, taps_hi, taps_lo, ntaps, kt, threadIdx.x,
                  FIR_MMA_THREADS);
  const int row = block + t;
  for (int q = blockIdx.x; q < units; q += gridDim.x) {
    const int b = q / passes;
    const int n0 = (q - b * passes) * PASS;
    const float* xr = xpad + (size_t)b * row;
    // stream index j of this call is xpad[block + j]
    fir_mma_stage_window(xh, xl, PASS, kt, n0, [&](int j) {
      const int idx = block + j;
      return (idx >= 0 && idx < row) ? xr[idx] : 0.f;
    });
    __syncthreads();
    fir_mma_run<MT>(xh, xl, wh, wl, kt, y + (size_t)b * t, n0, t);
    __syncthreads();  // the window is rewritten for the next unit
  }
}

// Blocks of the "high" kernel that one SM holds, and SMs of the current
// card; a CUDA error code, or 0.
int high_residency(size_t smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(block2_fir_high_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, block2_fir_high_kernel, FIR_MMA_THREADS, smem);
  if (e == cudaSuccess && *per_sm < 1) e = cudaErrorLaunchOutOfResources;
  return (int)e;
}

}  // namespace

// Blocks of the "high" kernel that one SM of the current card holds at
// `ntaps` taps; minus the CUDA error code on failure.
extern "C" int block2_fir_blocks_per_sm(int ntaps) {
  const size_t smem = fir_mma_smem_bytes(PASS, fir_mma_kt(ntaps));
  if (smem > SMEM_MAX) return -(int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int rc = high_residency(smem, &per_sm, &sms);
  return rc ? -rc : per_sm;
}

// xpad: (batch, block + t) f32, one history block prepended.  y: (batch, t).
// high == 0: taps_a is (ntaps,) f32.  high == 1: taps_a / taps_b are the
// (ntaps,) bf16 hi / lo parts.  Returns cudaGetLastError() after the launch,
// or the error that kept it from launching (shared memory above 227 KB).
extern "C" int block2_fir_launch(const float* xpad, const void* taps_a,
                                 const void* taps_b, float* y, int batch,
                                 int t, int block, int ntaps, int high,
                                 void* stream) {
  if (batch <= 0 || t <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (high) {
    // mirrored by mma_plan in kernels/block2_fir.py
    const int kt = fir_mma_kt(ntaps);
    const size_t smem = fir_mma_smem_bytes(PASS, kt);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    int per_sm = 0, sms = 0;
    const int rc = high_residency(smem, &per_sm, &sms);
    if (rc) return rc;
    const int passes = (t + PASS - 1) / PASS;
    const long long units = (long long)batch * passes;
    if (units > INT32_MAX) return (int)cudaErrorInvalidValue;
    const int resident = per_sm * sms;
    const int grid = units < resident ? (int)units : resident;
    block2_fir_high_kernel<<<grid, FIR_MMA_THREADS, smem, s>>>(
        xpad, (const __nv_bfloat16*)taps_a, (const __nv_bfloat16*)taps_b, y,
        t, block, ntaps, kt, passes, (int)units);
  } else {
    const int ntp = (ntaps + FIR_CHUNK - 1) / FIR_CHUNK * FIR_CHUNK;
    const size_t smem = sizeof(float) * (size_t)(ntp + RUN + ntp);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const dim3 grid((t + RUN - 1) / RUN, batch);
    cudaFuncSetAttribute(block2_fir_highest_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    block2_fir_highest_kernel<<<grid, THREADS, smem, s>>>(
        xpad, (const float*)taps_a, y, t, block, ntaps, ntp);
  }
  return (int)cudaGetLastError();
}

// Kernel B4: halo exchange fused into the block2 FIR on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel llzlab_tpu/kernels/halo_fir_fused.py
// (_kernel, entry block2_fir_halo_fused).  A time shard holds x (c, t),
// t = nblk * block with nblk >= 2, and computes its part of the causal FIR
// y[n] = sum_k h[k] * x[n - k].  Only y-block 0 (outputs 0 .. block-1)
// reaches into the left neighbour's last h samples (ntaps-1 <= h <= block);
// every other output needs x alone.  The TPU kernel starts the remote copy
// of its tail at grid step 0, computes y-blocks 1 .. nblk-1 while the copy
// flies, and in its last step waits for the received halo and computes
// y-block 0.  Its grid runs in order on one core; CUDA blocks run in any
// order, so the same overlap is laid out over block indices:
//
//   * blocks 0 .. nsend-1 first push the tail to the right neighbour and
//     publish the epoch (halo_exchange.cuh), then go on as below;
//   * the lowest block indices compute the output tiles that lie beyond
//     y-block 0, from x alone;
//   * the highest block indices (at most MAX_WAIT of them) wait for this
//     shard's own flag and then walk over the tiles that start in y-block 0,
//     reading their left context from the receive buffer (shard 0: from the
//     stream carry, or zeros), with zeros before the h samples it holds.
//
// One card may hold every shard of a mesh, each on its own stream.  The
// waiting blocks of shard r spin on a flag that a block of shard r-1 sets,
// so they must never keep that block off the SMs: shards are launched in
// rank order, senders have the lowest indices of their launch, waiters the
// highest, and a launch has at most MAX_WAIT waiters, far fewer than the
// card keeps resident (132 SMs x 8 blocks of this size).  A wait still has
// its time limit and error word.
//
// The tile arithmetic is kernel B2's: fir_tile.cuh's four outputs per thread,
// 32-tap chunks in tap order.  An output's sum depends on its tap indices
// alone, so the shards' outputs, concatenated, are bitwise equal to
// block2_fir.cu on the unsharded stream.
//
// What bounds it: operations, as B2 (2*ntaps FLOP a sample, 6*ntaps in
// "high", against 8 bytes); the exchange moves c*h floats once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_tile.cuh"
#include "halo_exchange.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = THREADS * 4;  // outputs per tile
constexpr int MAX_SEND = 8;       // blocks that share the tail's copy
constexpr int MAX_WAIT = 32;      // blocks that wait for the halo

// Outputs n0 .. n0+RUN-1 of row b.  Window sample m is local stream index
// n0 - (ntp-1) + m: x where it is >= 0; below 0 the left context, which is
// `left` (row b, h samples ending at index -1; null: zeros) or zero further
// back.  Samples below 0 of a tile beyond y-block 0 meet zero-padded taps
// only and are loaded as zeros (left == nullptr).
template <bool HIGH>
__device__ __forceinline__ void fir_tile_from_halo(
    const float* __restrict__ x, const float* left, float* __restrict__ y,
    float* xh, float* xl, const float* th, const float* tl, int b, int n0,
    int t, int h, int ntp) {
  const int tid = threadIdx.x;
  const int lx = RUN + ntp;
  const float* xr = x + (size_t)b * t;
  const int j0 = n0 - (ntp - 1);
  for (int m = tid; m < lx; m += THREADS) {
    const int j = j0 + m;
    float v = 0.f;
    if (j >= 0) {
      if (j < t) v = xr[j];
    } else if (left != nullptr && j >= -h) {
      v = __ldcg(left + (size_t)b * h + (h + j));
    }
    fir_stage_sample<HIGH>(xh, xl, m, v);
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

template <bool HIGH>
__global__ void __launch_bounds__(THREADS)
halo_fir_fused_kernel(const float* __restrict__ x,
                      const float* __restrict__ taps_f32,
                      const __nv_bfloat16* __restrict__ taps_hi,
                      const __nv_bfloat16* __restrict__ taps_lo,
                      float* __restrict__ y, int c, int t, int ntaps, int ntp,
                      int h, float* nbr_buf, int* nbr_flag, const float* left,
                      const int* my_flag, int* counter, int* err, int epoch,
                      long long limit_ns, int nsend, int n_interior,
                      int tiles_in, int nwt) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lx = RUN + ntp;
  float* th = smem;                        // [ntp] taps (hi in "high")
  float* tl = th + ntp;                    // [ntp] taps lo ("high" only)
  float* xh = HIGH ? tl + ntp : th + ntp;  // [lx] x window (hi in "high")
  float* xl = xh + lx;                     // [lx] x lo ("high" only)

  const int lin = blockIdx.x;
  fir_stage_taps<HIGH>(th, tl, taps_f32, taps_hi, taps_lo, ntaps, ntp,
                       threadIdx.x, THREADS);
  if (nbr_buf != nullptr && lin < nsend)
    halo_send(x, t, t, c, h, nbr_buf, nbr_flag, counter, epoch, lin, nsend);

  if (lin < n_interior) {
    const int b = lin / tiles_in;
    const int n0 = (nwt + lin % tiles_in) * RUN;
    fir_tile_from_halo<HIGH>(x, nullptr, y, xh, xl, th, tl, b, n0, t, h, ntp);
    return;
  }
  if (my_flag != nullptr) halo_wait(my_flag, epoch, limit_ns, err);
  const int nwait = gridDim.x - n_interior;
  for (int q = lin - n_interior; q < c * nwt; q += nwait) {
    fir_tile_from_halo<HIGH>(x, left, y, xh, xl, th, tl, q / nwt,
                             (q % nwt) * RUN, t, h, ntp);
    __syncthreads();  // the window is reused by the next tile
  }
}

}  // namespace

// x: the shard's contiguous (c, t) f32 block; y: (c, t).  high == 0: taps_a is
// (ntaps,) f32; high == 1: taps_a / taps_b are the bf16 hi / lo parts.
// nbr_buf / nbr_flag: the right neighbour's (c, h) receive buffer and flag,
// null on the last shard.  left: this shard's own receive buffer, with
// my_flag its flag; on shard 0 my_flag is null and left is the (c, h) carry
// (null: zeros).  counter: one zeroed int of this shard; err: its error
// word.  Returns cudaGetLastError() after the launch.
extern "C" int halo_fir_fused_launch(
    const float* x, const void* taps_a, const void* taps_b, float* y, int c,
    int t, int block, int ntaps, int high, int h, float* nbr_buf,
    int* nbr_flag, const float* left, const int* my_flag, int* counter,
    int* err, int epoch, long long limit_ns, void* stream) {
  if (c <= 0 || t <= 0) return (int)cudaSuccess;
  const int ntp = (ntaps + FIR_CHUNK - 1) / FIR_CHUNK * FIR_CHUNK;
  const int lx = RUN + ntp;
  const size_t smem = sizeof(float) * (size_t)(high ? 2 * ntp + 2 * lx
                                                    : ntp + lx);
  const int tiles = (t + RUN - 1) / RUN;          // per row
  int nwt = (block + RUN - 1) / RUN;              // of them, in y-block 0
  if (nwt > tiles) nwt = tiles;
  const int tiles_in = tiles - nwt;
  const int n_interior = c * tiles_in;
  const int nwait = c * nwt < MAX_WAIT ? c * nwt : MAX_WAIT;
  const int grid = n_interior + nwait;
  const int nsend = grid < MAX_SEND ? grid : MAX_SEND;
  cudaStream_t s = (cudaStream_t)stream;
  if (high) {
    auto kern = halo_fir_fused_kernel<true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, THREADS, smem, s>>>(
        x, nullptr, (const __nv_bfloat16*)taps_a,
        (const __nv_bfloat16*)taps_b, y, c, t, ntaps, ntp, h, nbr_buf,
        nbr_flag, left, my_flag, counter, err, epoch, limit_ns, nsend,
        n_interior, tiles_in, nwt);
  } else {
    auto kern = halo_fir_fused_kernel<false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, THREADS, smem, s>>>(
        x, (const float*)taps_a, nullptr, nullptr, y, c, t, ntaps, ntp, h,
        nbr_buf, nbr_flag, left, my_flag, counter, err, epoch, limit_ns,
        nsend, n_interior, tiles_in, nwt);
  }
  return (int)cudaGetLastError();
}

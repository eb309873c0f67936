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
//   * the lowest block indices (the interior blocks) compute the output
//     tiles that lie beyond y-block 0, from x alone;
//   * the highest block indices (at most max_wait of them, the waiters) wait
//     for this shard's own flag and then walk over the tiles of y-block 0,
//     reading their left context from the receive buffer (shard 0: from the
//     stream carry, or zeros), with zeros before the h samples it holds.
//
// The tile plan (tile_plan below, the one place that knows it).  Waiter
// tiles are WRUN = 1024 outputs wide in both modes: the first nwt =
// ceil(block / 1024) tiles of a row, `head` outputs.  Interior tiles start at
// `head` and are 1024 wide at "highest" (one block each, as in B2) and
// PASS = 4096 wide at "high", where an interior block keeps the Toeplitz tile
// of the taps resident and walks tiles lin, lin + n_int_blocks, ..., with
// n_int_blocks what the card holds at once less the waiters (B2's design:
// block2_fir.cu).  A waiter at "high" computes its 1024 outputs with one
// m-tile a warp where the interior takes four: the sum order depends on
// neither (fir_mma.cuh), and a waiter that took a 4096-wide run would hold
// 3072 outputs that need no halo back behind its wait.
//
// How many waiters.  At "highest" the grid is far larger than the card, and
// the waiters, last in it, start when the interior is all but done: the
// launch ends with whatever they still have to do, so there are MAX_WAIT =
// 32 of them, eight tiles each at 256 channels.  At "high" every block is on
// the card from the start, a waiter keeps a place from an interior block
// and stages a W of its own, and MAX_WAIT_HIGH = 16 is the faster (7.04 to
// 7.10 ms against 7.26 to 7.27 at 256 x 1 310 720 over 4 ranks, PERF.md).
//
// One card may hold every shard of a mesh, each on its own stream.  The
// waiting blocks of shard r spin on a flag that a block of shard r-1 sets,
// so they must never keep that block off the SMs.  Shards are launched in
// rank order, senders have the lowest indices of their launch and waiters
// the highest, and interior blocks end without waiting for anything.  So a
// sender can only be kept off the card while waiters fill it, and a card
// holds the waiters of at most MAX_CARD_RANKS - 1 shards (shard 0 waits for
// nobody), max_wait each: 15 x 32 = 480 blocks at "highest", 15 x 16 = 240
// at "high".  The launch function reads from the occupancy API how many
// blocks the card holds and refuses to launch unless that is more.  Read on
// an H100 80GB HBM3 (132 SMs) with 1024 taps: 4 blocks an SM at "high" (54
// KB of shared memory, 64 registers a thread; 528 blocks), 8 at "highest"
// (12 KB, 32 registers; 1056 blocks).
// A neighbour on another host (a NET edge): the senders store nothing
// (nbr_buf is null; NCCL carries the tail, queued by the host before this
// launch), and the waiters wait for the flag that the receiving process's
// transfer stream publishes once NCCL's receive has landed.  That receive
// is a kernel too, and needs an SM while the waiters spin.  It always finds
// one: the host queues it before this launch, the interior blocks end
// without waiting for anything, and the waiters, at most max_wait blocks of
// at most MAX_CARD_RANKS - 1 shards, never fill the card (the test above);
// so at the latest when the interior is done, the receive and the one-thread
// publish kernel run beside the spinning waiters.  At "high", where the grid
// is what the card holds at once, that latest case is the usual one unless
// the receive was placed first.
// A wait still has its time limit and error word.  A neighbour in another
// process (buffers opened through CUDA IPC) adds the acknowledgement of
// halo_exchange.cuh: the senders wait for the ack of the previous epoch
// before they store, and the waiters, once they have read the halo,
// acknowledge it.  Two processes on one card do not run kernels at the same
// time (their contexts are time-sliced without MPS): a spinning waiter moves
// on when the card switches to the sender's context.
//
// The tile arithmetic is kernel B2's: at "highest" fir_tile.cuh's four
// outputs per thread, 32-tap chunks in tap order, where an output's sum
// depends on its tap indices alone; at "high" fir_mma.cuh's block run, where
// it depends on the taps and on the output's index mod 8 of the stream, and
// every tile here starts at a multiple of 1024 of a shard that starts at a
// multiple of `block` (block % 128 == 0).  So the shards' outputs,
// concatenated, are bitwise equal to block2_fir.cu on the unsharded stream.
//
// What bounds it: operations, as B2 (2*ntaps FLOP a sample on the CUDA
// cores, 6*ntaps on the tensor cores in "high", against 8 bytes); at "high"
// it reaches 29 % of the tensor cores' bf16 rate, held there by what holds
// B2 (block2_fir.cu).  The exchange moves c*h floats once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_mma.cuh"
#include "fir_tile.cuh"
#include "halo_exchange.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WRUN = THREADS * 4;  // outputs per waiter tile, and per
                                   // interior tile at "highest"
constexpr int MT = 4;              // "high": m-tiles a warp owns, interior
constexpr int PASS = FIR_MMA_WARPS * MT * FIR_MMA_TILE;  // 4096 outputs
constexpr int MAX_SEND = 8;        // blocks that share the tail's copy
constexpr int MAX_WAIT = 32;       // blocks that wait, at most: "highest"
constexpr int MAX_WAIT_HIGH = 16;  //                             "high"
constexpr int MAX_CARD_RANKS = 16; // shards one card may hold (halo_ring.cu)
constexpr size_t SMEM_MAX = 232448;  // 227 KB per block on sm_90
static_assert(FIR_MMA_THREADS == THREADS, "one block size for both modes");
static_assert(fir_mma_run_len(1) == WRUN, "a waiter tile is one m-tile a warp");

// Mirrored by tile_plan in kernels/halo_fir_fused.py.
struct TilePlan {
  int irun;          // outputs per interior tile
  int nwt;           // waiter tiles per row: outputs 0 .. head - 1
  int head;
  int tiles_in;      // interior tiles per row: outputs head .. t - 1
  int n_interior;    // c * tiles_in
  int n_int_blocks;  // blocks that walk them
  int max_wait;
  int nwait;         // blocks that walk the c * nwt waiter tiles
  int grid;
  int nsend;
};

// `resident`: blocks the card holds at once ("high" only).
TilePlan tile_plan(int c, int t, int block, int high, int resident) {
  TilePlan p;
  p.irun = high ? PASS : WRUN;
  p.max_wait = high ? MAX_WAIT_HIGH : MAX_WAIT;
  const int tiles = (t + WRUN - 1) / WRUN;
  p.nwt = (block + WRUN - 1) / WRUN;
  if (p.nwt > tiles) p.nwt = tiles;
  p.head = p.nwt * WRUN;
  p.tiles_in = t > p.head ? (t - p.head + p.irun - 1) / p.irun : 0;
  p.n_interior = c * p.tiles_in;
  p.nwait = c * p.nwt < p.max_wait ? c * p.nwt : p.max_wait;
  p.n_int_blocks = p.n_interior;
  if (high && p.n_int_blocks > resident - p.nwait)
    p.n_int_blocks = resident - p.nwait;
  p.grid = p.n_int_blocks + p.nwait;
  p.nsend = p.grid < MAX_SEND ? p.grid : MAX_SEND;
  return p;
}

// The sample at local stream index j of row b: x for 0 <= j < t; below 0
// the left context, which is `left` (row b, h samples ending at index -1;
// null: zeros) and zero further back; zero from t on.  Samples below 0 of a
// tile beyond y-block 0 meet zero taps only and are loaded as zeros
// (left == nullptr).
__device__ __forceinline__ float shard_sample(const float* __restrict__ xr,
                                              const float* left, int b, int j,
                                              int t, int h) {
  if (j >= 0) return j < t ? xr[j] : 0.f;
  if (left != nullptr && j >= -h) return __ldcg(left + (size_t)b * h + (h + j));
  return 0.f;
}

// "highest": outputs n0 .. n0+WRUN-1 of row b.  Window sample m is local
// stream index n0 - (ntp-1) + m.
__device__ __forceinline__ void fir_tile_from_halo(
    const float* __restrict__ x, const float* left, float* __restrict__ y,
    float* xw, const float* th, int b, int n0, int t, int h, int ntp) {
  const int tid = threadIdx.x;
  const int lx = WRUN + ntp;
  const float* xr = x + (size_t)b * t;
  const int j0 = n0 - (ntp - 1);
  for (int m = tid; m < lx; m += THREADS)
    xw[m] = shard_sample(xr, left, b, j0 + m, t, h);
  __syncthreads();
  float acc[4];
  fir_out4(xw, th, ntp, 4 * tid, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + 4 * tid + r;
    if (n < t) y[(size_t)b * t + n] = acc[r];
  }
}

// "high": outputs n0 .. n0 + 8*TILES*128 - 1 of row b on the tensor cores.
template <int TILES>
__device__ __forceinline__ void mma_tile_from_halo(
    const float* __restrict__ x, const float* left, float* __restrict__ y,
    __nv_bfloat16* xh, __nv_bfloat16* xl, const __nv_bfloat16* wh,
    const __nv_bfloat16* wl, int b, int n0, int t, int h, int kt) {
  const float* xr = x + (size_t)b * t;
  fir_mma_stage_window(xh, xl, fir_mma_run_len(TILES), kt, n0, [&](int j) {
    return shard_sample(xr, left, b, j, t, h);
  });
  __syncthreads();
  fir_mma_run<TILES>(xh, xl, wh, wl, kt, y + (size_t)b * t, n0, t);
}

// ntp: the taps rounded up to 32 at "highest", the rows kt of W at "high".
template <bool HIGH>
__global__ void __launch_bounds__(THREADS)
halo_fir_fused_kernel(const float* __restrict__ x,
                      const float* __restrict__ taps_f32,
                      const __nv_bfloat16* __restrict__ taps_hi,
                      const __nv_bfloat16* __restrict__ taps_lo,
                      float* __restrict__ y, int c, int t, int ntaps, int ntp,
                      int h, float* nbr_buf, int* nbr_flag, const float* left,
                      const int* my_flag, int* counter, const int* nbr_ack,
                      int* my_ack, int* my_rcount, int* err, int epoch,
                      long long limit_ns, TilePlan plan) {
  extern __shared__ float4 smem4[];
  // "highest": [ntp] taps, [WRUN + ntp] x window, floats
  float* th = reinterpret_cast<float*>(smem4);
  float* xw = th + ntp;
  // "high": W hi, W lo, x window hi, lo (the interior's, the longer), bf16
  __nv_bfloat16* wh = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* wl = wh + FIR_MMA_N * fir_mma_w_stride(ntp);
  __nv_bfloat16* xh = wl + FIR_MMA_N * fir_mma_w_stride(ntp);
  __nv_bfloat16* xl = xh + fir_mma_window_len(PASS, ntp);

  const int lin = blockIdx.x;
  if constexpr (HIGH)
    fir_mma_stage_w(wh, wl, taps_hi, taps_lo, ntaps, ntp, threadIdx.x,
                    THREADS);
  else
    fir_stage_taps(th, taps_f32, ntaps, ntp, threadIdx.x, THREADS);
  if (nbr_buf != nullptr && lin < plan.nsend)
    halo_send(x, t, t, c, h, nbr_buf, nbr_flag, counter, epoch, lin,
              plan.nsend, nbr_ack, limit_ns, err);

  if (lin < plan.n_int_blocks) {
    for (int q = lin; q < plan.n_interior; q += plan.n_int_blocks) {
      const int b = q / plan.tiles_in;
      const int n0 = plan.head + (q - b * plan.tiles_in) * plan.irun;
      if constexpr (HIGH)
        mma_tile_from_halo<MT>(x, nullptr, y, xh, xl, wh, wl, b, n0, t, h,
                               ntp);
      else
        fir_tile_from_halo(x, nullptr, y, xw, th, b, n0, t, h, ntp);
      // "highest" has one tile a block; ending here, without the barrier
      // and the loop's test, is 3.4 % of the kernel's time at 256 x 327 680
      if constexpr (!HIGH) return;
      __syncthreads();  // the window is reused by the next tile
    }
    return;
  }
  if (my_flag != nullptr) halo_wait(my_flag, epoch, limit_ns, err);
  for (int q = lin - plan.n_int_blocks; q < c * plan.nwt; q += plan.nwait) {
    const int b = q / plan.nwt;
    const int n0 = (q - b * plan.nwt) * WRUN;
    if constexpr (HIGH)
      mma_tile_from_halo<1>(x, left, y, xh, xl, wh, wl, b, n0, t, h, ntp);
    else
      fir_tile_from_halo(x, left, y, xw, th, b, n0, t, h, ntp);
    __syncthreads();
  }
  // every waiter has read its share of the buffer: acknowledge it to a
  // sender in another process
  if (my_ack != nullptr) halo_ack(my_ack, my_rcount, epoch, plan.nwait);
}

// Shared memory of a block, the blocks of it that one SM of the current card
// holds, and the card's SMs; a CUDA error code, or 0.
template <bool HIGH>
int residency(int ntp, size_t* smem, int* per_sm, int* sms) {
  *smem = HIGH ? fir_mma_smem_bytes(PASS, ntp)
               : sizeof(float) * (size_t)(ntp + WRUN + ntp);
  if (*smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(halo_fir_fused_kernel<HIGH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, halo_fir_fused_kernel<HIGH>, THREADS, *smem);
  return (int)e;
}

int residency(int ntaps, int high, int* ntp, size_t* smem, int* per_sm,
              int* sms) {
  *ntp = high ? fir_mma_kt(ntaps)
              : (ntaps + FIR_CHUNK - 1) / FIR_CHUNK * FIR_CHUNK;
  return high ? residency<true>(*ntp, smem, per_sm, sms)
              : residency<false>(*ntp, smem, per_sm, sms);
}

}  // namespace

// Blocks of the kernel that one SM of the current card holds at `ntaps`
// taps; minus the CUDA error code on failure.
extern "C" int halo_fir_fused_blocks_per_sm(int ntaps, int high) {
  size_t smem = 0;
  int ntp = 0, per_sm = 0, sms = 0;
  const int rc = residency(ntaps, high, &ntp, &smem, &per_sm, &sms);
  return rc ? -rc : per_sm;
}

// x: the shard's contiguous (c, t) f32 block; y: (c, t).  high == 0: taps_a is
// (ntaps,) f32; high == 1: taps_a / taps_b are the bf16 hi / lo parts.
// nbr_buf / nbr_flag: the right neighbour's (c, h) receive buffer and flag,
// null on the last shard.  left: this shard's own receive buffer, with
// my_flag its flag; on shard 0 my_flag is null and left is the (c, h) carry
// (null: zeros).  counter: one zeroed int of this shard; err: its error
// word.  nbr_ack: where the right neighbour lives in another process, this
// shard's ack word, which the send waits on (null: none); my_ack / my_rcount:
// where the left neighbour does, its ack word (opened through CUDA IPC) and
// one zeroed int of this shard, which the waiters acknowledge into.  Returns cudaGetLastError() after the launch, or the error that kept
// it from launching: shared memory above 227 KB (cudaErrorInvalidValue), or
// a card that holds too few blocks for its waiters never to keep a sender
// off it (cudaErrorLaunchOutOfResources).
extern "C" int halo_fir_fused_launch(
    const float* x, const void* taps_a, const void* taps_b, float* y, int c,
    int t, int block, int ntaps, int high, int h, float* nbr_buf,
    int* nbr_flag, const float* left, const int* my_flag, int* counter,
    const int* nbr_ack, int* my_ack, int* my_rcount, int* err, int epoch,
    long long limit_ns, void* stream) {
  if (c <= 0 || t <= 0) return (int)cudaSuccess;
  size_t smem = 0;
  int ntp = 0, per_sm = 0, sms = 0;
  const int rc = residency(ntaps, high, &ntp, &smem, &per_sm, &sms);
  if (rc) return rc;
  const int resident = per_sm * sms;
  const TilePlan plan = tile_plan(c, t, block, high, resident);
  if (resident <= (MAX_CARD_RANKS - 1) * plan.max_wait)
    return (int)cudaErrorLaunchOutOfResources;
  cudaStream_t s = (cudaStream_t)stream;
  if (high)
    halo_fir_fused_kernel<true><<<plan.grid, THREADS, smem, s>>>(
        x, nullptr, (const __nv_bfloat16*)taps_a,
        (const __nv_bfloat16*)taps_b, y, c, t, ntaps, ntp, h, nbr_buf,
        nbr_flag, left, my_flag, counter, nbr_ack, my_ack, my_rcount, err,
        epoch, limit_ns, plan);
  else
    halo_fir_fused_kernel<false><<<plan.grid, THREADS, smem, s>>>(
        x, (const float*)taps_a, nullptr, nullptr, y, c, t, ntaps, ntp, h,
        nbr_buf, nbr_flag, left, my_flag, counter, nbr_ack, my_ack,
        my_rcount, err, epoch, limit_ns, plan);
  return (int)cudaGetLastError();
}

// Kernel B3: left-halo exchange between time shards on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel llzlab_tpu/kernels/halo_ring.py
// (_ring_send_kernel, entry left_halo_ring): every time shard sends the last
// h samples of its (c, t) block to its right neighbour by an async remote
// copy with send/receive semaphores, and the caller puts the stream carry
// (or zeros) in shard 0.
//
// What bounds it: the host, then bytes.  The copy itself is c*h floats per
// shard, microseconds of HBM time (24 MB read and written at 1024 x 2048 on
// four shards); one launch per shard, each on its own stream with its own
// events, cost the host ten times that.  So the design is one launch per
// card and exchange: blockIdx.y is the shard within the card, and a table of
// the card's shards rides in the kernel's arguments (no upload).
//
//   same-card edge   shard r reads the row tails of shard r-1 straight from
//                    its x (or the carry, or writes zeros) into `out`.  No
//                    receive buffer, no flag, no counter, nothing to wait
//                    for: stream order alone makes x ready.
//   cross-card edge  the protocol of halo_exchange.cuh: the card's last shard
//                    sends its tails into the next card's receive buffer
//                    (NVLink stores, peer access enabled by
//                    halo_enable_peer_access) and publishes the epoch; the
//                    card's first shard waits for the epoch in its own flag
//                    and copies its buffer out.  The wrapper can also launch
//                    each shard of one card alone, on its own stream, so
//                    that every edge takes this branch (a check of the
//                    protocol on a machine with one card).
//
// The send precedes the wait in every block, so a card that holds a single
// shard (whose blocks do both) cannot wait for a sender queued behind it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halo_exchange.cuh"

// How one shard gets its halo.  src: h floats per row, rows src_stride
// apart (the left neighbour's tails, the carry, or this shard's receive
// buffer); null: zeros.  flag: non-null on a cross-card edge, where the
// copy waits for the epoch; err: this shard's error word.
struct HaloRank {
  const float* src;
  long long src_stride;
  float* out;  // (c, h) contiguous
  const int* flag;
  int* err;
};

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 64;  // per shard
constexpr int MAX_RANKS = 16;   // shards of one launch (HALO_MAX_RANKS)

struct HaloTable {
  HaloRank r[MAX_RANKS];
};

__global__ void __launch_bounds__(THREADS)
halo_ring_kernel(HaloTable tab, int c, int h, const float* send_x,
                 long long send_stride, int send_t, float* nbr_buf,
                 int* nbr_flag, int* counter, int epoch, long long limit_ns) {
  const int part = blockIdx.x, nparts = gridDim.x;
  if (nbr_buf != nullptr && blockIdx.y == gridDim.y - 1)
    halo_send(send_x, send_stride, send_t, c, h, nbr_buf, nbr_flag, counter,
              epoch, part, nparts);
  const HaloRank me = tab.r[blockIdx.y];
  if (me.flag != nullptr) halo_wait(me.flag, epoch, limit_ns, me.err);
  if (me.src != nullptr) {
    for (int row = part; row < c; row += nparts)
      halo_copy_row(me.out + (size_t)row * h,
                    me.src + (size_t)row * me.src_stride, h, threadIdx.x,
                    THREADS);
  } else {
    for (int row = part; row < c; row += nparts)
      for (int i = threadIdx.x; i < h; i += THREADS)
        me.out[(size_t)row * h + i] = 0.f;
  }
}

}  // namespace

// One launch for n (<= 16) consecutive shards of one card.  ranks: n
// HaloRank entries in host memory.  send_x / send_stride / send_t: the (c,
// send_t) block of the launch's last shard, sent to nbr_buf / nbr_flag (the
// next card's (c, h) receive buffer and flag) with `counter` (one zeroed int
// of that shard); nbr_buf null: nothing is sent.  Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for n outside 1 .. 16.
extern "C" int halo_ring_launch(const HaloRank* ranks, int n, int c, int h,
                                const float* send_x, long long send_stride,
                                int send_t, float* nbr_buf, int* nbr_flag,
                                int* counter, int epoch, long long limit_ns,
                                void* stream) {
  if (c <= 0 || h <= 0 || n == 0) return (int)cudaSuccess;
  if (n < 0 || n > MAX_RANKS) return (int)cudaErrorInvalidValue;
  HaloTable tab = {};
  for (int i = 0; i < n; ++i) tab.r[i] = ranks[i];
  const dim3 grid(c < MAX_BLOCKS ? c : MAX_BLOCKS, n);
  halo_ring_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      tab, c, h, send_x, send_stride, send_t, nbr_buf, nbr_flag, counter,
      epoch, limit_ns);
  return (int)cudaGetLastError();
}

// Let kernels of card `dev` load from and store into memory of card `peer`
// (cudaDeviceEnablePeerAccess from dev's context; one direction).  The
// current device is left as it was.  Returns 0 when this call enabled the
// access, -1 when it was enabled already (cudaErrorPeerAccessAlreadyEnabled,
// cleared), else the CUDA error code.
extern "C" int halo_enable_peer_access(int dev, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  int rc = 0;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();  // not sticky: clear it
      e = cudaSuccess;
      rc = -1;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  if (e != cudaSuccess) return (int)e;
  return back != cudaSuccess ? (int)back : rc;
}

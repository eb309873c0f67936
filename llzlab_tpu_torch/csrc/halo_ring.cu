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
//   cross-process    the same protocol, with the receive buffer and flag of
//                    the other process's shard opened through CUDA IPC
//                    (halo_ipc_* below) and the receiver's acknowledgement
//                    (halo_ack) in place of the stream event that orders the
//                    next send within a process.
//   cross-host (NET) the receive half alone: the shard waits for its flag
//                    and copies its buffer out, which NCCL filled and
//                    halo_net_publish (below) flagged (halo_exchange.cuh);
//                    the launch that holds the sending shard gets no
//                    neighbour buffer and stores nothing.
//
// The send precedes the wait in every block, so a card that holds a single
// shard (whose blocks do both) cannot wait for a sender queued behind it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "halo_exchange.cuh"

// How one shard gets its halo.  src: h floats per row, rows src_stride
// apart (the left neighbour's tails, the carry, or this shard's receive
// buffer); null: zeros.  flag: non-null on a protocol edge, where the copy
// waits for the epoch; err: this shard's error word.  ack / rcount: non-null
// on an edge from another process, where the copy is acknowledged into the
// sender's ack word, counted in rcount (one zeroed int of this shard).
struct HaloRank {
  const float* src;
  long long src_stride;
  float* out;  // (c, h) contiguous
  const int* flag;
  int* err;
  int* ack;
  int* rcount;
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
                 int* nbr_flag, int* counter, const int* send_ack,
                 int* send_err, int epoch, long long limit_ns) {
  const int part = blockIdx.x, nparts = gridDim.x;
  if (nbr_buf != nullptr && blockIdx.y == gridDim.y - 1)
    halo_send(send_x, send_stride, send_t, c, h, nbr_buf, nbr_flag, counter,
              epoch, part, nparts, send_ack, limit_ns, send_err);
  const HaloRank me = tab.r[blockIdx.y];
  if (me.flag != nullptr) halo_wait(me.flag, epoch, limit_ns, me.err);
  if (me.src != nullptr) {
    for (int row = part; row < c; row += nparts)
      halo_copy_row(me.out + (size_t)row * h,
                    me.src + (size_t)row * me.src_stride, h, threadIdx.x,
                    THREADS);
    if (me.ack != nullptr) halo_ack(me.ack, me.rcount, epoch, nparts);
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
// next shard's (c, h) receive buffer and flag, on another card or in another
// process) with `counter` (one zeroed int of that shard); nbr_buf null:
// nothing is sent.  send_ack: the sender's ack word where the next shard
// lives in another process (null: none), send_err the sending shard's error
// word.  Returns cudaGetLastError() after the launch, cudaErrorInvalidValue
// for n outside 1 .. 16.
extern "C" int halo_ring_launch(const HaloRank* ranks, int n, int c, int h,
                                const float* send_x, long long send_stride,
                                int send_t, float* nbr_buf, int* nbr_flag,
                                int* counter, const int* send_ack,
                                int* send_err, int epoch, long long limit_ns,
                                void* stream) {
  if (c <= 0 || h <= 0 || n == 0) return (int)cudaSuccess;
  if (n < 0 || n > MAX_RANKS) return (int)cudaErrorInvalidValue;
  HaloTable tab = {};
  for (int i = 0; i < n; ++i) tab.r[i] = ranks[i];
  const dim3 grid(c < MAX_BLOCKS ? c : MAX_BLOCKS, n);
  halo_ring_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      tab, c, h, send_x, send_stride, send_t, nbr_buf, nbr_flag, counter,
      send_ack, send_err, epoch, limit_ns);
  return (int)cudaGetLastError();
}

namespace {

__global__ void halo_net_publish_kernel(int* flag, int epoch) {
  __threadfence_system();
  halo_flag_store(flag, epoch);
}

}  // namespace

// Publish `epoch` in the flag of a NET edge's receive buffer, behind what
// `stream` was given before (the transfer that filled the buffer): one
// thread, a system fence, st.release.sys.  The receiving shard's kernel
// (B3 or B4) waits for it with ld.acquire.sys, as for a flag that another
// card's kernel set.  Returns cudaGetLastError() after the launch.
extern "C" int halo_net_publish(int* flag, int epoch, void* stream) {
  halo_net_publish_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(flag, epoch);
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

// Exchange state that another card or process reaches: memory of its own
// allocation (a block of PyTorch's caching allocator cannot be exported
// alone: cudaIpcGetMemHandle hands out the whole segment; and under
// PyTorch's expandable segments a peer card reaches the allocator's memory
// only after cuMemSetAccess, where cudaMalloc memory needs peer access
// alone).  Every receive buffer and flag of a protocol edge, within a
// process too, lives here.  Each call makes `dev` current and restores the
// caller's device; each returns 0 or the CUDA error code.

namespace {

template <typename F>
int on_device(int dev, F&& f) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) e = f();
  const cudaError_t back = cudaSetDevice(prev);
  if (e != cudaSuccess) return (int)e;
  return (int)back;
}

}  // namespace

// `bytes` of device memory of card `dev`, zeroed before this returns.
extern "C" int halo_ipc_alloc(int dev, long long bytes, void** ptr) {
  return on_device(dev, [&] {
    cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
    if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    return e;
  });
}

// The 64-byte IPC handle of an allocation of halo_ipc_alloc.
static_assert(sizeof(cudaIpcMemHandle_t) == 64, "kernels/halo_ring.py");
extern "C" int halo_ipc_export(int dev, void* ptr, unsigned char* handle) {
  return on_device(dev, [&] {
    cudaIpcMemHandle_t hd;
    const cudaError_t e = cudaIpcGetMemHandle(&hd, ptr);
    if (e == cudaSuccess) memcpy(handle, &hd, sizeof(hd));
    return e;
  });
}

// Open another process's allocation for kernels of card `dev` (the card of
// the shard that stores into it), enabling peer access to its card if needed.
extern "C" int halo_ipc_open(int dev, const unsigned char* handle,
                             void** ptr) {
  return on_device(dev, [&] {
    cudaIpcMemHandle_t hd;
    memcpy(&hd, handle, sizeof(hd));
    return cudaIpcOpenMemHandle(ptr, hd, cudaIpcMemLazyEnablePeerAccess);
  });
}

extern "C" int halo_ipc_close(int dev, void* ptr) {
  return on_device(dev, [&] { return cudaIpcCloseMemHandle(ptr); });
}

extern "C" int halo_ipc_free(int dev, void* ptr) {
  return on_device(dev, [&] { return cudaFree(ptr); });
}

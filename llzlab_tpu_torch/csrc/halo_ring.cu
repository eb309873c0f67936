// Kernel B3: left-halo exchange between time shards on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel llzlab_tpu/kernels/halo_ring.py
// (_ring_send_kernel, entry left_halo_ring): every time shard sends the last
// h samples of its (c, t) block to its right neighbour by an async remote
// copy with send/receive semaphores, and the caller puts the stream carry
// (or zeros) in shard 0.  Here one launch per shard does both halves:
//
//   send     its row tails go into the right neighbour's receive buffer,
//            then the epoch goes into the neighbour's flag (halo_exchange.cuh;
//            the last shard has no neighbour and sends nothing: the TPU
//            kernel's wrap-around copy is masked out by its caller);
//   receive  shard 0 copies the carry (or writes zeros) into `out` and waits
//            for nothing; every other shard waits for the epoch in its own
//            flag and copies its receive buffer into `out`.
//
// What bounds it: bytes.  c*h floats are read and written twice (tail ->
// buffer -> out), 16 MB at 1024 x 2048, microseconds of HBM time; at
// h = 63 the launch and the flag round trip are all there is.  The copy is
// spread over a few blocks only, so that the receivers of every shard of a
// mesh stay resident together with the senders they wait for.
//
// The send precedes the wait in every block, so shards launched in rank
// order on one card cannot wait for a sender that is queued behind them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halo_exchange.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 16;

__global__ void __launch_bounds__(THREADS)
halo_ring_kernel(const float* x, long long stride, int t, int c, int h,
                 float* nbr_buf, int* nbr_flag, const float* my_buf,
                 const int* my_flag, const float* carry, float* out,
                 int* counter, int* err, int epoch, long long limit_ns) {
  const int part = blockIdx.x, nparts = gridDim.x;
  if (nbr_buf != nullptr)
    halo_send(x, stride, t, c, h, nbr_buf, nbr_flag, counter, epoch, part,
              nparts);
  if (my_buf != nullptr) {
    halo_wait(my_flag, epoch, limit_ns, err);
    for (int row = part; row < c; row += nparts)
      halo_copy_row(out + (size_t)row * h, my_buf + (size_t)row * h, h,
                    threadIdx.x, THREADS);
  } else if (carry != nullptr) {
    for (int row = part; row < c; row += nparts)
      halo_copy_row(out + (size_t)row * h, carry + (size_t)row * h, h,
                    threadIdx.x, THREADS);
  } else {
    for (int row = part; row < c; row += nparts)
      for (int i = threadIdx.x; i < h; i += THREADS)
        out[(size_t)row * h + i] = 0.f;
  }
}

}  // namespace

// x: the shard's (c, t) f32 block, rows `stride` floats apart.  nbr_buf /
// nbr_flag: the right neighbour's (c, h) receive buffer and flag, null on
// the last shard.  my_buf / my_flag: this shard's own, null on shard 0, which
// takes `carry` ((c, h) contiguous, or null for zeros) instead.  out: (c, h).
// counter: one zeroed int of this shard; err: this shard's error word.
// Returns cudaGetLastError() after the launch.
extern "C" int halo_ring_launch(const float* x, long long stride, int t, int c,
                                int h, float* nbr_buf, int* nbr_flag,
                                const float* my_buf, const int* my_flag,
                                const float* carry, float* out, int* counter,
                                int* err, int epoch, long long limit_ns,
                                void* stream) {
  if (c <= 0 || h <= 0) return (int)cudaSuccess;
  const int blocks = c < MAX_BLOCKS ? c : MAX_BLOCKS;
  halo_ring_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, stride, t, c, h, nbr_buf, nbr_flag, my_buf, my_flag, carry, out,
      counter, err, epoch, limit_ns);
  return (int)cudaGetLastError();
}

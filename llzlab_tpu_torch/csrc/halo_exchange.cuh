// Halo exchange between time shards from inside a kernel: the protocol of
// kernel B4 (halo_fir_fused.cu) on every edge and of kernel B3
// (halo_ring.cu) on an edge between two cards or two processes (within a
// card of one process B3 copies the tails directly and needs none of this).
//
// A shard's kernel copies the last h samples of each of its rows into its
// right neighbour's receive buffer, then publishes a rising epoch in the
// neighbour's flag; the neighbour's kernel waits until its flag shows the
// epoch and then reads the buffer.  Buffer and flag are plain pointers under
// CUDA's unified addressing: memory of the same card (each shard a stream of
// its own), of a peer card with peer access enabled, or of another process,
// opened through CUDA IPC (on its card or a peer).  So every step of the
// hand-over is at system scope: the data stores are fenced with
// __threadfence_system(), the flag is written with st.release.sys and read
// with ld.acquire.sys, and received data is loaded past L1 (ld.global.cg),
// which is not coherent across SMs or cards.
//
// A wait has a time limit.  A receiver whose sender never comes writes the
// epoch into an error word (pinned host memory, so the host reads it
// without a copy) and goes on with whatever the buffer holds; the wrapper
// raises on a nonzero word.  A hang becomes an error, never a hung card.
//
// Back-pressure.  The send of epoch e + 1 must not land on a buffer that the
// receiver still reads for epoch e.  Within one process a stream event
// orders the sending launch behind the receiving one (the wrapper's).  An
// event cannot order a stream of another process, so between processes
// (buffer and flag opened through CUDA IPC) the receiver acknowledges: once
// every block that reads the buffer has loaded it, the last one in fences
// and publishes the epoch with st.release.sys into an ack word that lives in
// the sender's memory, and the sending blocks wait, with ld.acquire.sys and
// the same time limit, until the ack has reached e - 1 before they store
// (zeroed, so epoch 1 passes at once).  A send whose ack never comes writes
// -epoch into its error word.  This is the port's form of the TPU kernel's
// send / receive semaphores.
//
// Between two hosts (a NET edge) no kernel can store into the receiver's
// memory: a kernel reaches its own card, a peer card and memory opened
// through CUDA IPC, all within one host.  So the receiving half alone stays
// in the kernel.  The sender's tails go out by NCCL's point-to-point send,
// which the host queues before the epoch's kernels launch (from the input,
// so that no shard waits for its left neighbour's kernel); the receiving
// process receives them into its receive buffer on a transfer stream, and
// then a one-thread kernel (halo_net_publish, halo_ring.cu) fences and
// publishes the epoch in the flag with st.release.sys.  The receiving
// kernel waits for the flag and reads the buffer exactly as above; the
// sending kernel gets no neighbour buffer and stores nothing.  Back-pressure
// is the transfer stream's: it waits for the receiving shard's launch of
// the previous epoch before it receives, so no ack word is needed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void halo_flag_store(int* flag, int value) {
  asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(flag), "r"(value)
               : "memory");
}

__device__ __forceinline__ int halo_flag_load(const int* flag) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long halo_now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Copy n floats, every thread of the block taking part (tid of nthr).  src
// and dst may be aligned to 4 bytes only and differently from each other (a
// tail of 63 samples of a strided row): a scalar head brings src to 16 bytes,
// the body is float4 loads (stored as float4 when dst is aligned there too,
// else as four floats), a scalar tail ends it.  Loads bypass L1.
__device__ __forceinline__ void halo_copy_row(float* dst, const float* src,
                                              int n, int tid, int nthr) {
  int head = (int)(((16u - (unsigned)((uintptr_t)src & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  for (int i = tid; i < head; i += nthr) dst[i] = __ldcg(src + i);
  const int nv = (n - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float* d = dst + head;
  if (((uintptr_t)d & 15u) == 0) {
    float4* d4 = reinterpret_cast<float4*>(d);
    for (int i = tid; i < nv; i += nthr) d4[i] = __ldcg(s4 + i);
  } else {
    for (int i = tid; i < nv; i += nthr) {
      const float4 v = __ldcg(s4 + i);
      d[4 * i] = v.x;
      d[4 * i + 1] = v.y;
      d[4 * i + 2] = v.z;
      d[4 * i + 3] = v.w;
    }
  }
  for (int i = head + 4 * nv + tid; i < n; i += nthr) dst[i] = __ldcg(src + i);
}

// Thread 0 of the block spins until *word >= target, then the block is
// released through __syncthreads().  Past limit_ns `code` goes into *err and
// the block goes on.  Every thread of the block must call this.
__device__ __forceinline__ void halo_wait_for(const int* word, int target,
                                              long long limit_ns, int* err,
                                              int code) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = halo_now_ns();
    while (halo_flag_load(word) < target) {
      if (halo_now_ns() - t0 > (unsigned long long)limit_ns) {
        *reinterpret_cast<volatile int*>(err) = code;
        __threadfence_system();
        break;
      }
      __nanosleep(200);
    }
  }
  __syncthreads();
}

// Send: blocks part = 0 .. nparts-1 of the launch each copy their share of the
// c row tails (x + row*stride + t - h, h floats) into the neighbour's (c, h)
// buffer.  Each block fences its stores and counts itself in; the last one in
// resets the counter for the next launch and publishes the epoch.  ack
// non-null (a neighbour in another process): each block first waits until the
// receiver has acknowledged epoch - 1 (err: the sender's error word).  Every
// thread of a sending block must call this (it holds a __syncthreads()).
__device__ __forceinline__ void halo_send(const float* x, long long stride,
                                          int t, int c, int h, float* nbr_buf,
                                          int* nbr_flag, int* counter,
                                          int epoch, int part, int nparts,
                                          const int* ack, long long limit_ns,
                                          int* err) {
  if (ack != nullptr) halo_wait_for(ack, epoch - 1, limit_ns, err, -epoch);
  for (int row = part; row < c; row += nparts)
    halo_copy_row(nbr_buf + (size_t)row * h, x + (size_t)row * stride + (t - h),
                  h, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (atomicAdd(counter, 1) == nparts - 1) {
      *counter = 0;
      __threadfence_system();
      halo_flag_store(nbr_flag, epoch);
    }
  }
}

// Wait (thread 0 of the block) until *flag >= epoch, then release the block
// through __syncthreads().  Past limit_ns the epoch goes into *err and the
// block goes on.  Every thread of the block must call this.
__device__ __forceinline__ void halo_wait(const int* flag, int epoch,
                                          long long limit_ns, int* err) {
  halo_wait_for(flag, epoch, limit_ns, err, epoch);
}

// Acknowledge: called by every thread of each of the nreaders blocks that
// read the receive buffer, after the block's last load from it.  The loads
// of the block's threads are behind the barrier; thread 0 fences at system
// scope and counts the block in (rcount: one zeroed int of this shard); the
// last block in resets the count for the next launch, fences again and
// publishes the epoch in the sender's ack word.
__device__ __forceinline__ void halo_ack(int* ack, int* rcount, int epoch,
                                         int nreaders) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (atomicAdd(rcount, 1) == nreaders - 1) {
      *rcount = 0;
      __threadfence_system();
      halo_flag_store(ack, epoch);
    }
  }
}

// Kernel sos_scan: the blockwise scan of a cascade of biquad sections,
// ops/iir.py sosfilt, on an H100 (sm_90a).
//
// Replaces no TPU kernel.  The JAX package scans the cascade with
// lax.associative_scan inside blocks and lax.scan across them, and the
// port ran the same doubling as tensor code: per section some twelve
// doubling steps of slices, products and sums, then the carry across
// blocks read to the host and computed there, then an output pass.  At 64
// channels of one 4096-sample block that is ~530 launches and 16
// synchronous reads for work the card does in a microsecond.  This kernel
// does all of it in one launch: every section, every block of the call,
// and the carry, which never leaves the card.
//
// What bounds it: bytes, in principle (4 B read and 4 B written a sample;
// 9 FLOP a section a sample).  In practice the doubling's shared-memory
// traffic, 16 B an element a step, and one barrier a step: a CTA walks its
// row's blocks in order, so a row's time grows with the blocks of the call.
//
// The contract is bit for bit the tensor code of ops/iir.py
// (apply_section_host steps 1 to 3, _host_carry, _state_at), so that a
// stream cut at multiples of the block resumes bitwise and the card agrees
// with the CPU:
//   * one CTA per row walks the call's blocks in order; in a block it runs
//     every section, section s's output block being section s+1's input,
//     held in registers.  A section's block j depends only on its input
//     block and on the state entering it (its own block j-1), so this
//     block-major order gives the tensor code's section-major bits;
//   * zero-state scan: z = x*u, then at shift sh (1, 2, 4, ... < L), for
//     k >= sh, z[k] += (z0[k-sh]*m00 + z1[k-sh]*m01, z0[k-sh]*m10 +
//     z1[k-sh]*m11), m = P^sh, from the values before the step.  Thread
//     tid owns elements k = e*T + tid (T up to 1024, e < 8); every step
//     goes through shared memory, the two buffers written in turn, one
//     barrier a step and one before the output: nsh + 1 a section-block.
//     The sections' heads and steps are staged in shared memory once, and
//     the output weights g are loaded before the output's barrier;
//   * the state entering block j+1 is z[L-1] + (s0*P^L[:,0] + s1*P^L[:,1]),
//     zf the same at the call's last sample with P^(k+1);
//   * y[k] = ((x*b0) + (z0[k-1]*c1 + z1[k-1]*c2)) + (s0*g0[k] + s1*g1[k]),
//     without the middle term at k = 0;
//   * samples at or after t read as zeros and are never stored: nothing
//     before them depends on them;
//   * every product and sum is __fmul_rn / __fadd_rn, which nvcc never
//     contracts into an FMA (the build's flags allow contraction).
//
// Blocks longer than MAX_THREADS * MAX_ELEMS samples, or sections whose
// heads and steps overflow shared memory, take sos_scan_wide_kernel: the
// same operations in the same order, the doubling's two buffers in global
// scratch (2 L float2 a CTA, most of it in L2) and a section's block in y
// (section s reads its input there and writes its output in place, each
// element by the thread that owns it), the tables read from global
// memory; its CTAs walk the rows by a grid stride.  Only the elements
// below t are computed: no step's sum for them reads a later one.
//
// Tables (kernels/sos_scan.py packs them from ops/iir.py _scan_tables_host,
// float32, one row of `stride` floats a section):
//   [0] u0 [1] u1 [2] c1 [3] c2 [4] b0 [5..7] 0,
//   [8 + 4i ..] P^(2^i) row-major, i < nsh,
//   [8 + 4nsh ..] g: L pairs (g0[k], g1[k]),
//   [8 + 4nsh + 2L ..] P^(k+1) row-major, k < L.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_ELEMS = 8;  // elements a thread: L <= 8192
constexpr int HEAD = 8;
constexpr size_t SMEM_MAX = 232448;  // 227 KB per block on sm_90

__host__ __device__ inline long long table_stride(int L, int nsh) {
  return HEAD + 4LL * nsh + 6LL * L;
}

// z + (s0*P[:,0] + s1*P[:,1]) with P row-major: ops/iir.py _state_at.
__device__ inline float2 state_at(float z0, float z1, float2 s,
                                  const float* __restrict__ p) {
  return make_float2(
      __fadd_rn(z0, __fadd_rn(__fmul_rn(s.x, p[0]), __fmul_rn(s.y, p[1]))),
      __fadd_rn(z1, __fadd_rn(__fmul_rn(s.x, p[2]), __fmul_rn(s.y, p[3]))));
}

template <int E>
__global__ void __launch_bounds__(MAX_THREADS)
sos_scan_kernel(const float* __restrict__ x, const float* __restrict__ tab,
                const float* __restrict__ zi, float* __restrict__ y,
                float* __restrict__ zf, int t, int L, int ns, int nsh) {
  // Shared memory: the doubling's two buffers of L elements, written in
  // turn (a barrier after each write: so the buffer a write reuses was
  // last read before the barrier in between); the states entering a
  // block, two sets of ns by the block's parity (read and written in the
  // same phase); each section's head and doubling steps.
  extern __shared__ float2 smem[];
  float2* st = smem + 2 * L;
  const int nhd = HEAD + 4 * nsh;
  float* hd = reinterpret_cast<float*>(st + 2 * ns);
  const int T = blockDim.x, tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long stride = table_stride(L, nsh);
  const float* xr = x + row * t;
  float* yr = y + row * t;
  for (int i = tid; i < ns * nhd; i += T)
    hd[i] = tab[(i / nhd) * stride + i % nhd];
  for (int s = tid; s < ns; s += T)
    st[s] = zi ? make_float2(zi[(row * ns + s) * 2],
                             zi[(row * ns + s) * 2 + 1])
               : make_float2(0.f, 0.f);
  __syncthreads();

  const int nblk = (t + L - 1) / L;
  const int klast = (t - 1) - (nblk - 1) * L;  // zf's index in the last block
  int p = 0;  // the buffer of the next write
  float v[E], z0[E], z1[E];
  for (int j = 0; j < nblk; ++j) {
    const long long off = (long long)j * L;
    const float2* st_in = st + (j & 1) * ns;
    float2* st_out = st + ((j + 1) & 1) * ns;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = e * T + tid;
      v[e] = (k < L && off + k < t) ? xr[off + k] : 0.f;
    }
    for (int s = 0; s < ns; ++s) {
      const float* h = hd + s * nhd;
      const float u0 = h[0], u1 = h[1];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        z0[e] = __fmul_rn(v[e], u0);
        z1[e] = __fmul_rn(v[e], u1);
      }
      // 1. the zero-state scan of the block
      for (int i = 0; i < nsh; ++i) {
        const int sh = 1 << i;
        const float* m = h + HEAD + 4 * i;
        const float m00 = m[0], m01 = m[1], m10 = m[2], m11 = m[3];
        float2* b = smem + p * L;
        p ^= 1;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int k = e * T + tid;
          if (k < L) b[k] = make_float2(z0[e], z1[e]);
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int k = e * T + tid;
          if (k >= sh && k < L) {
            const float2 a = b[k - sh];
            z0[e] = __fadd_rn(z0[e], __fadd_rn(__fmul_rn(a.x, m00),
                                               __fmul_rn(a.y, m01)));
            z1[e] = __fadd_rn(z1[e], __fadd_rn(__fmul_rn(a.x, m10),
                                               __fmul_rn(a.y, m11)));
          }
        }
      }
      // 3. the output, the state entering the block folded in; it is the
      //    next section's input
      const float* sec = tab + s * stride;
      const float2* g = reinterpret_cast<const float2*>(sec + nhd);
      const float* pk = sec + nhd + 2 * L;  // P^(k+1)
      float2 gk[E];
      float2* b = smem + p * L;
      p ^= 1;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = e * T + tid;
        if (k < L) {
          gk[e] = g[k];
          b[k] = make_float2(z0[e], z1[e]);
        }
      }
      __syncthreads();
      const float c1 = h[2], c2 = h[3], b0 = h[4];
      const float2 s_in = st_in[s];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = e * T + tid;
        if (k >= L) continue;
        float out = __fmul_rn(v[e], b0);
        if (k > 0) {
          const float2 q = b[k - 1];
          out = __fadd_rn(out, __fadd_rn(__fmul_rn(q.x, c1),
                                         __fmul_rn(q.y, c2)));
        }
        v[e] = __fadd_rn(out, __fadd_rn(__fmul_rn(s_in.x, gk[e].x),
                                        __fmul_rn(s_in.y, gk[e].y)));
        // 2. the carry: the state entering the next block, and zf
        if (k == L - 1) st_out[s] = state_at(z0[e], z1[e], s_in, pk + 4 * k);
        if (zf && j == nblk - 1 && k == klast) {
          const float2 f = state_at(z0[e], z1[e], s_in, pk + 4 * k);
          zf[(row * ns + s) * 2] = f.x;
          zf[(row * ns + s) * 2 + 1] = f.y;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = e * T + tid;
      if (k < L && off + k < t) yr[off + k] = v[e];
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
sos_scan_wide_kernel(const float* x, const float* __restrict__ tab,
                     const float* __restrict__ zi, float* y, float* zf,
                     float2* scratch, int rows, int t, int L, int ns,
                     int nsh) {
  // Shared memory: the states entering a block, two sets of ns by the
  // block's parity, as in sos_scan_kernel.  Global scratch: the doubling's
  // two buffers of this CTA, written in turn, a barrier after each write.
  // x and y are not __restrict__: a section reads its input from either.
  extern __shared__ float2 st[];
  const int T = blockDim.x, tid = threadIdx.x;
  const long long stride = table_stride(L, nsh);
  float2* zbuf = scratch + (long long)blockIdx.x * 2 * L;
  const int nblk = (t + L - 1) / L;
  const int klast = (t - 1) - (nblk - 1) * L;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* xr = x + row * t;
    float* yr = y + row * t;
    __syncthreads();  // the last row's reads of the states are done
    for (int s = tid; s < ns; s += T)
      st[s] = zi ? make_float2(zi[(row * ns + s) * 2],
                               zi[(row * ns + s) * 2 + 1])
                 : make_float2(0.f, 0.f);
    __syncthreads();
    int p = 0;  // the buffer of the next write
    for (int j = 0; j < nblk; ++j) {
      const long long off = (long long)j * L;
      const int n = (int)min((long long)L, t - off);  // elements computed
      const float2* st_in = st + (j & 1) * ns;
      float2* st_out = st + ((j + 1) & 1) * ns;
      for (int s = 0; s < ns; ++s) {
        const float* h = tab + s * stride;
        const float u0 = h[0], u1 = h[1];
        const float* src = (s == 0 ? xr : yr) + off;
        float2* a = zbuf + p * L;
        p ^= 1;
        for (int k = tid; k < n; k += T) {
          const float v = src[k];
          a[k] = make_float2(__fmul_rn(v, u0), __fmul_rn(v, u1));
        }
        __syncthreads();
        // 1. the zero-state scan of the block; a shift of n or more
        //    changes none of its elements
        for (int i = 0; i < nsh && (1 << i) < n; ++i) {
          const int sh = 1 << i;
          const float* m = h + HEAD + 4 * i;
          const float m00 = m[0], m01 = m[1], m10 = m[2], m11 = m[3];
          const float2* b = zbuf + (p ^ 1) * L;
          float2* c = zbuf + p * L;
          p ^= 1;
          for (int k = tid; k < n; k += T) {
            float2 z = b[k];
            if (k >= sh) {
              const float2 q = b[k - sh];
              z = make_float2(
                  __fadd_rn(z.x, __fadd_rn(__fmul_rn(q.x, m00),
                                           __fmul_rn(q.y, m01))),
                  __fadd_rn(z.y, __fadd_rn(__fmul_rn(q.x, m10),
                                           __fmul_rn(q.y, m11))));
            }
            c[k] = z;
          }
          __syncthreads();
        }
        // 3. the output in place, the state entering the block folded in
        const float2* z = zbuf + (p ^ 1) * L;
        const float2* g = reinterpret_cast<const float2*>(h + HEAD + 4 * nsh);
        const float* pk = h + HEAD + 4 * nsh + 2 * L;  // P^(k+1)
        const float c1 = h[2], c2 = h[3], b0 = h[4];
        const float2 s_in = st_in[s];
        for (int k = tid; k < n; k += T) {
          float out = __fmul_rn(src[k], b0);
          if (k > 0) {
            const float2 q = z[k - 1];
            out = __fadd_rn(out, __fadd_rn(__fmul_rn(q.x, c1),
                                           __fmul_rn(q.y, c2)));
          }
          const float2 gk = g[k];
          yr[off + k] = __fadd_rn(out, __fadd_rn(__fmul_rn(s_in.x, gk.x),
                                                 __fmul_rn(s_in.y, gk.y)));
          // 2. the carry: the state entering the next block, and zf
          if (k == L - 1)
            st_out[s] = state_at(z[k].x, z[k].y, s_in, pk + 4 * k);
          if (zf && j == nblk - 1 && k == klast) {
            const float2 f = state_at(z[k].x, z[k].y, s_in, pk + 4 * k);
            zf[(row * ns + s) * 2] = f.x;
            zf[(row * ns + s) * 2 + 1] = f.y;
          }
        }
        __syncthreads();  // z read, y written before the next section
      }
    }
  }
}

// Shared memory of a launch: the doubling's two buffers, two sets of
// states and the sections' heads and steps.
long long sos_scan_smem_bytes(int L, int ns, int nsh) {
  return (long long)sizeof(float2) * (2LL * L + 2LL * ns) +
         (long long)sizeof(float) * ns * (HEAD + 4LL * nsh);
}

// Whether a launch takes sos_scan_wide_kernel (kernels/sos_scan.py
// mirrors this in ScanTables.wide).
bool sos_scan_is_wide(int L, int ns, int nsh) {
  return L > MAX_THREADS * MAX_ELEMS ||
         (size_t)sos_scan_smem_bytes(L, ns, nsh) > SMEM_MAX;
}

template <int E>
int launch(const float* x, const float* tab, const float* zi, float* y,
           float* zf, int rows, int t, int L, int ns, int nsh,
           cudaStream_t s) {
  const int threads = ((L + E - 1) / E + 31) / 32 * 32;
  const size_t smem = (size_t)sos_scan_smem_bytes(L, ns, nsh);
  cudaError_t e = cudaFuncSetAttribute(
      sos_scan_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sos_scan_kernel<E><<<rows, threads, smem, s>>>(x, tab, zi, y, zf, t, L,
                                                  ns, nsh);
  return (int)cudaGetLastError();
}

}  // namespace


// x, y: (rows, t) f32; tab: (ns, stride) f32 as above; zi: (rows, ns, 2)
// f32 or null for zeros; zf: (rows, ns, 2) f32 or null.  One CTA a row,
// or for the wide kernel `ctas` CTAs over the rows and `scratch`, 2 L
// float2 a CTA (null otherwise).  Returns cudaGetLastError() after the
// launch, or the error that kept it from launching (the wide kernel
// without scratch, or its states above 227 KB of shared memory).
extern "C" int sos_scan_launch(const float* x, const float* tab,
                               const float* zi, float* y, float* zf,
                               int rows, int t, int L, int ns, int nsh,
                               float* scratch, int ctas, void* stream) {
  if (rows <= 0 || t <= 0) return (int)cudaSuccess;
  if (L <= 0 || ns <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (sos_scan_is_wide(L, ns, nsh)) {
    const size_t smem = sizeof(float2) * 2 * (size_t)ns;
    if (!scratch || ctas <= 0 || smem > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        sos_scan_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int threads = min(MAX_THREADS, (L + 31) / 32 * 32);
    sos_scan_wide_kernel<<<min(rows, ctas), threads, smem, s>>>(
        x, tab, zi, y, zf, reinterpret_cast<float2*>(scratch), rows, t, L,
        ns, nsh);
    return (int)cudaGetLastError();
  }
  // the fewest elements a thread that 1024 threads allow
  if (L <= MAX_THREADS)
    return launch<1>(x, tab, zi, y, zf, rows, t, L, ns, nsh, s);
  if (L <= 2 * MAX_THREADS)
    return launch<2>(x, tab, zi, y, zf, rows, t, L, ns, nsh, s);
  if (L <= 4 * MAX_THREADS)
    return launch<4>(x, tab, zi, y, zf, rows, t, L, ns, nsh, s);
  return launch<8>(x, tab, zi, y, zf, rows, t, L, ns, nsh, s);
}

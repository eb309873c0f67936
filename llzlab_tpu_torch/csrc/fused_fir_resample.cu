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
// What bounds it: stage 1 costs ntaps multiply-adds per input sample and
// stage 2 about K*up/down, so at the headline shape (1024 taps, 147/160,
// K = 64) the FIR is ~95% of the arithmetic, and the whole step is
// compute-bound (about 4 bytes of device memory per 2 kFLOP).  At
// "highest" that is the CUDA cores' fp32 FMA rate; at "high" the three
// bf16 passes belong to the tensor cores, where the bound is shared-memory
// loads of the operand fragments (fir_mma.cuh).
//
// Design (the TPU's choices - 20480-sample programs, lane-aligned group
// counts, a zeroed scratch tail - answer to VMEM and do not carry over):
//   * one CUDA block per (run of GS output groups, channel); a block finds
//     its own offsets and reads its left context straight from x, or from
//     the history for negative stream indices, so blocks are independent;
//   * stage 1 computes the run's y plus the K-1 samples of left halo into
//     shared memory.  The halo recomputes what the neighbouring block also
//     computes.  The y window starts at a multiple of 8 of the absolute
//     stream index (up to 7 outputs before the first one needed), because
//     the tensor-core sum order depends on the output index mod 8
//     (fir_mma.cuh): with that, both copies of a halo, both sides of a
//     stream split and both sides of a time shard's edge are bitwise equal,
//     whatever the block grid.  At "highest" the order depends on the tap
//     index alone (fir_tile.cuh, the same order as kernel B2);
//   * "highest": fp32 FMA from a register window (fir_tile.cuh), 512
//     threads.  "high": x is split into bf16 hi/lo on load and kept as
//     bf16, the taps become a (kt, 8) Toeplitz tile, and 8 warps run
//     x_hi*w_hi + x_lo*w_hi + x_hi*w_lo on mma.sync with fp32 accumulators
//     (fir_mma.cuh), four 128-output m-tiles a warp; y is split into bf16
//     hi/lo again and stays in shared memory as bf16 (70 KB a block at the
//     headline, three blocks on an SM);
//   * stage 2, "highest": the K nonzero entries of a phase in order of j
//     on fp32 FMA.  A thread keeps one phase p for STAGE2_G groups whose y
//     windows are a multiple of 4 samples apart: a bank entry (stored
//     (K, up), read through L1 in coalesced rows) is loaded once for all of
//     them, and each group's K consecutive y values come as aligned
//     4-sample vectors: 9 loads for 20 multiply-adds where one multiply-add
//     cost two loads.  "high": the dense slab product on mma.sync from an
//     aligned copy of the slab in the shared memory stage 1 has left
//     (resample_stage_mma below);
//   * the run of GS groups is sized by the caller so that its y window
//     (GS*down + K-1 samples and 7 of alignment) just fits whole passes of
//     STEP outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_mma.cuh"
#include "fir_tile.cuh"

namespace {

constexpr int THREADS = 512;                // "highest"
constexpr int THREADS_HIGH = 256;           // "high": 8 warps
constexpr int MT = 4;                       // m-tiles a warp owns in a pass
constexpr int PASS_HIGH = THREADS_HIGH / 32 * MT * FIR_MMA_TILE;
constexpr int STEP = 4096;                  // the y window's granularity:
static_assert(STEP % PASS_HIGH == 0, "whole passes at high");
static_assert(STEP % (THREADS * 4) == 0, "whole passes at highest");
constexpr int ALIGN = FIR_MMA_N;            // the y window's origin
constexpr int STAGE2_G = 5;                 // groups a stage-2 thread keeps
constexpr size_t SMEM_MAX = 232448;         // 227 KB per block on sm_90

// Mirrored by _smem_bytes in kernels/fused_fir_resample.py:
//   ly  = gs*down + k-1 + 7           y samples a block may need
//   lyp = ly rounded up to 4096       y samples it computes and keeps
//   highest: ntp = ntaps rounded up to 32; lx = lyp + ntp;
//            smem = 4 * (ntp + lx + lyp)
//   high:    kt = ntaps + 7 rounded up to 16; lx = lyp + kt - 8;
//            k2 = down + k-1 rounded up to 16;
//            scratch = max(2 * 8 * (kt + 8) + 2 * lx, 2 * 32 * (k2 + 8))
//            (stage 1's operands, then stage 2's slab of at least 32 rows)
//            smem = 2 * (scratch + 2 * lyp)
struct Geometry {
  int ntp;      // taps rounded up with zeros: rows of W in "high"
  int lyp;      // y window
  int lx;       // x window
  int k2;       // "high": columns of the stage-2 slab
  int scratch;  // "high": bf16 elements before the y window
  size_t smem;
};

Geometry geometry(int ntaps, int down, int k, int gs, int high) {
  Geometry g;
  const int ly = gs * down + k - 1 + (ALIGN - 1);
  g.lyp = (ly + STEP - 1) / STEP * STEP;
  if (high) {
    g.ntp = fir_mma_kt(ntaps);
    g.lx = g.lyp + g.ntp - FIR_MMA_N;
    g.k2 = (down + k - 1 + 15) / 16 * 16;
    const int stage1 = 2 * FIR_MMA_N * fir_mma_w_stride(g.ntp) + 2 * g.lx;
    const int slab = 2 * 32 * (g.k2 + 8);
    g.scratch = stage1 > slab ? stage1 : slab;
    g.smem = sizeof(__nv_bfloat16) * ((size_t)g.scratch + 2 * g.lyp);
  } else {
    g.k2 = g.scratch = 0;
    g.ntp = (ntaps + FIR_CHUNK - 1) / FIR_CHUNK * FIR_CHUNK;
    g.lx = g.lyp + g.ntp;
    g.smem = sizeof(float) * ((size_t)g.ntp + g.lx + g.lyp);
  }
  return g;
}

// The sample at stream index sm of one row: x, the carried history below
// index 0, zero outside both.
__device__ __forceinline__ float stream_sample(const float* __restrict__ xr,
                                               const float* __restrict__ hr,
                                               int sm, int t, int hl) {
  if (sm < 0) return sm >= -hl ? hr[hl + sm] : 0.f;
  return sm < t ? xr[sm] : 0.f;
}

// ---- stage 2, "highest": the K nonzero entries of a phase on fp32 FMA ----
// Group g of this block, phase p: z = sum_j y_loc[top - j] * bank[j][p],
// top = a + g*down + (p*down)/up + k-1 (a: the window's alignment samples),
// j ascending in one running sum.  A thread walks y downwards in aligned
// vectors of 4 for STAGE2_G groups gstride apart (gstride*down % 4 == 0, so
// all of them meet the same j in the same vector lane); entries of a vector
// outside 0 <= j < k are skipped, not multiplied by zero.
__device__ __forceinline__ void resample_stage(
    const float* yw, const float* __restrict__ bank, float* __restrict__ zr,
    int a, int ng, int up, int down, int k, int gstride, int tid, int nthr) {
  constexpr int G = STAGE2_G;
  const int span = G * gstride;
  const int nsets = (ng + span - 1) / span * gstride;
  const int gstep = gstride * down;
  for (int o = tid; o < nsets * up; o += nthr) {
    const int u = o / up, p = o - u * up;
    const int g0 = (u / gstride) * span + u % gstride;
    if (g0 >= ng) continue;
    const int top = a + g0 * down + (p * down) / up + k - 1;
    const int rho = top & 3;
    const int nvec = ((top - rho) - ((top - k + 1) & ~3)) / 4 + 1;
    int yoff[G];
    float acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      // a group past the run's end re-reads group g0 and is not stored
      yoff[i] = g0 + i * gstride < ng ? i * gstep : 0;
      acc[i] = 0.f;
    }
    for (int v = 0; v < nvec; ++v) {
      // lane e of this vector is y_loc[top - rho - 4v + e], tap j0 - e
      const int j0 = 4 * v + rho;
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 - e;
        w[e] = j >= 0 && j < k ? __ldg(bank + j * up + p) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(
            yw + top - rho - 4 * v + yoff[i]);
        const float y4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 3; e >= 0; --e) {  // ascending j
          const int j = j0 - e;
          if (j >= 0 && j < k) acc[i] = fmaf(y4[e], w[e], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int g = g0 + i * gstride;
      if (g < ng) zr[(size_t)g * up + p] = acc[i];
    }
  }
}

// ---- stage 2, "high": the dense slab product on the tensor cores ---------
// z[g][p] = sum_tau slab[g][tau] * R[p][tau], slab[g][tau] = y_loc[a + g*down
// + tau], tau < down + k-1: the TPU kernel's dense form (3.5x the K-sparse
// work at 147/160, a quarter of stage 1's products).  A slab row starts
// wherever its group does, which ldmatrix cannot address (rows must be 16
// bytes aligned), so runs of `rows` groups are first copied from the y
// window into a row-major (rows, k2 + 8) matrix, hi and lo, in the shared
// memory that stage 1's operands have left (sh, sl).  R comes from device
// memory through L1 in the order of the B fragments: for n-tile nt (8
// phases) and chunk ks (16 taus), lane l finds its four registers (hi tau
// 0-7, hi tau 8-15, lo, lo) as one 16-byte word at ((nt * k2/16 + ks) * 32
// + l), so a warp's load is 512 contiguous bytes, used once for two
// m-tiles.  Row p of R is zero outside tau = q_p .. q_p + k-1, q_p =
// (p*down)/up, so an n-tile visits only the chunks its eight phases reach
// (6 of 14 at 147/160); the skipped products are exact zeros.  The three
// products and their order are stage 1's; a sum's order depends on p and
// tau alone.  Every thread of the block must call this.
__device__ __forceinline__ void resample_stage_mma(
    const __nv_bfloat16* yh, const __nv_bfloat16* yl, __nv_bfloat16* sh,
    __nv_bfloat16* sl, int rows, const uint4* __restrict__ bank,
    float* __restrict__ zr, int a, int ng, int up, int down, int k, int k2,
    int tid, int nthr) {
  const int ss = k2 + 8;  // 16 * odd bytes: conflict-free ldmatrix rows
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int ntiles = (up + 7) / 8, nks = k2 / 16;
  const int kd = down + k - 1;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int g_base = 0; g_base < ng; g_base += rows) {
    const int gc = min(rows, ng - g_base);
    const int gcp = (gc + 31) / 32 * 32;  // whole pairs of m-tiles
    for (int i = tid; i < gcp * k2; i += nthr) {
      const int g = i / k2, tau = i - g * k2;
      const bool in = g < gc && tau < kd;
      const int src = a + (g_base + g) * down + tau;
      sh[g * ss + tau] = in ? yh[src] : zero;
      sl[g * ss + tau] = in ? yl[src] : zero;
    }
    __syncthreads();
    // A: lane l addresses row l % 8 of matrix l / 8, matrices (rows 0-7 |
    // 8-15) x (k 0-7 | 8-15) in the fragment's register order
    const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ss +
                      (lane >> 4) * 8;
    for (int nt = warp; nt < ntiles; nt += nwarps) {
      const uint4* b_frag = bank + (size_t)nt * nks * 32 + lane;
      // the chunks that hold a nonzero of phases 8 nt .. 8 nt + 7
      const int p_hi = min(8 * nt + 7, up - 1);
      const int ks_lo = (8 * nt * down / up) / 16;
      const int ks_hi = (p_hi * down / up + k - 1) / 16;
      for (int m0 = 0; m0 < gcp / 16; m0 += 2) {
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int ks = ks_lo; ks <= ks_hi; ++ks) {
          const uint4 bq = __ldg(b_frag + ks * 32);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t ah[4], al[4];
            const int off = a_off + 16 * (m0 + mt) * ss + 16 * ks;
            fir_mma_ldmatrix4(ah, sh + off);
            fir_mma_ldmatrix4(al, sl + off);
            fir_mma_16816(acc[mt], ah, bq.x, bq.y);  // y_hi * r_hi
            fir_mma_16816(acc[mt], al, bq.x, bq.y);  // y_lo * r_hi
            fir_mma_16816(acc[mt], ah, bq.z, bq.w);  // y_hi * r_lo
          }
        }
        const int p = 8 * nt + 2 * (lane & 3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int g = 16 * (m0 + mt) + 8 * half + (lane >> 2);
            if (g < gc) {
              float* zg = zr + (size_t)(g_base + g) * up;
              if (p < up) zg[p] = acc[mt][2 * half];
              if (p + 1 < up) zg[p + 1] = acc[mt][2 * half + 1];
            }
          }
      }
    }
    __syncthreads();  // the slab is rewritten for the next run of groups
  }
}

// Origin of a block's y window: the first y that group s0 needs,
// s0*down - (k-1), rounded down to a multiple of ALIGN (it may be negative).
__device__ __forceinline__ int window_origin(int s0, int down, int k,
                                             int* a) {
  const int first = s0 * down - (k - 1);
  *a = ((first % ALIGN) + ALIGN) % ALIGN;
  return first - *a;
}

__global__ void __launch_bounds__(THREADS)
fused_highest_kernel(const float* __restrict__ x,
                     const float* __restrict__ hist,
                     const float* __restrict__ fir,
                     const float* __restrict__ bank, float* __restrict__ z,
                     int t, int hl, int ntaps, int up, int down, int k,
                     int gs, int gstride, int s_total, Geometry geo) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ntp = geo.ntp, lyp = geo.lyp, lx = geo.lx;
  // lengths are multiples of 32, so the float4 loads stay 16-byte aligned
  float* xw = smem;        // [lx] input window
  float* th = xw + lx;     // [ntp] FIR taps
  float* yw = th + ntp;    // [lyp] FIR output window

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * gs;
  const float* xr = x + (size_t)b * t;
  const float* hr = hist + (size_t)b * hl;

  for (int i = tid; i < ntp; i += THREADS) th[i] = i < ntaps ? fir[i] : 0.f;
  // xw[m] = xs[m0 + m]: y_loc[i] = y[y0 + i] needs xs[y0 + i - j] for taps
  // j < ntp.  Negative stream indices come from the history (the envelope
  // keeps them >= -hl for real taps).
  int a;
  const int y0 = window_origin(s0, down, k, &a);
  const int m0 = y0 - (ntp - 1);
  for (int m = tid; m < lx; m += THREADS)
    xw[m] = stream_sample(xr, hr, m0 + m, t, hl);
  __syncthreads();

  // ---- stage 1: FIR into shared memory --------------------------------
  for (int base = 0; base < lyp; base += THREADS * 4) {
    const int i0 = base + 4 * tid;
    float acc[4];
    fir_out4(xw, th, ntp, i0, acc);
    *reinterpret_cast<float4*>(yw + i0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();

  const int ng = min(gs, s_total - s0);
  float* zr = z + (size_t)b * s_total * up + (size_t)s0 * up;
  resample_stage(yw, bank, zr, a, ng, up, down, k, gstride, tid, THREADS);
}

__global__ void __launch_bounds__(THREADS_HIGH)
fused_high_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                  const __nv_bfloat16* __restrict__ fir_hi,
                  const __nv_bfloat16* __restrict__ fir_lo,
                  const uint4* __restrict__ bank, float* __restrict__ z,
                  int t, int hl, int ntaps, int up, int down, int k, int gs,
                  int s_total, Geometry geo) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int kt = geo.ntp, lyp = geo.lyp, lx = geo.lx;
  const int wsz = FIR_MMA_N * fir_mma_w_stride(kt);
  // every length is a multiple of 8 elements: 16-byte aligned rows for
  // ldmatrix
  __nv_bfloat16* wh = smem;       // [8][kt + 8] Toeplitz of the taps, hi
  __nv_bfloat16* wl = wh + wsz;   //             lo
  __nv_bfloat16* xh = wl + wsz;   // [lx] input window, hi
  __nv_bfloat16* xl = xh + lx;    //                    lo
  __nv_bfloat16* yh = smem + geo.scratch;  // [lyp] FIR output window, hi
  __nv_bfloat16* yl = yh + lyp;            //                          lo

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * gs;
  const float* xr = x + (size_t)b * t;
  const float* hr = hist + (size_t)b * hl;

  fir_mma_stage_w(wh, wl, fir_hi, fir_lo, ntaps, kt, tid, THREADS_HIGH);
  // xw[m] = xs[m0 + m], and y_loc[i] = y[y0 + i] with y0 a multiple of 8
  int a;
  const int y0 = window_origin(s0, down, k, &a);
  const int m0 = y0 - (kt - FIR_MMA_N);
  for (int m = tid; m < lx; m += THREADS_HIGH)
    fir_mma_split(stream_sample(xr, hr, m0 + m, t, hl), &xh[m], &xl[m]);
  __syncthreads();

  // ---- stage 1: FIR on the tensor cores into shared memory -------------
  const int warp = tid >> 5, lane = tid & 31;
  for (int base = 0; base < lyp; base += PASS_HIGH) {
    const int tile0 = base / FIR_MMA_TILE + warp * MT;
    float acc[MT][4];
    fir_mma_tiles<MT>(xh, xl, wh, wl, kt, tile0, acc);
#pragma unroll
    for (int q = 0; q < MT; ++q) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = FIR_MMA_TILE * (tile0 + q) + 64 * half +
                      8 * (lane >> 2) + 2 * (lane & 3);
        __nv_bfloat162 hi, lo;
        fir_mma_split(acc[q][2 * half], &hi.x, &lo.x);
        fir_mma_split(acc[q][2 * half + 1], &hi.y, &lo.y);
        *reinterpret_cast<__nv_bfloat162*>(yh + i) = hi;
        *reinterpret_cast<__nv_bfloat162*>(yl + i) = lo;
      }
    }
  }
  __syncthreads();

  const int ng = min(gs, s_total - s0);
  float* zr = z + (size_t)b * s_total * up + (size_t)s0 * up;
  // the slab takes the place of W and the x window
  const int ss = geo.k2 + 8;
  const int rows = geo.scratch / (2 * ss) / 32 * 32;
  resample_stage_mma(yh, yl, smem, smem + rows * ss, rows, bank, zr, a, ng,
                     up, down, k, geo.k2, tid, THREADS_HIGH);
}

}  // namespace

// x: (batch, t) f32, t % down == 0.  hist: (batch, hl) f32, the carried
// stream history (hl = 2*block).  z: (batch, t/down*up) f32.
// high == 0: fir_a (ntaps,) and bank_a (k, up) are f32, bank[j][p] =
// R[p, (p*down)/up + k-1-j]; fir_b and bank_b are unused.  high == 1:
// fir_a / fir_b are the bf16 hi / lo parts of the taps, and bank_a is the
// dense bank R, zero-padded to (up rounded up to 8, down + k-1 rounded up
// to 16), bf16 hi and lo in the order of the mma B fragments (see
// resample_stage_mma); bank_b is unused.
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
  const int gstride = down % 4 == 0 ? 1 : (down % 2 == 0 ? 2 : 4);
  const dim3 grid((s_total + gs - 1) / gs, batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (high) {
    cudaFuncSetAttribute(fused_high_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)geo.smem);
    fused_high_kernel<<<grid, THREADS_HIGH, geo.smem, s>>>(
        x, hist, (const __nv_bfloat16*)fir_a, (const __nv_bfloat16*)fir_b,
        (const uint4*)bank_a, z, t, hl, ntaps, up, down, k, gs, s_total,
        geo);
  } else {
    cudaFuncSetAttribute(fused_highest_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)geo.smem);
    fused_highest_kernel<<<grid, THREADS, geo.smem, s>>>(
        x, hist, (const float*)fir_a, (const float*)bank_a, z, t, hl, ntaps,
        up, down, k, gs, gstride, s_total, geo);
  }
  return (int)cudaGetLastError();
}

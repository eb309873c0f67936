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
// compute-bound (about 4 bytes of device memory per 2 kFLOP).  On the
// block below that is the CUDA cores' fp32 FMA rate at "highest"; at
// "high" the three bf16 passes belong to the tensor cores, where the bound
// is shared-memory loads of the operand fragments (fir_mma.cuh).
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
// Where the shape allows it (down a multiple of 16, the working set in
// shared memory: wg_geometry), neither mode runs the block above but a
// persistent, warp-specialised kernel with stage 1 on wgmma
// (fir_wgmma.cuh): "high" with both stages on wgmma
// (fused_high_wgmma_kernel, 2.2x as fast as the mma.sync block at the
// headline), "highest" with stage 1 in six exact bf16 passes and stage 2
// on fp32 FMA in register tiles (fused_highest_wgmma_kernel, 2.8x as fast
// as the block above at the channelizer's 1024 x 327 680).  The blocks above
// stay for the other shapes: a down that is no multiple of 16, long
// filters (over 1089 taps at "highest", 1665 at "high", at 147/160).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_mma.cuh"
#include "fir_tile.cuh"
#include "fir_wgmma.cuh"

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

// ---- "high" on wgmma: persistent, warp-specialised -------------------------
// Where its working set fits (wg_geometry), "high" runs here: one block an
// SM for the whole launch, two consumer warpgroups and a producer
// warpgroup of which one warp works (setmaxnreg gives the consumers 232
// registers a thread and leaves the producer 40).
//   * a unit is one run of gs output groups of one channel, and its y
//     window is FIR_WG_LY = 8192 outputs from a multiple of 64 of the
//     stream index (fir_wgmma.cuh's sum order); block i takes units i,
//     i + grid, ..., its consumer warpgroups taking every other one;
//   * the block stages the tap tables (hi, lo) and the chunks of stage 2's
//     bank that its n-tiles visit once;
//   * the producer warp fetches each unit's x window in f32, ahead, into a
//     ring of two stages (half a window each) with bulk copies
//     (cp.async.bulk, an mbarrier per stage and consumer for "full", one
//     per stage for "empty"); history below index 0 comes from hist, zeros
//     outside both are stored by the warp;
//   * a consumer splits the window into its bf16 planes, releases the
//     stages, runs the product on wgmma (fir_wg_product), stores y in bf16
//     hi / lo over its planes and runs stage 2 (wg_resample) from there;
//     the two consumers take turns at the products, so that one's products
//     run while the other splits, stores and runs stage 2.
// Stage 2 is resample_stage_mma's dense slab product, z^T = R * slab^T, on
// wgmma too: A, 64 phases by 16 taus, in registers from the resident bank
// (two neighbouring n-tiles' B fragments are one A fragment); B, the slab's
// 16 taus by 64 groups, through a descriptor from y, which is kept in
// down / 8 planes of 8-sample rows so that rows down apart are rows of one
// core matrix (down a multiple of 16).  On mma.sync it took a third of the
// kernel's time.
constexpr int WG_CONSUMERS = 2;
constexpr int WG_THREADS = (WG_CONSUMERS + 1) * 128;
constexpr int WG_GB = 64;  // stage 2: groups a product (wgmma N)
constexpr int WG_KB = 3;   //          chunks a wait
constexpr int WG_PIECES = 4;  // "highest": pieces of a unit's x window
constexpr int WG_GT = 4;      //            stage 2: groups of a tile

// Chunks (16 taus) of the dense bank that n-tile nt (phases 8 nt .. 8 nt +
// 7) reaches: row p of R is zero outside tau = (p*down)/up + [0, k).
__host__ __device__ __forceinline__ int wg_ks_lo(int nt, int up, int down) {
  return (8 * nt * down / up) / 16;
}
__host__ __device__ __forceinline__ int wg_ks_hi(int nt, int up, int down,
                                                 int k) {
  const int p = 8 * nt + 7 < up - 1 ? 8 * nt + 7 : up - 1;
  return (p * down / up + k - 1) / 16;
}

// Mirrored by _wgmma_smem_bytes in kernels/fused_fir_resample.py:
//   gs  = (8192 - 63 - (k-1)) / down  groups a unit (at least 1; down a
//         multiple of 16)
//   kt  = ntaps + 63 rounded up to 16; nd = kt/8 + 7
//   lx  = 8192 + kt - 64 rounded up to 64; las = lx/64, made odd
//   high:
//   nt  = up rounded up to 8, over 8; nv = the sum over n-tiles of the
//         chunks each reaches (wg_ks_hi - wg_ks_lo + 1)
//   np  = down / 8; k2 = down + k-1 rounded up to 16
//   la  = max(1029 / np, 64 * (gs rounded up to 64, over 64) - 1
//         + (8 + k2/8) / np) + 1, made odd
//   cw  = max(2 * 128 * las, 2 * 16 * np * la)   (x planes | y planes)
//   smem = 128 + 2 * 128 * nd + 4 * lx + (4 * nt rounded up to 16)
//          + 512 * nv + 2 * cw
//   (barriers, tap tables, the ring of two half windows, the bank's
//   offsets and chunks, then each consumer's x planes or y planes)
//   highest:
//   ks  = the largest over n-tiles of (q of its last phase - q of its
//         first) + k, q_p = p*down/up (the n-tile's band of taus)
//   cw  = max(3 * 128 * las, 4 * 8448)   (x planes | y in f32, padded)
//   smem = 128 + 3 * 128 * nd + 2 * lx + 4 * nt * (8 * ks + 4) + 2 * cw
//   (barriers, tap tables, the ring of two quarter windows, the banded
//   bank in f32, then each consumer's x planes or y)
struct WgGeometry {
  int kt, nd, lx, las, nks, ntiles, np, la;
  uint32_t inv;                          // ceil(2^32 / np)
  int taps, ring, offs, bank, cons, cw;  // byte offsets, a consumer's bytes
  size_t smem;
  int ks;                                // "highest": taus of a band
};

WgGeometry wg_geometry(int ntaps, int up, int down, int k, int gs,
                       int highest) {
  WgGeometry g;
  g.kt = fir_wg_kt(ntaps);
  g.nd = fir_wg_cores(g.kt);
  g.lx = fir_wg_lx(g.kt);
  g.las = fir_wg_plane_rows(g.kt);
  g.nks = (down + k - 1 + 15) / 16;
  g.ntiles = (up + 7) / 8;
  g.np = down / 8;
  g.inv = (uint32_t)(0xFFFFFFFFu / (uint32_t)g.np) + 1u;
  const int ydata = 1029 / g.np;  // y and its zeroed tail: 8240 samples
  const int reach = WG_GB * ((gs + WG_GB - 1) / WG_GB) - 1 +
                    (8 + 2 * g.nks) / g.np;
  g.la = ((ydata > reach ? ydata : reach) + 1) | 1;
  int nv = 0;
  for (int nt = 0; nt < g.ntiles; ++nt)
    nv += wg_ks_hi(nt, up, down, k) - wg_ks_lo(nt, up, down) + 1;
  g.taps = 128;
  g.ks = 0;
  for (int nt = 0; nt < g.ntiles; ++nt) {
    const int last = 8 * nt + 7 < up - 1 ? 8 * nt + 7 : up - 1;
    const int span = last * down / up - 8 * nt * down / up + k;
    g.ks = span > g.ks ? span : g.ks;
  }
  if (highest) {
    const int xp = 3 * 128 * g.las, yp = 4 * fir_wg_ypos(FIR_WG_LY);
    g.cw = xp > yp ? xp : yp;
    g.ring = g.taps + 3 * 128 * g.nd;
    g.offs = g.bank = g.ring + 4 * (g.lx / WG_PIECES) * 2;
    g.cons = g.bank + 4 * g.ntiles * (8 * g.ks + 4);
  } else {
    const int xp = 2 * 128 * g.las, yp = 2 * 16 * g.np * g.la;
    g.cw = xp > yp ? xp : yp;
    g.ring = g.taps + 2 * 128 * g.nd;
    g.offs = g.ring + 4 * g.lx;
    g.bank = g.offs + (4 * g.ntiles + 15) / 16 * 16;
    g.cons = g.bank + 512 * nv;
  }
  g.smem = (size_t)g.cons + (size_t)WG_CONSUMERS * g.cw;
  return g;
}

// Origin of a unit's y window: s0*down - (k-1) rounded down to a multiple
// of 64.
__device__ __forceinline__ int wg_window_origin(int s0, int down, int k,
                                                int* a) {
  const int first = s0 * down - (k - 1);
  *a = ((first % FIR_WG_PH) + FIR_WG_PH) % FIR_WG_PH;
  return first - *a;
}

// Stream samples [s, s + n) of one row into dst: bulk copies of what lies in
// hist (from -hl) and in x (below t), zeros elsewhere, then the warp's 32
// arrivals on full, the first with the copies' bytes.  bulk == 0 (an
// unaligned x or hist) loads every sample with the warp instead.
__device__ __forceinline__ void wg_fill(float* dst, uint64_t* full,
                                        const float* __restrict__ xr,
                                        const float* __restrict__ hr, int s,
                                        int n, int t, int hl, int bulk,
                                        int lane) {
  const int e = s + n;
  const int h0 = max(s, -hl), h1 = min(e, 0);
  const int x0 = max(s, 0), x1 = min(e, t);
  uint32_t bytes = 0;
  if (bulk) {
    for (int i = s + lane; i < min(e, -hl); i += 32) dst[i - s] = 0.f;
    for (int i = max(s, t) + lane; i < e; i += 32) dst[i - s] = 0.f;
    if (h1 > h0) bytes += 4u * (h1 - h0);
    if (x1 > x0) bytes += 4u * (x1 - x0);
  } else {
    for (int i = lane; i < n; i += 32)
      dst[i] = stream_sample(xr, hr, s + i, t, hl);
  }
  fir_wg_fence_async();
  __syncwarp();
  if (lane != 0) {
    fir_wg_bar_arrive(full);
  } else if (bytes == 0) {
    fir_wg_bar_arrive(full);
  } else {
    fir_wg_bar_arrive_tx(full, bytes);
    if (h1 > h0)
      fir_wg_bulk_load(dst + (h0 - s), hr + hl + h0, 4u * (h1 - h0), full);
    if (x1 > x0)
      fir_wg_bulk_load(dst + (x0 - s), xr + x0, 4u * (x1 - x0), full);
  }
}

// Stage 2 of a unit by one consumer warpgroup: z[g][p] = sum_tau y_loc[a +
// g*down + tau] * R[p][tau] for its ng groups, y_loc[i] in the planes at
// fir_wg_yplane(i + ys - a), ys = a plus the store's shift, a multiple of
// 16.  For each 64 groups and 64 phases: the chunks that the 64 phases
// reach, three products each into one accumulator (r_hi * y_hi, r_hi *
// y_lo, r_lo * y_hi: the sum order of resample_stage_mma), warp w's A
// fragment, phases 16w .. 16w + 15, from n-tiles 2w and 2w + 1 of the
// bank, zero where an n-tile does not reach the chunk.  B's columns past
// ng read whatever the planes hold; their outputs are not stored.  As
// for fir_wg_product, y is written and fenced (fir_wg_fence_async) and the
// warpgroup has synchronised before the call.
__device__ __forceinline__ void wg_resample(
    const __nv_bfloat16* yh, const __nv_bfloat16* yl, const uint4* sbank,
    const int* soff, float* __restrict__ zr, int ys, int ng, int up,
    int down, int k, int np, int la, int wtid) {
  const int lane = wtid & 31, warp = wtid >> 5;
  const int ntiles = (up + 7) / 8;
  const uint32_t y_hi = fir_wg_smem(yh), y_lo = fir_wg_smem(yl);
  const uint32_t lbo = (uint32_t)la * 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int gb = 0; gb < ng; gb += WG_GB) {
    for (int pt = 0; 64 * pt < up; ++pt) {
      const int klo = wg_ks_lo(8 * pt, up, down);
      const int khi = wg_ks_hi(min(8 * pt + 7, ntiles - 1), up, down, k);
      const int n0 = 8 * pt + 2 * warp, n1 = n0 + 1;
      int lo0 = 1, hi0 = 0, base0 = 0, lo1 = 1, hi1 = 0, base1 = 0;
      if (n0 < ntiles) {
        lo0 = wg_ks_lo(n0, up, down);
        hi0 = wg_ks_hi(n0, up, down, k);
        base0 = soff[n0] - lo0;
      }
      if (n1 < ntiles) {
        lo1 = wg_ks_lo(n1, up, down);
        hi1 = wg_ks_hi(n1, up, down, k);
        base1 = soff[n1] - lo1;
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      // core matrix (groups 8gj.., taus 8kj..) at plane q % np, row q / np +
      // gb + 8gj, q = ys/8 + kj: the next kj is the next plane (q even, np
      // even), the next 8 groups 8 rows on; (plane, row) of chunk ks steps
      // by two planes a chunk
      int plane = (ys / 8 + 2 * klo) % np, row = (ys / 8 + 2 * klo) / np;
      // WG_KB chunks a wait, each with A registers of its own (the A
      // registers are read while the products run); a chunk past khi
      // multiplies zeros by chunk khi's y, so nothing branches around a
      // product
      for (int k0 = klo; k0 <= khi; k0 += WG_KB) {
        uint32_t rh[WG_KB][4], rl[WG_KB][4];
        uint64_t dh[WG_KB], dl[WG_KB];
#pragma unroll
        for (int b = 0; b < WG_KB; ++b) {
          const int ks = k0 + b;
          const uint4 f0 =
              ks >= lo0 && ks <= hi0 ? sbank[(base0 + ks) * 32 + lane] : zero;
          const uint4 f1 =
              ks >= lo1 && ks <= hi1 ? sbank[(base1 + ks) * 32 + lane] : zero;
          rh[b][0] = f0.x, rh[b][1] = f1.x, rh[b][2] = f0.y, rh[b][3] = f1.y;
          rl[b][0] = f0.z, rl[b][1] = f1.z, rl[b][2] = f0.w, rl[b][3] = f1.w;
          const uint32_t boff = (uint32_t)((plane * la + row + gb) * 16);
          dh[b] = fir_wg_desc(y_hi + boff, lbo, 128);
          dl[b] = fir_wg_desc(y_lo + boff, lbo, 128);
          if (ks < khi) {
            plane += 2;
            if (plane >= np) plane -= np, ++row;
          }
        }
        fir_wg_fence();
#pragma unroll
        for (int b = 0; b < WG_KB; ++b) {
          fir_wg_mma_rs(acc, rh[b], dh[b], k0 + b > klo);  // r_hi * y_hi
          fir_wg_mma_rs(acc, rh[b], dl[b], 1);             // r_hi * y_lo
          fir_wg_mma_rs(acc, rl[b], dh[b], 1);             // r_lo * y_hi
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      // acc[4i + 2h + e]: phase 64pt + 16w + l/4 + 8h, group gb + 8i +
      // 2 (l%4) + e
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int p = 64 * pt + 16 * warp + (lane >> 2) + 8 * ((j >> 1) & 1);
        const int g = gb + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        if (p < up && g < ng) zr[(size_t)g * up + p] = acc[j];
      }
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
fused_high_wgmma_kernel(const float* __restrict__ x,
                        const float* __restrict__ hist,
                        const uint4* __restrict__ taps_tab,
                        const uint4* __restrict__ bank,
                        float* __restrict__ z, int t, int hl, int up,
                        int down, int k, int gs, int s_total, int nruns,
                        int units, int bulk, WgGeometry geo) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [consumer][stage]
  uint64_t* empty = full + 2 * WG_CONSUMERS;            // [stage]
  __nv_bfloat16* ah = reinterpret_cast<__nv_bfloat16*>(smem + geo.taps);
  __nv_bfloat16* al = ah + FIR_WG_CORE * geo.nd;
  float* ring = reinterpret_cast<float*>(smem + geo.ring);
  int* soff = reinterpret_cast<int*>(smem + geo.offs);
  uint4* sbank = reinterpret_cast<uint4*>(smem + geo.bank);
  const int half = geo.lx / 2;
  const int tid = threadIdx.x;

  {
    const int nw = 2 * geo.nd * FIR_WG_CORE / 8;  // uint4 words
    uint4* dst = reinterpret_cast<uint4*>(ah);
    for (int i = tid; i < nw; i += WG_THREADS) dst[i] = taps_tab[i];
    int off = 0;  // the chunks each n-tile reaches, in order
    for (int nt = 0; nt < geo.ntiles; ++nt) {
      const int lo = wg_ks_lo(nt, up, down);
      const int n = wg_ks_hi(nt, up, down, k) - lo + 1;
      if (tid == 0) soff[nt] = off;
      const uint4* src = bank + ((size_t)nt * geo.nks + lo) * 32;
      for (int i = tid; i < n * 32; i += WG_THREADS)
        sbank[off * 32 + i] = src[i];
      off += n;
    }
  }
  if (tid == 0) {
    for (int i = 0; i < 2 * WG_CONSUMERS; ++i) fir_wg_bar_init(full + i, 32);
    for (int i = 0; i < 2; ++i) fir_wg_bar_init(empty + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fir_wg_fence_async();
  __syncthreads();

  const int c = tid >> 7;  // consumer warpgroup, or WG_CONSUMERS: producer
  if (c == WG_CONSUMERS) {
    // ---- producer: its first warp fetches every unit's window ahead -----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = tid & 31;
    int j = 0;
    for (int u = blockIdx.x; u < units && tid < 128 * WG_CONSUMERS + 32;
         u += gridDim.x, ++j) {
      const int b = u / nruns, s0 = (u - b * nruns) * gs;
      int a;
      const int m0 = wg_window_origin(s0, down, k, &a) - (geo.kt - FIR_WG_PH);
      for (int p = 0; p < 2; ++p) {
        fir_wg_bar_wait(empty + p, (j & 1) ^ 1);
        wg_fill(ring + p * half, full + 2 * (j % WG_CONSUMERS) + p,
                x + (size_t)b * t, hist + (size_t)b * hl, m0 + p * half, half,
                t, hl, bulk, lane);
      }
    }
  } else {
    // ---- consumer c: units c, c + 2, ... of this block ------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wtid = tid & 127;
    __nv_bfloat16* ph =
        reinterpret_cast<__nv_bfloat16*>(smem + geo.cons + c * geo.cw);
    __nv_bfloat16* pl = ph + 8 * 8 * geo.las;
    __nv_bfloat16* yh = ph;  // y takes the planes' place after the product
    __nv_bfloat16* yl = yh + 8 * geo.np * geo.la;
    // the block's units are j = 0, 1, ...: consumer c takes j = c, c + 2,
    // ..., and the two take turns at the products in the order of j, so
    // that one's products run while the other splits, stores y and runs
    // stage 2 (both at once leave the tensor cores idle in each one's
    // waits)
    const int total = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
    int jc = 0;
    for (int u = blockIdx.x + c * gridDim.x; u < units;
         u += WG_CONSUMERS * gridDim.x, ++jc) {
      const int j = WG_CONSUMERS * jc + c;
      const int b = u / nruns, s0 = (u - b * nruns) * gs;
      int a;
      wg_window_origin(s0, down, k, &a);
      for (int p = 0; p < 2; ++p) {
        fir_wg_bar_wait(full + 2 * c + p, jc & 1);
        const float* st = ring + p * half;
        for (int g = wtid; g < half / 8; g += 128) {
          const float4 v0 = *reinterpret_cast<const float4*>(st + 8 * g);
          const float4 v1 = *reinterpret_cast<const float4*>(st + 8 * g + 4);
          const float v[8] = {v0.x, v0.y, v0.z, v0.w,
                              v1.x, v1.y, v1.z, v1.w};
          fir_wg_split8(v, ph, pl, p * half + 8 * g, geo.las);
        }
        fir_wg_sync(1 + c);  // the stage is read
        if (wtid == 0) fir_wg_bar_arrive(empty + p);
      }
      fir_wg_fence_async();
      fir_wg_sync(1 + c);

      float acc[64];
      if (j > 0) fir_wg_turn_wait(1 + WG_CONSUMERS + c);
      fir_wg_product(ah, al, ph, pl, geo.kt, geo.las, acc);
      if (j + 1 < total) fir_wg_turn_give(1 + WG_CONSUMERS + (1 - c));
      fir_wg_sync(1 + c);  // every product has read the planes
      // y_loc[i] at plane position i + ys: the slab's rows then start at
      // multiples of 16
      const int ys = (16 - a % 16) % 16;
      fir_wg_store_y(acc, yh, yl, ys, geo.np, geo.la, geo.inv, wtid);
      fir_wg_fence_async();  // stage 2's wgmma reads y through descriptors
      fir_wg_sync(1 + c);

      const int ng = min(gs, s_total - s0);
      float* zr = z + (size_t)b * s_total * up + (size_t)s0 * up;
      wg_resample(yh, yl, sbank, soff, zr, a + ys, ng, up, down, k, geo.np,
                  geo.la, wtid);
      fir_wg_sync(1 + c);  // y is read before the next unit's planes
    }
  }
}

// ---- "highest" on wgmma ---------------------------------------------------

// The dense bank R restricted to each n-tile's band, in f32: for n-tile b
// (phases 8b .. 8b + 7) and t < ks, wb[b * (8 ks + 4) + 8 t + i] =
// R[8b + i][q_{8b} + t] = bank[j][8b + i], j = q_{8b+i} + k-1 - q_{8b} - t,
// zero where j is outside [0, k) or the phase past up (q_p = p*down/up);
// n-tiles 8 ks + 4 floats apart, so that the 16-byte loads of eight
// neighbouring n-tiles fall in distinct banks.
__device__ __forceinline__ void wg_band_bank(float* wb,
                                             const float* __restrict__ bank,
                                             int up, int down, int k,
                                             int ntiles, int ks, int tid,
                                             int nthr) {
  const int bs = 8 * ks + 4;
  for (int idx = tid; idx < ntiles * bs; idx += nthr) {
    const int b = idx / bs, r = idx - b * bs, p = 8 * b + r % 8;
    const int j = p * down / up + k - 1 - 8 * b * down / up - r / 8;
    wb[idx] = r < 8 * ks && p < up && j >= 0 && j < k ? bank[j * up + p]
                                                       : 0.f;
  }
}

// Stage 2 of a unit by one consumer warpgroup at "highest": z[g][p] =
// sum_tau y_loc[a + g*down + tau] * R[p][tau] for its ng groups, from y in
// f32 (yw) and the banded bank (wg_band_bank).  A thread takes tiles of
// one n-tile (8 phases) by WG_GT groups and walks the n-tile's band: for
// each tau, 8 weights (two 16-byte loads) and WG_GT samples of y for
// 8 * WG_GT multiply-adds, where resample_stage makes 20 from 9 loads.  A
// phase's sum is one running sum in order of tau over the band; its terms
// outside the phase's own K taps are y * 0, which leave the sum as it is,
// so the sum is that of its K taps in order of tau, a function of p alone.
// Groups of the last tile past ng read group ng - 1 and are not stored.
__device__ __forceinline__ void wg_resample_fp32(
    const float* yw, const float* wb, float* __restrict__ zr, int a, int ng,
    int up, int down, int k, int ks, int wtid) {
  const int ntiles = (up + 7) / 8, bs = 8 * ks + 4;
  const int ngt = (ng + WG_GT - 1) / WG_GT;
  for (int it = wtid; it < ntiles * ngt; it += 128) {
    const int gt = it / ntiles, b = it - gt * ntiles;
    const int last = 8 * b + 7 < up - 1 ? 8 * b + 7 : up - 1;
    const int q0 = 8 * b * down / up;
    const int span = last * down / up - q0 + k;
    int y[WG_GT];  // y_loc index of each group's tau 0
#pragma unroll
    for (int i = 0; i < WG_GT; ++i)
      y[i] = a + min(WG_GT * gt + i, ng - 1) * down + q0;
    const float* w = wb + b * bs;
    float acc[WG_GT][8];
#pragma unroll
    for (int i = 0; i < WG_GT; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    for (int t = 0; t < span; ++t) {
      const float4 w0 = *reinterpret_cast<const float4*>(w + 8 * t);
      const float4 w1 = *reinterpret_cast<const float4*>(w + 8 * t + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < WG_GT; ++i) {
        const float yv = yw[fir_wg_ypos(y[i] + t)];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(yv, wv[e], acc[i][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < WG_GT; ++i) {
      const int g = WG_GT * gt + i;
      if (g < ng)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * b + e < up) zr[(size_t)g * up + 8 * b + e] = acc[i][e];
    }
  }
}

// The same block, units, producer and turns as fused_high_wgmma_kernel, at
// fp32: the tap tables and a consumer's x planes have three bf16 parts
// (hi, mid, lo), stage 1 is six exact passes (fir_wg_product6), and y
// stays fp32 in the consumer's planes (padded: fir_wg_ypos) for stage 2 on
// fp32 FMA (wg_resample_fp32).  Three parts of y would not fit in shared
// memory beside three of x, and stage 2 is 6 % of the products: on the
// CUDA cores it runs while the other consumer's products hold the tensor
// cores.  A consumer's turn is its product and its own stage 2 in
// sequence, so stage 2 has to be short beside the product: its bank stays
// in shared memory for the block's life, banded (wg_band_bank), because
// what such a block leaves of L1 does not hold it and, read from L2, every
// multiply-add waited for it (B1 took 13.9 ms at 1024 x 327 680 so, 8.9 ms
// with the banded bank in shared memory and register tiles).  To make
// room, the producer's ring holds two quarter windows, not two halves: a
// unit's window comes in four pieces, stage (piece % 2).
__global__ void __launch_bounds__(WG_THREADS, 1)
fused_highest_wgmma_kernel(const float* __restrict__ x,
                           const float* __restrict__ hist,
                           const uint4* __restrict__ taps_tab,
                           const float* __restrict__ bank,
                           float* __restrict__ z, int t, int hl, int up,
                           int down, int k, int gs, int s_total, int nruns,
                           int units, int bulk, WgGeometry geo) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [consumer][stage]
  uint64_t* empty = full + 2 * WG_CONSUMERS;            // [stage]
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem + geo.taps);
  float* ring = reinterpret_cast<float*>(smem + geo.ring);
  float* wb = reinterpret_cast<float*>(smem + geo.bank);
  const int piece = geo.lx / WG_PIECES;
  const int tid = threadIdx.x;

  {
    const int nw = 3 * geo.nd * FIR_WG_CORE / 8;  // uint4 words
    uint4* dst = reinterpret_cast<uint4*>(tab);
    for (int i = tid; i < nw; i += WG_THREADS) dst[i] = taps_tab[i];
    wg_band_bank(wb, bank, up, down, k, geo.ntiles, geo.ks, tid, WG_THREADS);
  }
  if (tid == 0) {
    for (int i = 0; i < 2 * WG_CONSUMERS; ++i) fir_wg_bar_init(full + i, 32);
    for (int i = 0; i < 2; ++i) fir_wg_bar_init(empty + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fir_wg_fence_async();
  __syncthreads();

  const int c = tid >> 7;  // consumer warpgroup, or WG_CONSUMERS: producer
  if (c == WG_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = tid & 31;
    int j = 0;
    for (int u = blockIdx.x; u < units && tid < 128 * WG_CONSUMERS + 32;
         u += gridDim.x, ++j) {
      const int b = u / nruns, s0 = (u - b * nruns) * gs;
      int a;
      const int m0 = wg_window_origin(s0, down, k, &a) - (geo.kt - FIR_WG_PH);
      for (int q = 0; q < WG_PIECES; ++q) {
        // use n of stage q % 2 waits for the release of use n - 1
        const int n = j * (WG_PIECES / 2) + q / 2;
        fir_wg_bar_wait(empty + q % 2, (n & 1) ^ 1);
        wg_fill(ring + (q % 2) * piece, full + 2 * (j % WG_CONSUMERS) + q % 2,
                x + (size_t)b * t, hist + (size_t)b * hl, m0 + q * piece,
                piece, t, hl, bulk, lane);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wtid = tid & 127;
    __nv_bfloat16* px =
        reinterpret_cast<__nv_bfloat16*>(smem + geo.cons + c * geo.cw);
    float* yw = reinterpret_cast<float*>(px);  // after the product
    const int total = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
    int jc = 0;
    for (int u = blockIdx.x + c * gridDim.x; u < units;
         u += WG_CONSUMERS * gridDim.x, ++jc) {
      const int j = WG_CONSUMERS * jc + c;
      const int b = u / nruns, s0 = (u - b * nruns) * gs;
      int a;
      wg_window_origin(s0, down, k, &a);
      for (int q = 0; q < WG_PIECES; ++q) {
        // this consumer's use 2 jc + q / 2 of its full barrier of stage q % 2
        fir_wg_bar_wait(full + 2 * c + q % 2, (q / 2) & 1);
        const float* st = ring + (q % 2) * piece;
        for (int g = wtid; g < piece / 8; g += 128) {
          const float4 v0 = *reinterpret_cast<const float4*>(st + 8 * g);
          const float4 v1 = *reinterpret_cast<const float4*>(st + 8 * g + 4);
          const float v[8] = {v0.x, v0.y, v0.z, v0.w,
                              v1.x, v1.y, v1.z, v1.w};
          fir_wg_split8x3(v, px, q * piece + 8 * g, geo.las);
        }
        fir_wg_sync(1 + c);  // the stage is read
        if (wtid == 0) fir_wg_bar_arrive(empty + q % 2);
      }
      fir_wg_fence_async();
      fir_wg_sync(1 + c);

      float acc[64];
      if (j > 0) fir_wg_turn_wait(1 + WG_CONSUMERS + c);
      fir_wg_product6(tab, geo.nd, px, geo.kt, geo.las, acc);
      if (j + 1 < total) fir_wg_turn_give(1 + WG_CONSUMERS + (1 - c));
      fir_wg_sync(1 + c);  // every product has read the planes
      fir_wg_store_y32(acc, yw, wtid);
      fir_wg_sync(1 + c);

      const int ng = min(gs, s_total - s0);
      float* zr = z + (size_t)b * s_total * up + (size_t)s0 * up;
      wg_resample_fp32(yw, wb, zr, a, ng, up, down, k, geo.ks, wtid);
      fir_wg_sync(1 + c);  // y is read before the next unit's planes
    }
  }
}

// A persistent grid of wgmma blocks for `units` units: as many blocks as
// the card holds at once, at most one a unit; 0 when none fits.
template <typename Kernel>
int wg_grid(Kernel kernel, size_t smem, long long units) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS,
                                                smem);
  return (int)(units < (long long)sms * per_sm ? units
                                                : (long long)sms * per_sm);
}

}  // namespace

// x: (batch, t) f32, t % down == 0.  hist: (batch, hl) f32, the carried
// stream history (hl = 2*block).  z: (batch, t/down*up) f32.
// high == 0: fir_a (ntaps,) and bank_a (k, up) are f32, bank[j][p] =
// R[p, (p*down)/up + k-1-j]; fir_b is unused.  high == 1:
// fir_a / fir_b are the bf16 hi / lo parts of the taps, and bank_a is the
// dense bank R, zero-padded to (up rounded up to 8, down + k-1 rounded up
// to 16), bf16 hi and lo in the order of the mma B fragments (see
// resample_stage_mma).  bank_b is null, or the taps' tables for wgmma
// (fir_wgmma.cuh: kt/8 + 7 core matrices a part, hi then lo at "high", hi,
// mid then lo at "highest"), which run fused_high_wgmma_kernel or
// fused_highest_wgmma_kernel with gs groups a unit.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_fir_resample_launch(const float* x, const float* hist,
                                         const void* fir_a, const void* fir_b,
                                         const void* bank_a,
                                         const void* bank_b, float* z,
                                         int batch, int t, int hl, int ntaps,
                                         int up, int down, int k, int gs,
                                         int high, void* stream) {
  if (batch <= 0 || t <= 0) return (int)cudaSuccess;
  const int s_total = t / down;
  cudaStream_t s = (cudaStream_t)stream;
  if (bank_b != nullptr) {
    const WgGeometry wg = wg_geometry(ntaps, up, down, k, gs, !high);
    if (wg.smem > SMEM_MAX || gs < 1 || down % 16 != 0 ||
        gs * down + k - 1 + FIR_WG_PH - 1 > FIR_WG_LY)
      return (int)cudaErrorInvalidValue;
    const int nruns = (s_total + gs - 1) / gs;
    const long long units = (long long)batch * nruns;
    if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int grid = high ? wg_grid(fused_high_wgmma_kernel, wg.smem, units)
                          : wg_grid(fused_highest_wgmma_kernel, wg.smem,
                                    units);
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    const int bulk = ((uintptr_t)x % 16 == 0) && ((uintptr_t)hist % 16 == 0);
    if (high)
      fused_high_wgmma_kernel<<<grid, WG_THREADS, wg.smem, s>>>(
          x, hist, (const uint4*)bank_b, (const uint4*)bank_a, z, t, hl, up,
          down, k, gs, s_total, nruns, (int)units, bulk, wg);
    else
      fused_highest_wgmma_kernel<<<grid, WG_THREADS, wg.smem, s>>>(
          x, hist, (const uint4*)bank_b, (const float*)bank_a, z, t, hl, up,
          down, k, gs, s_total, nruns, (int)units, bulk, wg);
    return (int)cudaGetLastError();
  }
  const Geometry geo = geometry(ntaps, down, k, gs, high);
  if (geo.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int gstride = down % 4 == 0 ? 1 : (down % 2 == 0 ? 2 : 4);
  const dim3 grid((s_total + gs - 1) / gs, batch);
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

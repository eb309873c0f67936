// Direct-form FIR on Hopper's warpgroup MMA (wgmma), in "high" precision
// (three bf16 passes) and in "highest" (six): stage 1 of kernel B1's wgmma
// paths (fused_fir_resample.cu, where down is a multiple of 16 and the
// working set fits in shared memory), and the pieces the "high" path's
// stage 2 shares (the y planes, wgmma with A in registers, mbarriers and
// bulk copies).  Kernels B2 and B4, and B1 on other shapes, run the
// mma.sync tile of fir_mma.cuh ("high") or fir_tile.cuh ("highest").
//
// The product.  A warpgroup computes a unit of FIR_WG_LY = 64 x 128 outputs
// as one m64n128 product over kt rows,
//
//   Y[n'][m] = y[64m + 63 - n'] = sum_k A[n'][k] * B[k][m],    k < kt,
//
//   A[n'][k] = h[kt - 1 - n' - k]   (0 outside the taps) the taps'
//                                   Toeplitz, its 64 phases in reverse;
//   B[k][m]  = xw[64m + k]          an overlapping view of the x window,
//                                   xw[q] the sample at y's index
//                                   q - (kt - 64);
//   kt       = ntaps + 63 rounded up to 16 (fir_wg_kt).
//
// Both operands come from shared memory through wgmma's descriptors in the
// layout without swizzle, whose unit is a "core matrix" of 8 rows of 16
// bytes (8 bf16), 128 contiguous bytes; a descriptor gives the byte offset
// from one core matrix to the next along K (LBO) and along M or N (SBO).
//
//   * A's core matrix (n' / 8, k / 8) depends on n'/8 + k/8 alone, because
//     the phases run in reverse: a table of kt/8 + 7 core matrices,
//     D[d][r][c] = h[kt - 1 - 8d - r - c], read with LBO = SBO = 128 bytes,
//     holds all of A (hi and lo: 36.6 KB at 1024 taps, where the (kt, 64)
//     tile would take 278 KB; hi, mid and lo at "highest": 54.9 KB).  The
//     host prepares it
//     (kernels/fused_fir_resample.py, wgmma_tap_tables) and a block keeps
//     it for its whole life.
//   * B's rows are 64 samples apart, so the window is kept in 8 "planes":
//     xw[64a + 8b + c] at element (b * las + a) * 8 + c.  Core matrix
//     (m / 8, k / 8) then starts at plane k/8 % 8, row 8 (m/8) + k/64; its
//     rows are 16 bytes apart, SBO = 128 bytes and, inside one 16-deep
//     chunk, LBO = las * 16 bytes.  las, the rows of a plane, is odd, so
//     the 16-byte stores of the split fall in distinct bank groups.
//
// Precision and sum order are those of fir_mma.cuh: x and h are split into
// bf16 hi and lo, every 16-deep chunk adds x_hi*w_hi, then x_lo*w_hi, then
// x_hi*w_lo (each product exact in fp32), and two chunks (32 taps) are
// summed in a fresh accumulator that is then added to the total in fp32.
// An output's sum depends on its tap index and on its index mod 64 (its
// phase n = 63 - n'): two windows that start at a multiple of 64 of the
// ABSOLUTE stream index give the same bits for the same output.
//
// "highest" keeps fp32: x and h are split into three bf16 parts, hi, mid
// and lo, each the previous remainder with its low 16 bits cleared
// (fir_wg_split3), so that hi + mid + lo is the fp32 value exactly
// (rounding hi to nearest would overflow near the largest float).  Each
// product of two parts is exact in fp32.  Every 16-deep chunk takes six
// of them, and a partial sum of FIR_WG_PART6 = 4 chunks (64 taps) takes
// them pass by pass, the smallest first, each pass over every chunk:
// x_lo*w_hi, x_hi*w_lo, x_mid*w_mid, x_mid*w_hi, x_hi*w_mid, then
// x_hi*w_hi, into a fresh accumulator that is then added to the total in
// fp32, as at "high".  The terms left out (mid*lo, lo*mid, lo*lo) are
// below 2^-22 of the product.  The small passes sum while the accumulator
// is small, so its roundings at the product's scale are those of the
// x_hi*w_hi passes.  An output's bits depend on its tap index and its
// index mod 64, as at "high".  The product is twice "high"'s: six
// m64n128k16 products a chunk, 384 clocks of an SM's tensor cores, 2.5x
// the fp32 FMA rate.  A partial sum of four chunks (24 products) leaves
// the tensor cores idle in half the waits of one of two (kernel B1 at
// 1024 x 327 680 on an H100: two chunks 8.4 ms and 133.8 dB against the
// float64 plain version, four 8.0 ms and 133.6 dB).
//
// What bounds it: the tensor cores.  One chunk is three m64n128k16
// products (393 216 multiply-adds, 192 clocks of an SM's tensor cores)
// that read 2 KB of A and 4 KB of B each from shared memory, 96 bytes a
// clock of the SM's 128; at N = 8 (mma.sync) the same products read about
// three times that.  The zero corner of A is (kt - ntaps) / kt, 5.9 % at
// 1024 taps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int FIR_WG_PH = 64;                       // phases (wgmma M)
constexpr int FIR_WG_ROWS = 128;                    // rows of 64 (wgmma N)
constexpr int FIR_WG_LY = FIR_WG_PH * FIR_WG_ROWS;  // outputs of a unit
constexpr int FIR_WG_PART = 2;                      // chunks a partial sum
constexpr int FIR_WG_PART6 = 4;                     //   at "highest"
constexpr int FIR_WG_CORE = 64;                     // bf16 of a core matrix

// Rows of A and B: every tap of every phase, rounded up to whole chunks.
__host__ __device__ __forceinline__ int fir_wg_kt(int ntaps) {
  return (ntaps + FIR_WG_PH - 1 + 15) / 16 * 16;
}

// Core matrices of one part's tap table (hi, mid or lo).
__host__ __device__ __forceinline__ int fir_wg_cores(int kt) {
  return kt / 8 + 7;
}

// Samples of a unit's x window: the last row's last read is
// 64 * 127 + kt - 1, rounded up to whole 64-sample rows of the planes.
__host__ __device__ __forceinline__ int fir_wg_lx(int kt) {
  return (FIR_WG_LY + kt - FIR_WG_PH + 63) / 64 * 64;
}

// Rows of a plane: the window's 64-sample rows, made odd.
__host__ __device__ __forceinline__ int fir_wg_plane_rows(int kt) {
  return (fir_wg_lx(kt) / 64) | 1;
}

// Position of y sample p (counted from the window's origin plus its shift)
// in the planes that stage 2 reads: with q = p / 8, plane q % np (np =
// down / 8), row q / np, rows of 8 samples, planes la rows long.  inv is
// ceil(2^32 / np), so that q / np = umulhi(q, inv) for every q here.
__device__ __forceinline__ int fir_wg_yplane(int p, int np, int la,
                                             uint32_t inv) {
  const int q = p >> 3;
  const int row = (int)__umulhi((uint32_t)q, inv);
  return ((q - row * np) * la + row) * 8 + (p & 7);
}

__device__ __forceinline__ uint32_t fir_wg_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A wgmma descriptor of the layout without swizzle: start, LBO and SBO in
// bytes (multiples of 16), layout type 0.
__device__ __forceinline__ uint64_t fir_wg_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= A * B, m64n128k16, bf16 in, fp32 accumulators; scale_d == 0
// starts from zero.
__device__ __forceinline__ void fir_wg_mma(float d[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fir_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from touching d before the products that write it
// have completed.
__device__ __forceinline__ void fir_wg_hold(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma and bulk
// copies (the async proxy).
__device__ __forceinline__ void fir_wg_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void fir_wg_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   fir_wg_smem(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fir_wg_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   fir_wg_smem(bar))
               : "memory");
}

__device__ __forceinline__ void fir_wg_bar_arrive_tx(uint64_t* bar,
                                                     uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          fir_wg_smem(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool fir_wg_bar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(fir_wg_smem(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.  A wait of 2^35
// clocks (about 20 s) is a lost arrival: the kernel traps rather than hold
// the card.
__device__ __forceinline__ void fir_wg_bar_wait(uint64_t* bar, int parity) {
  if (fir_wg_bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!fir_wg_bar_try(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, reported to bar.
__device__ __forceinline__ void fir_wg_bulk_load(void* dst, const void* src,
                                                 uint32_t bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(fir_wg_smem(dst)),
      "l"(src), "r"(bytes), "r"(fir_wg_smem(bar))
      : "memory");
}

// Barrier of one warpgroup (named barrier id, 128 threads).
__device__ __forceinline__ void fir_wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d (+)= A * B, m64n64k16, A from registers (each warp its 16 rows, in
// mma.sync's m16n8k16 A order), B from shared memory, fp32 accumulators.
__device__ __forceinline__ void fir_wg_mma_rs(float d[32], const uint32_t a[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Two warpgroups' turns at the products: wait for this warpgroup's turn
// (bar.sync of 256 threads on barrier id), or give the other warpgroup its
// turn (bar.arrive on the other's barrier).
__device__ __forceinline__ void fir_wg_turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void fir_wg_turn_give(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// ---- the warpgroup's product -----------------------------------------------

// Eight window samples v (window index q, a multiple of 8) into the hi and
// lo planes (q = 64a + 8b + c at (b * las + a) * 8 + c).
__device__ __forceinline__ void fir_wg_split8(const float v[8],
                                              __nv_bfloat16* ph,
                                              __nv_bfloat16* pl, int q,
                                              int las) {
  __align__(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    hi[e] = __float2bfloat16_rn(v[e]);
    lo[e] = __float2bfloat16_rn(v[e] - __bfloat162float(hi[e]));
  }
  const int off = (((q >> 3) & 7) * las + (q >> 6)) * 8;
  *reinterpret_cast<uint4*>(ph + off) = *reinterpret_cast<const uint4*>(hi);
  *reinterpret_cast<uint4*>(pl + off) = *reinterpret_cast<const uint4*>(lo);
}

// d = the 64 x 128 product of chunks [c0, c0 + FIR_WG_PART) into a fresh
// accumulator, issued (not waited for).
__device__ __forceinline__ void fir_wg_part(float d[64], uint32_t a_hi,
                                            uint32_t a_lo, uint32_t b_hi,
                                            uint32_t b_lo, int las, int c0,
                                            int nch) {
  fir_wg_fence();
#pragma unroll
  for (int cc = 0; cc < FIR_WG_PART; ++cc) {
    const int ch = c0 + cc;
    if (ch < nch) {
      // A: core matrices D[2ch + ...]; B: plane (2ch) % 8, row 2ch / 8
      const uint32_t aoff = (uint32_t)ch * 2 * 128;
      const uint32_t boff =
          ((uint32_t)((2 * ch) & 7) * las + (uint32_t)(ch >> 2)) * 16;
      const uint64_t dah = fir_wg_desc(a_hi + aoff, 128, 128);
      const uint64_t dal = fir_wg_desc(a_lo + aoff, 128, 128);
      const uint64_t dbh = fir_wg_desc(b_hi + boff, las * 16, 128);
      const uint64_t dbl = fir_wg_desc(b_lo + boff, las * 16, 128);
      fir_wg_mma(d, dah, dbh, cc);  // x_hi * w_hi (fresh at cc = 0)
      fir_wg_mma(d, dah, dbl, 1);   // x_lo * w_hi
      fir_wg_mma(d, dal, dbh, 1);   // x_hi * w_lo
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc = Y of the unit whose planes are ph / pl, from the tap tables ah / al
// (kt / 16 chunks).  Every thread of the warpgroup calls it, after the
// planes are written and fenced (fir_wg_fence_async) and the warpgroup has
// synchronised.  Thread l of warp w (of the warpgroup) holds, in acc[j],
// row n' = 16w + l/4 + 8 ((j/2) % 2), column m = 8 (j/4) + 2 (l%4) + j%2.
// Each partial sum is waited for and added before the next is issued:
// with two partial sums alternating (one added while the next one's
// products run), ptxas serialises every wgmma of the kernel (C7514,
// C7520), which cost more than the waits.  The block's other consumer
// fills the tensor cores meanwhile.
__device__ __forceinline__ void fir_wg_product(
    const __nv_bfloat16* ah, const __nv_bfloat16* al,
    const __nv_bfloat16* ph, const __nv_bfloat16* pl, int kt, int las,
    float acc[64]) {
  const uint32_t a_hi = fir_wg_smem(ah), a_lo = fir_wg_smem(al);
  const uint32_t b_hi = fir_wg_smem(ph), b_lo = fir_wg_smem(pl);
  const int nch = kt / 16;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int c0 = 0; c0 < nch; c0 += FIR_WG_PART) {
    fir_wg_part(part, a_hi, a_lo, b_hi, b_lo, las, c0, nch);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fir_wg_hold(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

// ---- "highest": six passes -------------------------------------------------

// v = hi + mid + lo exactly: hi is v with its low 16 bits cleared, mid the
// same of the remainder, lo what is left (at most 8 significant bits, so
// its low 16 bits are clear as well); each part's bits as an fp32 word,
// whose top half is the part in bf16.
__device__ __forceinline__ void fir_wg_split3(float v, uint32_t& hi,
                                              uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFF0000u;
  const float r = v - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// Eight window samples v (window index q, a multiple of 8) into the hi, mid
// and lo planes, at (b * las + a) * 8 + c for q = 64a + 8b + c, one part's
// planes 64 * las elements after the previous part's.
__device__ __forceinline__ void fir_wg_split8x3(const float v[8],
                                                __nv_bfloat16* p, int q,
                                                int las) {
  uint32_t w[3][8];
#pragma unroll
  for (int e = 0; e < 8; ++e) fir_wg_split3(v[e], w[0][e], w[1][e], w[2][e]);
  const int off = (((q >> 3) & 7) * las + (q >> 6)) * 8;
#pragma unroll
  for (int i = 0; i < 3; ++i)  // the top halves of two words make a pair
    *reinterpret_cast<uint4*>(p + i * 64 * las + off) = make_uint4(
        __byte_perm(w[i][0], w[i][1], 0x7632),
        __byte_perm(w[i][2], w[i][3], 0x7632),
        __byte_perm(w[i][4], w[i][5], 0x7632),
        __byte_perm(w[i][6], w[i][7], 0x7632));
}

// d = chunks [c0, c0 + FIR_WG_PART6) in six passes into a fresh
// accumulator, issued (not waited for): pass by pass, the smallest first,
// each pass over every chunk of the part.  a / b: the hi tap table and the
// hi x planes, the mid and lo ones as / bs bytes after each other.
__device__ __forceinline__ void fir_wg_part6(float d[64], uint32_t a,
                                             uint32_t as, uint32_t b,
                                             uint32_t bs, int las, int c0,
                                             int nch) {
  // (x part, w part): lo*hi, hi*lo, mid*mid, mid*hi, hi*mid, hi*hi
  constexpr int XP[6] = {2, 0, 1, 1, 0, 0}, WP[6] = {0, 2, 1, 0, 1, 0};
  fir_wg_fence();
#pragma unroll
  for (int s = 0; s < 6; ++s) {
#pragma unroll
    for (int cc = 0; cc < FIR_WG_PART6; ++cc) {
      const int ch = c0 + cc;
      if (ch < nch) {
        const uint32_t aoff = (uint32_t)ch * 2 * 128 + WP[s] * as;
        const uint32_t boff =
            ((uint32_t)((2 * ch) & 7) * las + (uint32_t)(ch >> 2)) * 16 +
            XP[s] * bs;
        fir_wg_mma(d, fir_wg_desc(a + aoff, 128, 128),
                   fir_wg_desc(b + boff, las * 16, 128), s + cc > 0);
      }
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc = Y of the unit whose three parts' planes start at px, from the tap
// tables at tab (nd core matrices a part), as fir_wg_product does at
// "high": each partial sum waited for and added before the next is issued.
__device__ __forceinline__ void fir_wg_product6(const __nv_bfloat16* tab,
                                                int nd,
                                                const __nv_bfloat16* px,
                                                int kt, int las,
                                                float acc[64]) {
  const uint32_t a = fir_wg_smem(tab), b = fir_wg_smem(px);
  const uint32_t as = 2u * FIR_WG_CORE * nd, bs = 128u * las;
  const int nch = kt / 16;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int c0 = 0; c0 < nch; c0 += FIR_WG_PART6) {
    fir_wg_part6(part, a, as, b, bs, las, c0, nch);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fir_wg_hold(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

// Where y_loc[i] is kept in f32: one float of padding after every 32, so
// that samples a multiple of 32 apart (the groups of a stage-2 tile, the
// columns m of a warp's store) fall in distinct banks (without it, B1 at
// 1024 x 327 680 took 8.7 ms against 8.0).
__host__ __device__ __forceinline__ int fir_wg_ypos(int i) {
  return i + (i >> 5);
}

// The unit's 8192 outputs in fp32, y_loc[i] at yw[fir_wg_ypos(i)], i = 64m
// + 63 - n' (the accumulator's layout: fir_wg_product).
__device__ __forceinline__ void fir_wg_store_y32(const float acc[64],
                                                 float* yw, int wtid) {
  const int w = wtid >> 5, l = wtid & 31;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int np_ = 16 * w + (l >> 2) + 8 * ((j >> 1) & 1);
    const int m = 8 * (j >> 2) + 2 * (l & 3) + (j & 1);
    yw[fir_wg_ypos(FIR_WG_PH * m + FIR_WG_PH - 1 - np_)] = acc[j];
  }
}

// The unit's 8192 outputs, split into bf16 hi and lo, into the planes yh /
// yl: y_loc[i], i = 64m + 63 - n', at fir_wg_yplane(i + ys); the 32
// samples after the last are zeroed (stage 2's last chunk reads them, times
// zeros of the bank).
__device__ __forceinline__ void fir_wg_store_y(const float acc[64],
                                               __nv_bfloat16* yh,
                                               __nv_bfloat16* yl, int ys,
                                               int np, int la, uint32_t inv,
                                               int wtid) {
  const int w = wtid >> 5, l = wtid & 31;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int np_ = 16 * w + (l >> 2) + 8 * ((j >> 1) & 1);
    const int m = 8 * (j >> 2) + 2 * (l & 3) + (j & 1);
    const int i = fir_wg_yplane(FIR_WG_PH * m + FIR_WG_PH - 1 - np_ + ys, np,
                                la, inv);
    const __nv_bfloat16 h = __float2bfloat16_rn(acc[j]);
    yh[i] = h;
    yl[i] = __float2bfloat16_rn(acc[j] - __bfloat162float(h));
  }
  if (wtid < 32) {
    const int i = fir_wg_yplane(FIR_WG_LY + ys + wtid, np, la, inv);
    yh[i] = yl[i] = __float2bfloat16_rn(0.f);
  }
}

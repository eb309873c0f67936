// Kernel wola_gain: config 4's whole frame map, SpectralGainStage's
// `reference` engine on a static per-bin gain, in one launch on an H100
// (sm_90a): frames, window, a real n_fft-point FFT, the gain, the inverse,
// the synthesis window, overlap-add, the envelope and the state's tails.
//
// Replaces no TPU kernel.  The JAX package runs config 4 on lax / XLA FFTs
// and einsums (no pallas_call); this kernel was added for config 4, whose
// composite path on the card is some 30 elementwise launches and two cuFFT
// calls that hand ~0.4 GB intermediates to each other through device
// memory.  Here every intermediate stays on the chip: a frame's samples,
// spectrum and synthesis live in registers and shared memory, and a step
// reads each input sample and writes each output sample about once.
//
// What bounds it: operations before bytes.  At 256 x 95 744 a step holds
// two real 2048-point FFTs a frame at fp32 (86.3 us at 67 TFLOP/s) against
// 196 MB of samples in and out (58.5 us at 3.35 TB/s).  The design spends
// its instructions on the butterflies: a warp runs one frame with every
// value of a pass in its lanes' registers, the exchanges between passes go
// through shared memory padded against bank conflicts, and the twiddles of
// the in-register DFTs are kernel parameters (constant bank operands).
//
// The arithmetic is kernels/wola_gain.py's docstring, and
// wola_gain_plain is this kernel in plain PyTorch: every product and sum
// is __fmul_rn / __fadd_rn / __fsub_rn (never contracted into an FMA) in
// the same order, so the two agree bit for bit.  No atomics: the
// overlap-add sums each output in one fixed order (frame j's chunk 0
// first, as ops/spectral.overlap_add), so a launch's outputs are the same
// from run to run and do not depend on how the frames are cut into runs.
//
// Work split: a CTA of W warps (W <= 4) owns a run of consecutive frames
// [f0, f1) of one row and emits the hop-blocks [f0, f1) of the output
// (and, on a row's last run, the tails).  It computes again the ratio - 1
// frames before f0 that reach into its hop-blocks, so CTAs share nothing.
// It walks its frames in waves of W, a warp a frame:
//   1. the next wave's new hop-blocks of the input (x_hist for the first
//      ov positions, then x) are copied by cp.async into a ring of
//      2 W + ratio - 1 hop-blocks in shared memory while this wave
//      computes: each input sample is read from device memory once a run,
//      and no thread waits for device memory;
//   2. each warp windows its frame from the ring, runs the forward FFT,
//      the split step and gain, the inverse FFT, and writes the frame's
//      synthesis (times the synthesis window with 1/N and the start mask)
//      into its slot of a ring of W + ratio - 1 frames;
//   3. a warp a hop-block sums the wave's hop-blocks from the last ratio
//      frames of the ring, adds the carried ola and env where they apply,
//      divides by the clamped envelope and stores y (or the new ola / env
//      tails); in a stream's interior the envelope is the same for every
//      hop-block (envc, computed once) and a lane takes 4 positions.
// Two barriers a wave.  pos is read on the card; the new state goes into
// fresh tensors.  A row in one run (two CTAs fit an SM at config 4's
// widths) computes no frame twice: 0.46 ms at 256 x 95 744 on an H100,
// 0.51 ms in runs of 47 frames.
//
// The FFT (M = n_fft / 2 complex points of the even/odd packing, Plan):
// Stockham passes of radix R <= min(32, M / 32), each lane running
// M / (32 R) whole butterflies j = lane + 32 b; pass p reads v[r] =
// a[j + r M / R], multiplies v[r] (r >= 1) by W_{R NS}^{r (j mod NS)} from
// its table where NS > 1, runs the R-point DFT in registers (radix-2
// Stockham steps, dft) and writes v[r] to (j / NS) NS R + r NS + j mod NS.
//
// Tables (kernels/wola_gain.py wola_tables, float32, rounded once from
// float64): [pass twiddles, tw_len float2 | split twiddles e^{-2 pi i k /
// N}, k <= M, float2 | window, n_fft floats | gain / 2, M + 1 floats];
// W_32^m, m < 16, by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 4;
constexpr size_t SMEM_MAX = 232448;  // 227 KB per block on sm_90

struct W32 {
  float2 w[16];  // W_32^m = e^{-2 pi i m / 32}
};

template <int A, int...>
struct First {
  static constexpr int value = A;
};

// The radices of the M-point FFT (kernels/wola_gain.py fft_plan).
template <int M>
struct Plan;
template <>
struct Plan<128> {
  static constexpr int first = 4, last = 2, tw_len = 3 * 4 + 3 * 16 + 1 * 64;
};
template <>
struct Plan<256> {
  static constexpr int first = 8, last = 4, tw_len = 7 * 8 + 3 * 64;
};
template <>
struct Plan<512> {
  static constexpr int first = 16, last = 2, tw_len = 15 * 16 + 1 * 256;
};
template <>
struct Plan<1024> {
  static constexpr int first = 32, last = 32, tw_len = 31 * 32;
};
template <>
struct Plan<2048> {
  static constexpr int first = 32, last = 2, tw_len = 31 * 32 + 1 * 1024;
};

__device__ __forceinline__ int pad(int a) { return a + (a >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

// The R-point DFT of v in registers, natural order in and out: radix-2
// Stockham steps; W_{2 ns}^{j mod ns} = W_R^m, m = (j mod ns) R / (2 ns):
// none at m = 0, -i (+i inverse) exactly at 4 m = R, else W_32^{m 32 / R}
// (conjugated inverse).
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R], const W32& t) {
#pragma unroll
  for (int ns = 1; ns < R; ns *= 2) {
    float2 u[R];
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const float2 a = v[j];
      float2 b = v[j + R / 2];
      const int m = (j % ns) * (R / (2 * ns));
      if (m != 0) {
        if (4 * m == R) {
          b = INV ? make_float2(-b.y, b.x) : make_float2(b.y, -b.x);
        } else {
          float2 w = t.w[m * (32 / R)];
          if (INV) w.y = -w.y;
          b = cmul(b, w);
        }
      }
      const int d = (j / ns) * 2 * ns + (j % ns);
      u[d] = make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
      u[d + ns] = make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
    }
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = u[j];
  }
}

// Loads a radix-R pass's inputs from the warp's scratch: butterfly b's
// v[b R + r] = a[lane + 32 b + r M / R].
template <int M, int R>
__device__ __forceinline__ void load_pass(float2 (&v)[M / 32],
                                          const float2* s, int lane) {
#pragma unroll
  for (int b = 0; b < M / (32 * R); ++b)
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[b * R + r] = s[pad(lane + 32 * b + r * (M / R))];
}

template <int M, int R, int NS>
__device__ __forceinline__ void store_pass(const float2 (&v)[M / 32],
                                           float2* s, int lane) {
#pragma unroll
  for (int b = 0; b < M / (32 * R); ++b) {
    const int j = lane + 32 * b;
    const int d = (j / NS) * NS * R + (j % NS);
#pragma unroll
    for (int r = 0; r < R; ++r) s[pad(d + r * NS)] = v[b * R + r];
  }
}

template <int M, int R, int NS, bool INV>
__device__ __forceinline__ void compute_pass(float2 (&v)[M / 32],
                                             const float2* tw, const W32& t,
                                             int lane) {
#pragma unroll
  for (int b = 0; b < M / (32 * R); ++b) {
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[b * R + r];
    if (NS > 1) {
      const int jm = (lane + 32 * b) & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) {
        float2 w = tw[(r - 1) * NS + jm];
        if (INV) w.y = -w.y;
        u[r] = cmul(u[r], w);
      }
    }
    dft<R, INV>(u, t);
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = u[r];
  }
}

// The passes from span NS on: v holds the first one's inputs; on return v
// holds the last one's outputs, butterfly b's r-th at lane + 32 b + r NS_last
// (NS_last R_last = M).  Between passes the values go through s.
template <int M, bool INV, int NS, int R, int... RS>
__device__ __forceinline__ void passes(float2 (&v)[M / 32], float2* s,
                                       const float2* tw, const W32& t,
                                       int lane) {
  compute_pass<M, R, NS, INV>(v, tw, t, lane);
  if constexpr (sizeof...(RS) > 0) {
    store_pass<M, R, NS>(v, s, lane);
    __syncwarp();
    load_pass<M, First<RS...>::value>(v, s, lane);
    __syncwarp();
    passes<M, INV, NS * R, RS...>(v, s, tw + (NS > 1 ? (R - 1) * NS : 0), t,
                                  lane);
  }
}

template <int M, bool INV>
__device__ __forceinline__ void fft(float2 (&v)[M / 32], float2* s,
                                    const float2* tw, const W32& t, int lane) {
  if constexpr (M == 128) passes<M, INV, 1, 4, 4, 4, 2>(v, s, tw, t, lane);
  else if constexpr (M == 256) passes<M, INV, 1, 8, 8, 4>(v, s, tw, t, lane);
  else if constexpr (M == 512) passes<M, INV, 1, 16, 16, 2>(v, s, tw, t, lane);
  else if constexpr (M == 1024) passes<M, INV, 1, 32, 32>(v, s, tw, t, lane);
  else passes<M, INV, 1, 32, 32, 2>(v, s, tw, t, lane);
}

// The FFT's last pass leaves butterfly b's r-th output at k = lane + 32 b +
// r M / R_last: the index of v[b R_last + r].
template <int M>
__device__ __forceinline__ int out_index(int lane, int b, int r) {
  return lane + 32 * b + r * (M / Plan<M>::last);
}

// Z to the scratch in natural order, for the split step.
template <int M>
__device__ __forceinline__ void store_natural(const float2 (&v)[M / 32],
                                              float2* s, int lane) {
  constexpr int RL = Plan<M>::last;
#pragma unroll
  for (int b = 0; b < M / (32 * RL); ++b)
#pragma unroll
    for (int r = 0; r < RL; ++r) s[pad(out_index<M>(lane, b, r))] = v[b * RL + r];
}

// The frame's synthesis into its slot (natural order, unpadded): samples
// 2n and 2n + 1 are (w[n] (win / N)) mask.
template <int M>
__device__ __forceinline__ void store_synthesis(const float2 (&v)[M / 32],
                                                float2* s, const float2* win2,
                                                float inv_n, float msk,
                                                int lane) {
  constexpr int RL = Plan<M>::last;
#pragma unroll
  for (int b = 0; b < M / (32 * RL); ++b)
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const int n = out_index<M>(lane, b, r);
      const float2 wv = win2[n], x = v[b * RL + r];
      s[n] = make_float2(
          __fmul_rn(__fmul_rn(x.x, __fmul_rn(wv.x, inv_n)), msk),
          __fmul_rn(__fmul_rn(x.y, __fmul_rn(wv.y, inv_n)), msk));
    }
}

// X[k] from Z[k], Z[M - k] and t = e^{-2 pi i k / N}: A = Zk + conj Zp,
// B = Zk - conj Zp, C = B t, X = A - i C.
__device__ __forceinline__ float2 split_fwd(float2 zk, float2 zp, float2 t) {
  const float2 a = make_float2(__fadd_rn(zk.x, zp.x), __fsub_rn(zk.y, zp.y));
  const float2 b = make_float2(__fsub_rn(zk.x, zp.x), __fadd_rn(zk.y, zp.y));
  const float2 c = cmul(b, t);
  return make_float2(__fadd_rn(a.x, c.y), __fsub_rn(a.y, c.x));
}

// W[k] from Y[k], Y[M - k]: (Yk + conj Yp) + i (Yk - conj Yp) conj t.
__device__ __forceinline__ float2 split_inv(float2 yk, float2 yp, float2 t) {
  const float2 a = make_float2(__fadd_rn(yk.x, yp.x), __fsub_rn(yk.y, yp.y));
  const float2 b = make_float2(__fsub_rn(yk.x, yp.x), __fadd_rn(yk.y, yp.y));
  const float2 c = cmul(b, make_float2(t.x, -t.y));
  return make_float2(__fsub_rn(a.x, c.y), __fadd_rn(a.y, c.x));
}

__device__ __forceinline__ float2 scale(float g, float2 a) {
  return make_float2(__fmul_rn(g, a.x), __fmul_rn(g, a.y));
}

struct Args {
  const float* x;
  long long x_stride;  // floats between rows of x
  const float* xh;     // (rows, ov)
  const float* ola;    // (rows, ov)
  const float* env;    // (ov)
  const int* pos;
  const float* tab;
  float* y;  // (rows, t)
  float* xh_new;
  float* ola_new;
  float* env_new;
  int* pos_new;
  int rows, t, hop, hop_shift, ratio, nf, frames_per_run, runs;
  int vec4;  // x, x_hist and their rows 16-byte aligned
};

// Shared memory of a CTA of `warps` warps: S = warps + ratio - 1 frame
// slots, the tables, a ring of SI = 2 warps + ratio - 1 input hop-blocks
// (a wave's and the next one's, copied in while this one computes), the
// halved gain and the interior envelope (a hop).
inline size_t smem_bytes(int m, int tw_len, int hop, int ratio,
                         int warps) {
  const size_t slots = warps + ratio - 1, ring = 2 * warps + ratio - 1;
  return sizeof(float2) * (slots * (m + m / 32) + tw_len + (m + 1) + m) +
         sizeof(float) * (ring * hop + (m + 1) + hop);
}

// cp.async: a copy from device memory to shared memory that the thread
// does not wait for; commit closes a group, wait_prior<1> waits for every
// group but the last committed.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_prior1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int M>
__global__ void __launch_bounds__(32 * MAX_WARPS)
wola_gain_kernel(const Args a, const __grid_constant__ W32 t) {
  constexpr int N = 2 * M, P = M / 32, SLOT = M + M / 32;
  constexpr int TWL = Plan<M>::tw_len, R1 = Plan<M>::first;
  constexpr int MAXR = 8;  // n_fft / hop at most
  extern __shared__ float2 smem[];
  const int W = blockDim.x / 32, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int R = a.ratio, hop = a.hop, hs = a.hop_shift, nf = a.nf;
  const int ov = (R - 1) * hop, S = W + R - 1, SI = 2 * W + R - 1;
  const int L_in = SI * hop;
  // the arrays read 16 bytes at a time first: every offset a multiple of 4
  // floats (SLOT and hop are)
  float2* slots = smem;
  float* ring = reinterpret_cast<float*>(slots + S * SLOT);
  float* envc = ring + L_in;
  float2* tw = reinterpret_cast<float2*>(envc + hop);
  float2* tws = tw + TWL;
  float2* win2 = tws + (M + 1);
  float* gh = reinterpret_cast<float*>(win2 + M);
  const float* win = reinterpret_cast<const float*>(win2);

  const int run = blockIdx.x % a.runs;
  const long long row = blockIdx.x / a.runs;
  const int f0 = run * a.frames_per_run;
  const int f1 = min(nf, f0 + a.frames_per_run);
  const int fs = max(0, f0 - (R - 1));
  const bool last_run = f1 == nf;
  const int pos = *a.pos;
  const float inv_n = 1.0f / N;
  const float* xr = a.x + row * a.x_stride;
  const float* xhr = a.xh + row * ov;

  // Copies hop-blocks [e0, e1) of ext (x_hist's ov samples, then x) into
  // the ring, hop-block e at slot e mod SI; ri is e0 mod SI.
  // 16 bytes a copy where x's and x_hist's rows allow it (vec4), else 4.
  auto fetch = [&](int e0, int e1, int ri) {
    const int c = a.vec4 ? 4 : 1;
    for (int i = tid * c; i < (e1 - e0) << hs; i += blockDim.x * c) {
      const int d = i >> hs, p = i & (hop - 1);
      const long long q = ((long long)(e0 + d) << hs) + p;
      const int sl = ri + d >= SI ? ri + d - SI : ri + d;
      const float* src = q < ov ? xhr + q : xr + (q - ov);
      if (a.vec4)
        cp_async16(ring + sl * hop + p, src);
      else
        cp_async4(ring + sl * hop + p, src);
    }
  };
  // the tables and the first wave's input, one group
  {
    const float2* src = reinterpret_cast<const float2*>(a.tab);
    for (int i = tid; i < TWL + (M + 1) + M; i += blockDim.x)
      cp_async8(tw + i, src + i);
    const float* g = a.tab + 2 * (TWL + (M + 1)) + N;
    for (int i = tid; i < M + 1; i += blockDim.x) cp_async4(gh + i, g + i);
  }
  fetch(fs, fs + min(W, f1 - fs) + R - 1, fs % SI);
  cp_commit();
  // frame f's slot is f mod S, hop-block e's ring slot e mod SI: sa and ra
  // are a0 mod S and a0 mod SI
  int sa = fs % S, ra = fs % SI;
  for (int a0 = fs; a0 < f1; a0 += W, sa = sa + W >= S ? sa + W - S : sa + W,
           ra = ra + W >= SI ? ra + W - SI : ra + W) {
    const int nw = min(W, f1 - a0);
    // 1. the next wave's new hop-blocks, in flight while this one computes
    if (a0 + W < f1) {
      const int e0 = a0 + W + R - 1;
      const int r0 = ra + W + R - 1 >= SI ? ra + W + R - 1 - SI : ra + W + R - 1;
      fetch(e0, e0 + min(W, f1 - a0 - W), r0);
    }
    cp_commit();
    cp_wait_prior1();
    __syncthreads();
    if (a0 == fs) {
      // the envelope where the R frames over a position all count: every
      // hop-block of a stream's interior, the same for each
      for (int p = tid; p < hop; p += blockDim.x) {
        float e = 0.0f;
        for (int k = 0; k < R; ++k) {
          const float wk = win[(k << hs) + p];
          e = __fadd_rn(e, __fmul_rn(__fmul_rn(wk, wk), 1.0f));
        }
        envc[p] = e < 1e-8f ? 1e-8f : e;
      }
    }
    // 2. a warp a frame
    if (warp < nw) {
      const int f = a0 + warp;
      const int sl = sa + warp >= S ? sa + warp - S : sa + warp;
      float2* s = slots + sl * SLOT;
      const float msk =
          (long long)pos + ((long long)f << hs) >= ov ? 1.0f : 0.0f;
      float2 v[P];
      const int ri = ra + warp >= SI ? ra + warp - SI : ra + warp;
      const int base = ri * hop;  // the ring's index of the frame's start
#pragma unroll
      for (int b = 0; b < M / (32 * R1); ++b)
#pragma unroll
        for (int r = 0; r < R1; ++r) {
          const int n = lane + 32 * b + r * (M / R1);
          int idx = base + 2 * n;
          if (idx >= L_in) idx -= L_in;
          const float2 xv = *reinterpret_cast<const float2*>(ring + idx);
          const float2 wv = win2[n];
          v[b * R1 + r] =
              make_float2(__fmul_rn(xv.x, wv.x), __fmul_rn(xv.y, wv.y));
        }
      fft<M, false>(v, s, tw, t, lane);
      store_natural<M>(v, s, lane);
      __syncwarp();
      // the split step, the gain and the inverse split: the lane takes the
      // pairs (k, M - k), k = lane + 32 m < M / 2, and lane 0 k = M / 2
      for (int m = 0; m <= M / 64; ++m) {
        if (m == M / 64 && lane != 0) break;
        const int k = lane + 32 * m, kp = M - k;
        const float2 zk = s[pad(k)], zp = s[pad(kp & (M - 1))];
        const float2 tk = tws[k], tp = tws[kp];
        const float2 yk = scale(gh[k], split_fwd(zk, zp, tk));
        const float2 yp = scale(gh[kp], split_fwd(zp, zk, tp));
        s[pad(k)] = split_inv(yk, yp, tk);
        if (k != 0 && kp != k) s[pad(kp)] = split_inv(yp, yk, tp);
      }
      __syncwarp();
      load_pass<M, R1>(v, s, lane);
      __syncwarp();
      fft<M, true>(v, s, tw, t, lane);
      store_synthesis<M>(v, s, win2, inv_n, msk, lane);
    }
    __syncthreads();
    // 3. the wave's hop-blocks, and after a row's last frame its tails:
    // hop-block j sums chunk k of frame j - k, k = 0 first, over the
    // frames that exist
    const int jlo = max(a0, f0);
    const int jhi = last_run && a0 + nw == f1 ? nf + R - 1 : a0 + nw;
    const float* sf = reinterpret_cast<const float*>(slots);
    for (int j = jlo + warp; j < jhi; j += W) {  // a warp a hop-block
      int off[MAXR];
      float mk[MAXR];
#pragma unroll
      for (int k = 0; k < MAXR; ++k) {
        const int f = j - k, d = f - a0;  // d in [-(R - 1), W)
        const bool has = k < R && f >= 0 && f < nf;
        const int sl = d < 0 ? sa + d + (sa + d < 0 ? S : 0)
                             : (sa + d >= S ? sa + d - S : sa + d);
        off[k] = has ? 2 * sl * SLOT + (k << hs) : -1;
        mk[k] = (long long)pos + ((long long)f << hs) >= ov ? 1.0f : 0.0f;
      }
      const long long q0 = (long long)j << hs;  // buf's position of p = 0
      float* yr = a.y + row * a.t + q0;
      // the R frames over the hop-block all count and nothing is carried
      // into it: its envelope is envc; 4 positions a lane
      const bool interior =
          j >= R - 1 && j < nf &&
          (long long)pos + ((long long)(j - R + 1) << hs) >= ov;
      if (interior) {
        for (int p = 4 * lane; p < hop; p += 128) {
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int k = 0; k < MAXR; ++k)
            if (k < R) {
              const float4 v = *reinterpret_cast<const float4*>(sf + off[k] + p);
              acc = make_float4(__fadd_rn(acc.x, v.x), __fadd_rn(acc.y, v.y),
                                __fadd_rn(acc.z, v.z), __fadd_rn(acc.w, v.w));
            }
          const float4 e = *reinterpret_cast<const float4*>(envc + p);
          *reinterpret_cast<float4*>(yr + p) =
              make_float4(__fdiv_rn(acc.x, e.x), __fdiv_rn(acc.y, e.y),
                          __fdiv_rn(acc.z, e.z), __fdiv_rn(acc.w, e.w));
        }
        continue;
      }
      for (int p = lane; p < hop; p += 32) {
        float acc = 0.0f, e = 0.0f;
#pragma unroll
        for (int k = 0; k < MAXR; ++k) {
          if (off[k] < 0) continue;
          const float wk = win[(k << hs) + p];
          acc = __fadd_rn(acc, sf[off[k] + p]);
          e = __fadd_rn(e, __fmul_rn(__fmul_rn(wk, wk), mk[k]));
        }
        const long long q = q0 + p;
        if (q < ov) {
          acc = __fadd_rn(acc, a.ola[row * ov + q]);
          e = __fadd_rn(e, a.env[q]);
        }
        if (j < nf) {
          yr[p] = __fdiv_rn(acc, e < 1e-8f ? 1e-8f : e);
        } else {
          a.ola_new[row * ov + (q - a.t)] = acc;
          if (row == 0) a.env_new[q - a.t] = e;
        }
      }
    }
  }
  if (last_run) {  // x_hist's tail: ext[t, t + ov)
    for (int p = tid; p < ov; p += blockDim.x) {
      const long long q = (long long)a.t + p;
      a.xh_new[row * ov + p] = q < ov ? xhr[q] : xr[q - ov];
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    const int np = (int)((unsigned)pos + (unsigned)a.t);
    *a.pos_new = np < ov ? np : ov;
  }
}

template <int M>
int launch(const Args& a, const W32& t, cudaStream_t s) {
  // the most warps a CTA whose shared memory fits
  int warps = MAX_WARPS;
  while (warps > 0 &&
         smem_bytes(M, Plan<M>::tw_len, a.hop, a.ratio, warps) > SMEM_MAX)
    --warps;
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(M, Plan<M>::tw_len, a.hop, a.ratio, warps);
  cudaError_t e = cudaFuncSetAttribute(
      wola_gain_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wola_gain_kernel<M><<<a.rows * a.runs, 32 * warps, smem, s>>>(a, t);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, t) with rows x_stride floats apart; xh, ola (rows, ov), env
// (ov), pos (int32, on the card); tab the device tables; w32 the host's 32
// floats of W_32; y (rows, t), xh_new, ola_new (rows, ov), env_new (ov),
// pos_new fresh.  A CTA emits frames_per_run frames of a row.
extern "C" int wola_gain_launch(const float* x, long long x_stride,
                                const float* xh, const float* ola,
                                const float* env, const int* pos,
                                const float* tab, const float* w32, float* y,
                                float* xh_new, float* ola_new, float* env_new,
                                int* pos_new, int rows, int t, int n_fft,
                                int hop, int frames_per_run, void* stream) {
  if (rows <= 0 || t <= 0 || hop <= 0 || (hop & (hop - 1)) ||
      n_fft % hop || t % hop || frames_per_run <= 0 || n_fft / hop > 8)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.x_stride = x_stride; a.xh = xh; a.ola = ola; a.env = env;
  a.pos = pos; a.tab = tab; a.y = y; a.xh_new = xh_new;
  a.ola_new = ola_new; a.env_new = env_new; a.pos_new = pos_new;
  a.rows = rows; a.t = t; a.hop = hop; a.ratio = n_fft / hop;
  a.hop_shift = 0;
  while ((1 << a.hop_shift) < hop) ++a.hop_shift;
  a.nf = t / hop;
  a.frames_per_run = frames_per_run;
  a.runs = (a.nf + frames_per_run - 1) / frames_per_run;
  a.vec4 = x_stride % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)xh % 16 == 0;
  if ((long long)rows * a.runs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  W32 tw;
  for (int m = 0; m < 16; ++m) tw.w[m] = make_float2(w32[2 * m], w32[2 * m + 1]);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 256: return launch<128>(a, tw, s);
    case 512: return launch<256>(a, tw, s);
    case 1024: return launch<512>(a, tw, s);
    case 2048: return launch<1024>(a, tw, s);
    case 4096: return launch<2048>(a, tw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

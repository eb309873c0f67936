"""The tensor-core FIR tile of ``llzlab_tpu_torch/csrc/fir_mma.cuh``
emulated in numpy, for the CPU tests of the kernels that run on it (B1's
stage 1, B2 and B4 at "high").

The emulation follows the kernel's sum order as far as its contracts need:
by 16-row chunk of k, two chunks (32 taps) to a partial sum, the partial
sums added to the total in turn; so an output's sum depends on the tap
index and on the output's index mod 8 counted from the window's origin.
:func:`wg_fir_highest` does the same for the six-pass "highest" product of
B1's wgmma path (``csrc/fir_wgmma.cuh``), 64 phases wide.
"""

import numpy as np
import torch

from llzlab_tpu_torch.kernels import block2_fir as bf

N = 8
#: the emulated tile against a plain version at "high": the same bf16x3
#: products of the same hi/lo parts, only the f32 sum order differs
VS_PLAIN_DB = 100.0
#: against the JAX kernel at "high": the floor that
#: tests/test_torch_fused_fir_resample.py states for the plain version
VS_KERNEL_HIGH_DB = 110.0


def split(v):
    """bf16 hi and lo parts of f32 values, as f32 arrays."""
    hi, lo = bf._bf16_split(torch.from_numpy(np.array(v, np.float32)))
    return hi.numpy(), lo.numpy()


def tap_tiles(taps):
    """W's hi and lo tiles from the bf16 tap tables, as the kernel builds
    them."""
    hi, lo = bf.tap_tables(taps, "high")
    return (bf.toeplitz_tile(hi.float().numpy()),
            bf.toeplitz_tile(lo.float().numpy()))


def mma_fir(stream, taps, origin, count):
    """``y[origin : origin + count]`` (``count % 8 == 0``) of the causal FIR
    of ``stream (C, T)`` as the tile computes it from a window whose first
    output is stream index ``origin``; samples before the stream are 0."""
    wh, wl = tap_tiles(taps)
    kt = wh.shape[0]
    lead = kt - N  # xw[i] is the sample this long before output i
    lo_i, hi_i = origin - lead, origin + count
    pad_l, pad_r = max(0, -lo_i), max(0, hi_i - stream.shape[-1])
    xw = np.pad(stream, ((0, 0), (pad_l, pad_r)))[
        :, lo_i + pad_l:hi_i + pad_l]
    xh, xl = split(xw)
    view = np.lib.stride_tricks.sliding_window_view
    xh, xl = view(xh, kt, -1)[:, ::N], view(xl, kt, -1)[:, ::N]  # (C, M, kt)
    acc = np.zeros(xh.shape[:2] + (N,), np.float32)
    for c0 in range(0, kt, 32):
        part = np.zeros_like(acc)
        for k in range(c0, min(c0 + 32, kt)):
            part += xh[..., k, None] * wh[k]
            part += xl[..., k, None] * wh[k]
            part += xh[..., k, None] * wl[k]
        acc += part
    return acc.reshape(stream.shape[0], count)


#: B1's six-pass "highest" product: (x part, w part) of each pass, in the
#: order a partial sum takes them (``fir_wg_part6``), the smallest first:
#: lo·hi, hi·lo, mid·mid, mid·hi, hi·mid, hi·hi
SIX_PASSES = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def wg_fir_highest(stream, taps, origin, count):
    """``y[origin : origin + count]`` (``count % 64 == 0``) of the causal FIR
    of ``stream (C, T)`` as B1's wgmma path computes it at "highest": x and
    the float32 taps in three bf16 parts (``bf16_hi_mid_lo``), each product
    exact in f32, four 16-deep chunks (64 taps) to a partial sum that takes
    the six passes in :data:`SIX_PASSES` order, each over every chunk in
    order of k, summed in f32; the partial sums added to the total in f32.
    Samples before the stream are 0."""
    n = 64
    parts = bf.bf16_hi_mid_lo(torch.from_numpy(np.asarray(taps, np.float32)))
    w = [bf.toeplitz_tile(p.numpy(), n) for p in parts]
    kt = w[0].shape[0]
    lead = kt - n
    lo_i, hi_i = origin - lead, origin + count
    pad_l, pad_r = max(0, -lo_i), max(0, hi_i - stream.shape[-1])
    xw = np.pad(np.asarray(stream, np.float32), ((0, 0), (pad_l, pad_r)))[
        :, lo_i + pad_l:hi_i + pad_l]
    view = np.lib.stride_tricks.sliding_window_view
    x = [view(p.numpy(), kt, -1)[:, ::n]  # (C, M, kt)
         for p in bf.bf16_hi_mid_lo(torch.from_numpy(xw))]
    acc = np.zeros(x[0].shape[:2] + (n,), np.float32)
    for c0 in range(0, kt, 64):
        part = np.zeros_like(acc)
        for xp, wp in SIX_PASSES:
            for k in range(c0, min(c0 + 64, kt)):
                part += x[xp][..., k, None] * w[wp][k]
        acc += part
    return acc.reshape(stream.shape[0], count)

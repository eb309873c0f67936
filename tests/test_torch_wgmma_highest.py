"""Kernel B1 at "highest" on its wgmma path, what a CPU can check: the
three-way bf16 split of float32 values (``bf16_hi_mid_lo``, which the
kernel's ``fir_wg_split3`` mirrors in csrc/fir_wgmma.cuh), and the six-pass
product emulated in numpy in the kernel's sum order
(``tests/torch_mma_tile.py``), against float64 at the kernel floor of the
card tests (130 dB).  The kernel itself runs only in the ``cuda`` tests."""

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import fused_fir_resample as ff
from llzlab_tpu_torch.ops.fir import block2_block, firwin
from llzlab_tpu_torch.ops.resample import resample_taps
from tests.torch_mma_tile import SIX_PASSES, wg_fir_highest

#: the card tests' floor for B1 at "highest" against float64
#: (tests/test_torch_cuda.py FLOOR_DB)
FLOOR_DB = 130.0


def _snr_db(ref, y):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(y, np.float64)
    return 10.0 * np.log10(np.sum(ref * ref) / np.sum(err * err))


def _bits(u32):
    return torch.from_numpy(np.asarray(u32, np.uint32).view(np.float32))


def _values(kind):
    rng = np.random.default_rng(7)
    if kind == "normals":
        v = rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096)
        return torch.from_numpy(v.astype(np.float32))
    if kind == "powers_of_two":
        e = np.arange(-126, 128, dtype=np.float64)
        return torch.from_numpy(np.concatenate([2.0 ** e, -2.0 ** e])
                                .astype(np.float32))
    if kind == "bf16_ties":
        # low 16 bits exactly half a bf16 step (hi's tie), and the
        # remainder's own tie one level down (mid's), at every sign and
        # over the exponents where lo is a normal float (2^-103 and up)
        top = rng.integers(24 << 7, 0x7F7F, 2048, dtype=np.uint32) << 16
        sign = rng.integers(0, 2, 2048, dtype=np.uint32) << 31
        low = np.array([0x8000, 0x0080, 0x8080, 0x7FFF, 0xFFFF, 0x0001],
                       np.uint32)
        return _bits((sign | top)[:, None] | low[None, :]).reshape(-1)
    if kind == "near_max":
        # the largest floats, where bf16(x) rounded to nearest is infinite
        # from 0x7F7F8000 on
        mag = np.arange(0x7F7F0000, 0x7F800000, 97, dtype=np.uint32)
        mag = np.concatenate([mag, [0x7F7F8000, 0x7F7FFFFF]]).astype(
            np.uint32)
        return torch.cat([_bits(mag), -_bits(mag)])
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["normals", "powers_of_two", "bf16_ties",
                                  "near_max"])
def test_three_way_split_is_exact_and_finite(kind):
    """``hi + mid + lo == x`` in float32, in that order, with every part a
    finite bf16 value and ``hi`` the top 16 bits of x."""
    x = _values(kind)
    assert bool(torch.isfinite(x).all())
    hi, mid, lo = bf.bf16_hi_mid_lo(x)
    for p in (hi, mid, lo):
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all())
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(hi.view(torch.int32) >> 16, x.view(torch.int32) >> 16)
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -7).all())
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -15).all())
    if kind == "near_max":
        # where rounding to nearest would have overflowed
        assert bool(torch.isinf(x.to(torch.bfloat16)).any())


def test_three_way_split_of_float64_is_that_of_its_float32():
    """A float64 input is split as its float32 value (the taps are): the
    parts come back in float64 and add up to ``float32(x)`` exactly."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(1000))
    parts = bf.bf16_hi_mid_lo(x)
    want = bf.bf16_hi_mid_lo(x.to(torch.float32))
    for p, w in zip(parts, want):
        assert p.dtype == torch.float64 and torch.equal(p.float(), w)
    assert torch.equal(sum(parts), x.to(torch.float32).double())


def test_six_passes_are_the_products_above_fp32_rounding():
    """Of the nine products of two three-part operands the six kept are the
    six largest by their bound: each left out is at most 2^-22 of x*w."""
    bound = (1.0, 2.0 ** -7, 2.0 ** -15)  # |part| / |hi|, at most
    kept = sorted(bound[a] * bound[b] for a, b in SIX_PASSES)
    left = sorted(bound[a] * bound[b] for a in range(3) for b in range(3)
                  if (a, b) not in SIX_PASSES)
    assert max(left) <= 2.0 ** -22 < min(kept)
    # smallest first, hi*hi last
    by = [bound[a] * bound[b] for a, b in SIX_PASSES]
    assert by == sorted(by) and SIX_PASSES[-1] == (0, 0)


@pytest.mark.parametrize("ntaps", [129, 1024])
def test_six_pass_tile_holds_the_kernel_floor_against_float64(ntaps):
    """The emulated stage 1 against the float64 FIR of the float64 taps."""
    rng = np.random.default_rng(ntaps)
    taps = firwin(ntaps, 0.2, window="hamming")
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    y = wg_fir_highest(x, taps, 0, 2048)
    x64 = np.pad(x.astype(np.float64), ((0, 0), (ntaps - 1, 0)))
    view = np.lib.stride_tricks.sliding_window_view(x64, ntaps, -1)
    ref = view[:, :2048] @ taps[::-1]
    assert _snr_db(ref, y) >= FLOOR_DB


def test_six_pass_stage1_and_fp32_stage2_hold_the_floor_against_plain():
    """B1 at "highest" as its wgmma path computes it, at the reference
    tests' small shape (129 taps, 3/4, K = 8): stage 1 the six-pass tile
    from a window at a multiple of 64, stage 2 the bank product in f32;
    against the plain version in float64."""
    ntaps, up, down, k = 129, 3, 4, 8
    taps = firwin(ntaps, 0.2)
    rtaps = resample_taps(up, down, k)
    rng = np.random.default_rng(9)
    p = ff.fused_program_in(ntaps, up, down)
    x = rng.standard_normal((8, 2 * p)).astype(np.float32)
    zi = rng.standard_normal((8, ff.fused_state_len(ntaps))).astype(
        np.float32)
    hl = zi.shape[1]
    assert hl == 2 * block2_block(ntaps)
    stream = np.concatenate([zi, x], -1)
    # y from stream index −64 (a multiple of 64 before the first group's
    # first y, −(K−1))
    count = -(-(x.shape[1] + 64) // 64) * 64
    y = wg_fir_highest(stream, taps, hl - 64, count)
    (bank,) = ff.bank_tables(rtaps, up, down, "highest", "cpu",
                             torch.float32, dense=True)
    groups = x.shape[1] // down
    slab = np.lib.stride_tricks.sliding_window_view(
        y[:, 64 - (k - 1):], down + k - 1, -1)[:, ::down][:, :groups]
    z = (torch.from_numpy(np.ascontiguousarray(slab)) @ bank).reshape(
        8, groups * up).numpy()
    ref = ff.fused_fir_resample_plain(
        torch.from_numpy(x).double(), torch.from_numpy(zi).double(), taps,
        up, down, rtaps, "highest").numpy()
    assert z.shape == ref.shape
    assert _snr_db(ref, z) >= FLOOR_DB

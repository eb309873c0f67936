"""Geometry of kernel B1's CUDA blocks: the Python mirror
(``_run_groups``, ``_geometry``, ``_smem_bytes``, ``kernel_fits`` in
``llzlab_tpu_torch/kernels/fused_fir_resample.py``) of ``geometry`` in
``csrc/fused_fir_resample.cu``, over a grid of (ntaps, down, K); and the
fragment order of the bank that the tensor-core stage 2 reads."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import fused_fir_resample as ff
from llzlab_tpu_torch.ops.resample import resample_taps

CU = (Path(ff.__file__).parent.parent / "csrc" / "fused_fir_resample.cu")
MMA = CU.with_name("fir_mma.cuh")
#: (ntaps, down, K): the headline and channelizer shape, the small test
#: shape, and shapes that stress each term (odd down, long K, short taps,
#: a down of thousands)
GRID = [(1024, 160, 64), (129, 4, 8), (129, 3, 16), (1024, 147, 64),
        (256, 4, 200), (2049, 2, 32), (17, 7, 4), (513, 3000, 16),
        (1024, 5000, 64)]
#: two blocks on an SM: half of its 227 KB
TWO_PER_SM = 232448 // 2


def _formula(ntaps, down, k, gs, high):
    """The block's shared memory from the formula that the comment above
    ``struct Geometry`` in the .cu documents."""
    ly = gs * down + k - 1 + 7
    lyp = -(-ly // 4096) * 4096
    if high:
        kt = -(-(ntaps + 7) // 16) * 16
        lx = lyp + kt - 8
        k2 = -(-(down + k - 1) // 16) * 16
        scratch = max(2 * 8 * (kt + 8) + 2 * lx, 2 * 32 * (k2 + 8))
        return 2 * (scratch + 2 * lyp)
    ntp = -(-ntaps // 32) * 32
    return 4 * (ntp + (lyp + ntp) + lyp)


def test_source_documents_the_formula_and_constants_agree():
    text = CU.read_text()
    doc = " ".join(text[text.index("// Mirrored by _smem_bytes"):
                        text.index("struct Geometry")].split())
    for piece in ("ly = gs*down + k-1 + 7", "lyp = ly rounded up to 4096",
                  "lx = lyp + ntp; // smem = 4 * (ntp + lx + lyp)",
                  "kt = ntaps + 7 rounded up to 16; lx = lyp + kt - 8;",
                  "k2 = down + k-1 rounded up to 16;",
                  "scratch = max(2 * 8 * (kt + 8) + 2 * lx, "
                  "2 * 32 * (k2 + 8))",
                  "smem = 2 * (scratch + 2 * lyp)"):
        assert piece in doc, piece
    const = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = (\d+);", text))
    assert int(const["STEP"]) == ff._STEP
    assert int(const["SMEM_MAX"]) == ff._SMEM_MAX
    assert "constexpr int ALIGN = FIR_MMA_N;" in text
    assert f"constexpr int FIR_MMA_N = {ff._ALIGN};" in MMA.read_text()


@pytest.mark.parametrize("ntaps,down,k", GRID)
def test_mirror_equals_documented_formula(ntaps, down, k):
    gs = ff._run_groups(down, k)
    for mode in ("high", "highest"):
        assert ff._smem_bytes(ntaps, down, k, mode) == _formula(
            ntaps, down, k, gs, mode == "high")
    fits = max(_formula(ntaps, down, k, gs, h) for h in (0, 1)) <= 232448
    assert ff.kernel_fits(ntaps, down, k) == fits


@pytest.mark.parametrize("ntaps,down,k", GRID)
def test_run_groups_fill_whole_passes_with_room_for_alignment(ntaps, down, k):
    gs = ff._run_groups(down, k)
    assert gs >= 1
    need = gs * down + k - 1 + (ff._ALIGN - 1)  # y window, worst alignment
    passes = -(-need // ff._STEP)
    assert need <= passes * ff._STEP
    # one more group would not fit those passes, unless one group alone
    # needs them all
    assert (gs + 1) * down + k - 1 + (ff._ALIGN - 1) > passes * ff._STEP \
        or gs == 1
    for mode in ("high", "highest"):
        rows, lx, lyp = ff._geometry(ntaps, down, k, mode)
        assert lyp == passes * ff._STEP and lyp % 128 == 0
        # every block's origin is a multiple of 8 at most 7 before its
        # first y, so its last group's last y lies inside the window
        for s0 in (0, gs, 7 * gs):
            o = ff._window_origin(s0, down, k)
            assert o % ff._ALIGN == 0
            last = (s0 + gs) * down - 1  # last y of the last group
            assert 0 <= s0 * down - (k - 1) - o < ff._ALIGN
            assert last - o < lyp


@pytest.mark.parametrize("ntaps,down,k", GRID)
def test_window_padding_covers_the_last_tile(ntaps, down, k):
    """The x window holds every sample that the last m-tile ("high") or the
    last four outputs ("highest") of the y window read."""
    kt, lx, lyp = ff._geometry(ntaps, down, k, "high")
    assert kt == bf.mma_rows(ntaps) and kt % 16 == 0 and lx % 8 == 0
    last_row = lyp // 8 - 1               # of the overlapping X view
    assert 8 * last_row + kt - 1 == lx - 1
    ntp, lx, lyp = ff._geometry(ntaps, down, k, "highest")
    assert ntp % 32 == 0 and ntp >= ntaps
    assert (lyp - 4) + ntp + 3 <= lx - 1  # fir_out4's last read


@pytest.mark.parametrize("ntaps,down,k", [(1024, 160, 64)])
def test_headline_and_channelizer_blocks_fit_twice_on_an_sm(ntaps, down, k):
    """The headline chain and the channelizer share (1024 taps, 147/160,
    K = 64)."""
    assert ff._run_groups(down, k) == 25
    for mode in ("high", "highest"):
        assert ff._smem_bytes(ntaps, down, k, mode) <= TWO_PER_SM
    assert ff._smem_bytes(ntaps, down, k, "high") == 70432
    assert ff.kernel_fits(ntaps, down, k)


def test_a_down_of_thousands_does_not_fit():
    assert not ff.kernel_fits(1024, 20000, 64)
    assert ff.kernel_fits(129, 4, 8)


@pytest.mark.parametrize("up,down,k", [(147, 160, 64), (3, 4, 8),
                                       (160, 147, 16)])
def test_mma_bank_is_the_dense_bank_in_fragment_order(up, down, k):
    """Lane ``l`` of n-tile ``nt``, chunk ``ks`` holds row ``8·nt + l//4``
    of the dense bank at columns ``16·ks + 2·(l%4) + {0, 1}`` (hi), the
    same + 8 (hi), and both again of lo; rows and columns beyond the bank
    are zero."""
    r = resample_taps(up, down, k)
    frag = ff.mma_bank_tables(r, up, down)
    kd = down + k - 1
    assert frag.dtype == torch.bfloat16 and frag.is_contiguous()
    assert tuple(frag.shape) == (-(-up // 8), -(-kd // 16), 32, 4, 2)
    dense = [t.T.contiguous().view(torch.int16).numpy() for t in
             ff.bank_tables(r, up, down, "high", "cpu", torch.bfloat16,
                            dense=True)]  # (up, kd) hi and lo bits
    bits = frag.view(torch.int16).numpy()
    pad = [np.zeros((bits.shape[0] * 8, bits.shape[1] * 16), np.int16)
           for _ in dense]
    for p, d in zip(pad, dense):
        p[:up, :kd] = d
    for nt in range(bits.shape[0]):
        for ks in range(bits.shape[1]):
            for lane in range(32):
                n, c = 8 * nt + lane // 4, 16 * ks + 2 * (lane % 4)
                want = [pad[0][n, c:c + 2], pad[0][n, c + 8:c + 10],
                        pad[1][n, c:c + 2], pad[1][n, c + 8:c + 10]]
                np.testing.assert_array_equal(bits[nt, ks, lane], want)


def test_kernel_tables_by_mode():
    r = resample_taps(3, 4, 8)
    taps = np.hanning(17)
    hi, lo, bank = ff.kernel_tables(taps, r, 3, 4, "high")
    assert hi.dtype == lo.dtype == bank.dtype == torch.bfloat16
    assert bank is ff.mma_bank_tables(r, 3, 4)
    t32, b32 = ff.kernel_tables(taps, r, 3, 4, "highest")
    assert t32.dtype == b32.dtype == torch.float32 and b32.shape == (8, 3)


# ---- the wgmma path ("high" where it fits: csrc/fir_wgmma.cuh) ------------

WG = CU.with_name("fir_wgmma.cuh")
#: (ntaps, up, down, K): the headline and channelizer shape first, then the
#: card tests' shapes and the long filters
WG_GRID = [(1024, 147, 160, 64), (129, 3, 16, 8), (256, 5, 16, 8),
           (513, 2, 48, 16), (1024, 147, 32, 64), (2000, 3, 16, 8),
           (2000, 147, 160, 64), (2049, 147, 160, 64), (129, 3, 4, 8),
           (1024, 160, 147, 16), (129, 7, 50, 16), (129, 3, 8, 8)]


def _wg_formula(ntaps, up, down, k):
    """``(fits, smem)`` of a wgmma block from the formula that the comment
    above ``struct WgGeometry`` in the .cu documents."""
    gs = (8192 - 63 - (k - 1)) // down
    if down % 16:
        return False, None
    kt = -(-(ntaps + 63) // 16) * 16
    nd = kt // 8 + 7
    lx = -(-(8192 + kt - 64) // 64) * 64
    las = (lx // 64) | 1
    nt = -(-up // 8)
    nv = 0
    for t in range(nt):
        p = min(8 * t + 7, up - 1)
        nv += (p * down // up + k - 1) // 16 - (8 * t * down // up) // 16 + 1
    npl = down // 8
    k2 = -(-(down + k - 1) // 16) * 16
    la = (max(1029 // npl, 64 * -(-gs // 64) - 1 + (8 + k2 // 8) // npl)
          + 1) | 1
    cw = max(2 * 128 * las, 2 * 16 * npl * la)
    smem = (128 + 2 * 128 * nd + 4 * lx + -(-4 * nt // 16) * 16
            + 512 * nv + 2 * cw)
    return down % 16 == 0 and gs >= 1 and smem <= 232448, smem


def _wg_formula_highest(ntaps, up, down, k):
    """``(fits, smem)`` of a "highest" wgmma block from the formula that
    the comment above ``struct WgGeometry`` documents: the tap tables and
    x planes in three parts, a ring of two quarter windows, the banded
    bank in f32, y in f32."""
    gs = (8192 - 63 - (k - 1)) // down
    if down % 16:
        return False, None
    kt = -(-(ntaps + 63) // 16) * 16
    nd = kt // 8 + 7
    lx = -(-(8192 + kt - 64) // 64) * 64
    las = (lx // 64) | 1
    nt = -(-up // 8)
    ks = max((min(8 * t + 7, up - 1) * down // up) - (8 * t * down // up)
             + k for t in range(nt))
    cw = max(3 * 128 * las, 4 * 8448)
    smem = 128 + 3 * 128 * nd + 2 * lx + 4 * nt * (8 * ks + 4) + 2 * cw
    return gs >= 1 and smem <= 232448, smem


def _wg_doc():
    text = CU.read_text()
    return " ".join(w for w in text[
        text.index("// Mirrored by _wgmma_smem_bytes"):
        text.index("struct WgGeometry")].split() if w != "//")


def test_wgmma_source_documents_the_highest_formula():
    doc = _wg_doc()
    for piece in ("cw = max(3 * 128 * las, 4 * 8448) (x planes | y in f32, "
                  "padded)",
                  "ks = the largest over n-tiles of (q of its last phase - "
                  "q of its first) + k, q_p = p*down/up",
                  "smem = 128 + 3 * 128 * nd + 2 * lx + 4 * nt * (8 * ks + "
                  "4) + 2 * cw"):
        assert piece in doc, piece
    # the "high" formula comes first, under its own heading
    assert doc.index("high: nt = ") < doc.index("highest: ks = ")


def test_wgmma_source_documents_the_formula_and_constants_agree():
    text = CU.read_text()
    doc = " ".join(w for w in text[
        text.index("// Mirrored by _wgmma_smem_bytes"):
        text.index("struct WgGeometry")].split() if w != "//")
    for piece in ("gs = (8192 - 63 - (k-1)) / down groups a unit (at least "
                  "1; down a multiple of 16)",
                  "kt = ntaps + 63 rounded up to 16; nd = kt/8 + 7",
                  "lx = 8192 + kt - 64 rounded up to 64; las = lx/64, "
                  "made odd",
                  "np = down / 8; k2 = down + k-1 rounded up to 16",
                  "la = max(1029 / np, 64 * (gs rounded up to 64, over 64) "
                  "- 1 + (8 + k2/8) / np) + 1, made odd",
                  "cw = max(2 * 128 * las, 2 * 16 * np * la)",
                  "smem = 128 + 2 * 128 * nd + 4 * lx + (4 * nt rounded up "
                  "to 16) + 512 * nv + 2 * cw"):
        assert piece in doc, piece
    wg = WG.read_text()
    assert f"constexpr int FIR_WG_PH = {ff._WG_PH};" in wg
    assert "constexpr int FIR_WG_ROWS = 128;" in wg
    assert ff._WG_LY == ff._WG_PH * 128


@pytest.mark.parametrize("ntaps,up,down,k", WG_GRID)
def test_wgmma_mirror_equals_documented_formula(ntaps, up, down, k):
    fits, smem = _wg_formula(ntaps, up, down, k)
    if down % 16 == 0:
        assert ff._wgmma_smem_bytes(ntaps, up, down, k) == smem
    assert ff.wgmma_fits(ntaps, up, down, k) == fits


@pytest.mark.parametrize("ntaps,up,down,k", WG_GRID)
def test_wgmma_highest_mirror_equals_documented_formula(ntaps, up, down, k):
    fits, smem = _wg_formula_highest(ntaps, up, down, k)
    if down % 16 == 0:
        assert ff._wgmma_smem_bytes(ntaps, up, down, k, "highest") == smem
    assert ff.wgmma_fits(ntaps, up, down, k, "highest") == fits


@pytest.mark.parametrize("ntaps,up,down,k,fits", [
    (1024, 147, 160, 64, True),   # the channelizer's cell, 4 cards
    (1089, 147, 160, 64, True),   # the longest filter that fits there
    (1090, 147, 160, 64, False),  # three parts of tables and planes: full
    (1536, 147, 160, 64, False),  # fits at "high"
    (1777, 3, 16, 8, True),       # a small bank leaves room for the taps
    (1778, 3, 16, 8, False),
    (2000, 3, 16, 8, False),      # fits at "high"
    (129, 3, 4, 8, False),        # the small test shape: fp32 FMA
    (1024, 160, 147, 16, False),  # an odd down
    (1024, 147, 20000, 64, False),  # no group fits a unit
])
def test_wgmma_highest_path_is_decided_by_the_shape(ntaps, up, down, k,
                                                    fits):
    assert ff.wgmma_fits(ntaps, up, down, k, "highest") == fits
    if fits:
        assert ff._wgmma_smem_bytes(ntaps, up, down, k,
                                    "highest") <= ff._SMEM_MAX
        assert ff.wgmma_fits(ntaps, up, down, k)  # and at "high"
        assert ff.kernel_fits(ntaps, down, k)  # the fallback fits as well


def test_headline_highest_wgmma_block_fits_one_sm():
    """At 1024 taps, 147/160, K = 64: tap tables 54 912 B, the ring of two
    quarter windows 18 432, the banded bank 44 080 (19 n-tiles of 72 taus
    by 8 phases and 4 floats of padding), two consumers' three x planes
    2 x 55 680 (y in f32, 32 768, takes their place): 228 912 B of the
    232 448."""
    assert ff._wgmma_band(147, 160, 64) == 72
    assert ff.wgmma_fits(1024, 147, 160, 64, mode="highest")
    assert ff._wgmma_smem_bytes(1024, 147, 160, 64, "highest") == 228912
    assert (128 + 54912 + 18432 + 19 * (8 * 72 + 4) * 4 + 2 * 55680
            == 228912 <= ff._SMEM_MAX)
    assert ff._wgmma_smem_bytes(1024, 147, 160, 64, "highest") > TWO_PER_SM


@pytest.mark.parametrize("ntaps,up,down,k,fits", [
    (1024, 147, 160, 64, True),   # the headline and the channelizer
    (1536, 147, 160, 64, True),
    (2000, 147, 160, 64, False),  # the tap tables and windows outgrow it
    (2049, 147, 160, 64, False),
    (2000, 3, 16, 8, True),       # a small bank leaves room for them
    (2000, 3, 4, 8, False),       # the envelope's: a down of 4
    (129, 3, 4, 8, False),        # the small test shape
    (1024, 160, 147, 16, False),  # upsampling 147 -> 160: an odd down
    (1024, 147, 20000, 64, False),  # no group fits a unit
])
def test_wgmma_path_is_decided_by_the_shape(ntaps, up, down, k, fits):
    assert ff.wgmma_fits(ntaps, up, down, k) == fits
    if fits:
        assert ff._wgmma_smem_bytes(ntaps, up, down, k) <= ff._SMEM_MAX
        assert ff.kernel_fits(ntaps, down, k)  # the fallback fits as well


def test_headline_wgmma_block_fills_one_sm():
    assert ff._wgmma_groups(160, 64) == 50
    assert ff._wgmma_smem_bytes(1024, 147, 160, 64) == 209104
    assert ff._wgmma_smem_bytes(1024, 147, 160, 64) > TWO_PER_SM


@pytest.mark.parametrize("ntaps,up,down,k", WG_GRID)
def test_wgmma_units_hold_their_groups_from_a_multiple_of_64(
        ntaps, up, down, k):
    """A unit's y window (8192 outputs) starts at a multiple of 64 of the
    stream index at most 63 before its first group's first y, and holds
    its last group's last y; one more group would not fit."""
    gs = ff._wgmma_groups(down, k)
    if not ff.wgmma_fits(ntaps, up, down, k):
        return
    assert gs * down + k - 1 + 63 <= ff._WG_LY
    assert (gs + 1) * down + k - 1 + 63 > ff._WG_LY
    for s0 in (0, gs, 7 * gs, 1000 * gs):
        o = ff._window_origin(s0, down, k, ff._WG_PH)
        assert o % 64 == 0
        assert 0 <= s0 * down - (k - 1) - o < 64
        assert (s0 + gs) * down - 1 - o < ff._WG_LY


@pytest.mark.parametrize("ntaps", [17, 129, 1024])
def test_wgmma_tap_table_is_the_toeplitz_in_core_matrix_order(ntaps):
    """Core matrix ``(n'/8, k/8)`` of ``A[n', k]``, the (kt, 64) Toeplitz
    with its phases in reverse (``A[n', k] = W[k, 63 − n']``), is entry
    ``n'/8 + k/8`` of the table, row ``n' % 8``, column ``k % 8``, for
    every (n', k) and both parts; the table has no other entries."""
    taps = np.random.default_rng(ntaps).standard_normal(ntaps)
    tab = ff.wgmma_tap_tables(taps)
    kt = ff._wgmma_kt(ntaps)
    assert kt % 16 == 0 and kt >= ntaps + 63 > kt - 16
    assert tab.dtype == torch.bfloat16 and tab.is_contiguous()
    assert tuple(tab.shape) == (2, kt // 8 + 7, 8, 8)
    bits = tab.view(torch.int16).numpy()
    for part, t in zip(bits, bf.tap_tables(taps, "high")):
        w = np.zeros((kt, 64), np.float32)  # W[k, c] = taps[c - k + kt - 64]
        kk, cc = np.meshgrid(np.arange(kt), np.arange(64), indexing="ij")
        j = cc - kk + kt - 64
        ok = (j >= 0) & (j < ntaps)
        w[ok] = t.float().numpy()[j[ok]]
        want = torch.from_numpy(w).to(torch.bfloat16).view(torch.int16)
        n, k = np.meshgrid(np.arange(64), np.arange(kt), indexing="ij")
        got = part[n // 8 + k // 8, n % 8, k % 8]
        np.testing.assert_array_equal(got, want.numpy()[k, 63 - n])


@pytest.mark.parametrize("ntaps", [17, 129, 1024])
def test_wgmma_highest_tap_table_is_three_exact_parts(ntaps):
    """At "highest" the table has three parts, each entry's bf16 hi, mid and
    lo of the float32 tap (``bf16_hi_mid_lo``) at the place that "high"
    puts hi and lo: they add up to the float32 Toeplitz exactly."""
    taps = np.random.default_rng(ntaps).standard_normal(ntaps)
    tab = ff.wgmma_tap_tables(taps, mode="highest")
    kt = ff._wgmma_kt(ntaps)
    assert tab.dtype == torch.bfloat16 and tab.is_contiguous()
    assert tuple(tab.shape) == (3, kt // 8 + 7, 8, 8)
    hi, mid, lo = tab.double().numpy()
    d, r, c = np.ogrid[:kt // 8 + 7, :8, :8]
    idx = kt - 1 - 8 * d - r - c
    ok = (idx >= 0) & (idx < ntaps)
    want = np.where(ok, taps.astype(np.float32)[np.clip(idx, 0, ntaps - 1)],
                    0.0)
    np.testing.assert_array_equal(hi + mid + lo, want)
    assert np.all(np.abs(mid) <= np.abs(hi) * 2.0 ** -7)
    assert np.all(np.abs(lo) <= np.abs(hi) * 2.0 ** -15)
    with pytest.raises(ValueError):
        ff.wgmma_tap_tables(taps, mode="fast")


@pytest.mark.parametrize("ntaps", [17, 129])
def test_wgmma_highest_descriptor_walk_is_the_fir(ntaps):
    """The six passes as the kernel's descriptors address them
    (``fir_wg_part6``): the w part at ``WP[s]`` tables past the hi table,
    the x part at ``XP[s]`` plane sets past the hi planes, each pass over
    every chunk.  In float64 the six passes are the FIR of the float32
    taps and window but for the mid*lo, lo*mid and lo*lo terms they leave
    out, under 2^-22 of each product."""
    rng = np.random.default_rng(ntaps)
    taps = rng.standard_normal(ntaps)
    kt, nd, lx, las = ff._wgmma_geometry(ntaps, 3, 16, 8)[:4]
    tab = ff.wgmma_tap_tables(taps, mode="highest").double().numpy()
    tab = tab.reshape(3, -1)
    xw = rng.standard_normal(lx).astype(np.float32)
    q = np.arange(lx)
    planes = np.zeros((3, 8 * las * 8))
    for i, part in enumerate(bf.bf16_hi_mid_lo(torch.from_numpy(xw))):
        planes[i][((q // 8) % 8 * las + q // 64) * 8 + q % 8] = part.numpy()

    def core(mem, start, lbo, sbo, rows, cols):  # element offsets
        r, c = np.meshgrid(rows, cols, indexing="ij")
        return mem[start + r // 8 * sbo + c // 8 * lbo + r % 8 * 8 + c % 8]

    xp, wp = (2, 0, 1, 1, 0, 0), (0, 2, 1, 0, 1, 0)
    y = np.zeros((64, 128))
    for s in range(6):
        for ch in range(kt // 16):
            a = core(tab[wp[s]], 128 * ch, 64, 64, np.arange(64),
                     np.arange(16))
            b = core(planes[xp[s]], ((2 * ch) % 8 * las + ch // 4) * 8,
                     las * 8, 64, np.arange(128), np.arange(16))
            y += a @ b.T
    h32 = taps.astype(np.float32).astype(np.float64)
    x64 = xw.astype(np.float64)
    i = np.arange(8192)
    win = x64[i[:, None] + kt - 64 - np.arange(ntaps)[None, :]]
    ref, mag = win @ h32, np.abs(win) @ np.abs(h32)
    out = np.zeros(8192)
    n, m = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    out[64 * m + 63 - n] = y
    assert np.all(np.abs(out - ref) <= 2.0 ** -22 * mag)
    assert np.any(out != ref)  # the terms left out are there


@pytest.mark.parametrize("ntaps", [17, 129])
def test_wgmma_descriptor_walk_is_the_fir(ntaps):
    """The product as the kernel's descriptors address it: chunk ``ch`` of
    A at core matrix ``2·ch`` of the table (LBO = SBO = 128 bytes), of B at
    plane ``2·ch % 8``, row ``2·ch / 8`` of the window's planes (LBO one
    plane, SBO 8 rows), the accumulator's row ``n'`` and column ``m`` the
    output ``64·m + 63 − n'``: the FIR of the window, exactly in f64."""
    rng = np.random.default_rng(ntaps)
    taps = rng.standard_normal(ntaps)
    kt, nd, lx, las = ff._wgmma_geometry(ntaps, 3, 16, 8)[:4]
    d = ff.wgmma_tap_tables(taps)[0].double().numpy().reshape(-1)
    xw = rng.standard_normal(lx)
    q = np.arange(lx)
    planes = np.zeros(8 * las * 8)
    planes[((q // 8) % 8 * las + q // 64) * 8 + q % 8] = xw

    def core(mem, start, lbo, sbo, rows, cols):  # element offsets
        r, c = np.meshgrid(rows, cols, indexing="ij")
        return mem[start + r // 8 * sbo + c // 8 * lbo + r % 8 * 8 + c % 8]

    y = np.zeros((64, 128))
    for ch in range(kt // 16):
        a = core(d, 128 * ch, 64, 64, np.arange(64), np.arange(16))
        b = core(planes, ((2 * ch) % 8 * las + ch // 4) * 8, las * 8, 64,
                 np.arange(128), np.arange(16))
        y += a @ b.T
    h_hi = bf.tap_tables(taps, "high")[0].double().numpy()
    i = np.arange(8192)
    ref = np.array([h_hi @ xw[j + kt - 64 - np.arange(ntaps)] for j in i])
    out = np.zeros(8192)
    n, m = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    out[64 * m + 63 - n] = y
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("up,down,k,a", [(147, 160, 64, 33), (3, 16, 8, 0),
                                         (5, 48, 12, 61)])
def test_wgmma_stage2_descriptor_walk_is_the_slab(up, down, k, a):
    """Stage 2's B, as its descriptors address the y planes: chunk ``ks``
    of the 64 groups from ``gb`` at plane ``q % np``, row ``q // np + gb``
    (``q = ys/8 + 2·ks``, LBO one plane, SBO 8 rows), where y sample ``i``
    of the window is stored at plane position ``i + shift`` by
    ``fir_wg_yplane`` (``shift`` making ``a + shift`` a multiple of 16): it
    is ``slab[g][tau] = y[a + g·down + tau]`` for every group of the unit."""
    kt, nd, lx, las, ntiles, nv, npl, la = ff._wgmma_geometry(129, up, down,
                                                              k)
    gs = ff._wgmma_groups(down, k)
    shift = (16 - a % 16) % 16
    ys = a + shift
    inv = (0xFFFFFFFF // npl) + 1
    y = np.random.default_rng(down).standard_normal(8192)
    planes = np.full(16 * npl * la, np.nan)
    i = np.arange(8192) + shift
    q = i // 8
    row = (q * inv) >> 32
    assert np.array_equal(row, q // npl)  # the kernel's division
    planes[((q - row * npl) * la + row) * 8 + i % 8] = y
    k2 = -(-(down + k - 1) // 16) * 16
    kd = down + k - 1
    for gb in range(0, gs, 64):
        g = np.arange(gb, min(gb + 64, gs))
        for ks in range(k2 // 16):
            qq = ys // 8 + 2 * ks
            start = ((qq % npl) * la + qq // npl + gb) * 8
            r, c = np.meshgrid(g - gb, np.arange(16), indexing="ij")
            b = planes[start + r // 8 * 64 + c // 8 * la * 8 + r % 8 * 8
                       + c % 8]
            tau = 16 * ks + c
            ok = tau < kd  # taus past the slab meet zeros of the bank
            want = y[np.minimum(a + g[:, None] * down + tau, 8191)]
            np.testing.assert_array_equal(b[ok], want[ok])

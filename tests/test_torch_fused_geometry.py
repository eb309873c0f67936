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

"""The port's host-side design, geometry and weight tables, pinned bit-equal
to the JAX package (``llzlab_tpu``).  Both are built from the same f64 taps;
the port rounds to bf16 through f32 with round-to-nearest-even, as
``ml_dtypes`` does in the JAX package, so no tolerance applies here."""

import numpy as np
import pytest
import torch

from llzlab_tpu.kernels import block2_fir as rbf
from llzlab_tpu.kernels import fused_fir_resample as rff
from llzlab_tpu.ops import fir as rfir
from llzlab_tpu.ops import resample as rrs
from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import fused_fir_resample as ff
from llzlab_tpu_torch.ops import fir as pfir
from llzlab_tpu_torch.ops import resample as prs

MODES = ["high", "highest"]


def _bits(a) -> np.ndarray:
    """Bit patterns of a bf16/f32 table (uint16 for bf16, uint32 for f32)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _dtype(mode):
    return torch.bfloat16 if mode == "high" else torch.float32


@pytest.mark.parametrize("ntaps,cutoff", [(1024, 0.25), (129, 0.2)])
def test_firwin_bit_equal(ntaps, cutoff):
    np.testing.assert_array_equal(
        pfir.firwin(ntaps, cutoff, window="hamming"),
        rfir.firwin(ntaps, cutoff, window="hamming"))


@pytest.mark.parametrize("up,down,k", [(147, 160, 64), (3, 4, 8)])
def test_resample_taps_and_polyphase_bit_equal(up, down, k):
    r = prs.resample_taps(up, down, k)
    np.testing.assert_array_equal(r, rrs.resample_taps(up, down, k))
    np.testing.assert_array_equal(prs.polyphase_weights(r, up, down),
                                  rrs.polyphase_weights(r, up, down))
    for t in (down * 7, down * 7 + 1, 245760):
        assert (prs.resample_output_len(t, up, down)
                == rrs.resample_output_len(t, up, down))


@pytest.mark.parametrize("ntaps", [2, 129, 256, 257, 1024, 1025, 2049])
def test_block_geometry_equal(ntaps):
    block = pfir.block2_block(ntaps)
    assert block == rfir.block2_block(ntaps)
    for method in ("block2", "direct", "ols"):
        assert (pfir.fir_state_len(ntaps, None, method)
                == rfir.fir_state_len(ntaps, None, method))
    for b in (4, 8, 12, 64):
        assert bf.supports(b, ntaps, block) == rbf.supports(b, ntaps, block)
    if ntaps - 1 <= block:
        assert bf.band_k(ntaps, block) == rbf.band_k(ntaps, block)


_FUSED_GRID = [(129, 3, 4, 8), (256, 3, 4, 8), (1024, 147, 160, 64),
               (1024, 160, 147, 64), (513, 2, 3, 16), (2049, 1, 2, 32),
               (129, 3, 4, 200), (4096, 3, 4, 8)]


@pytest.mark.parametrize("ntaps,up,down,k", _FUSED_GRID)
def test_fused_geometry_equal(ntaps, up, down, k):
    p = ff.fused_program_in(ntaps, up, down)
    assert p == rff.fused_program_in(ntaps, up, down)
    assert ff.fused_state_len(ntaps) == rff.fused_state_len(ntaps)
    assert (ff.fused_static_ok(ntaps, up, down, k)
            == rff.fused_static_ok(ntaps, up, down, k))
    for b in (4, 8, 12, 64):
        for t in (p, 2 * p, p + down, 245760):
            assert (ff.fused_supports(b, ntaps, up, down, k, t)
                    == rff.fused_supports(b, ntaps, up, down, k, t))


def test_headline_program_geometry():
    assert ff.fused_program_in(1024, 147, 160) == 20480
    assert ff.fused_supports(64, 1024, 147, 160, 64, 245760)
    assert ff.kernel_fits(1024, 160, 64)


@pytest.mark.parametrize("ntaps", [129, 256, 1024])
@pytest.mark.parametrize("mode", MODES)
def test_block2_tables_bit_equal(ntaps, mode):
    """The plain version's W tables, cut into the JAX kernel's banded
    (nt, kb, 128) tiles, equal the JAX tables; and every nonzero entry of
    W equals the kernel's tap table at its tap index."""
    taps = rfir.firwin(ntaps, 0.25)
    block = rfir.block2_block(ntaps)
    ref = rbf.block2_pallas_tables(taps, block, mode)
    port = bf.plain_tables(taps, block, mode, "cpu", _dtype(mode))
    assert len(ref) == len(port)
    kb = bf.band_k(ntaps, block)
    for r, w in zip(ref, port):
        tiles = np.stack([
            _bits(w[g * 128 + block + 128 - kb:][:kb, g * 128:(g + 1) * 128])
            for g in range(block // 128)])
        np.testing.assert_array_equal(tiles, _bits(r))
    idx = bf._w_matrix(np.arange(1, ntaps + 1, dtype=np.float64), block)
    nz = idx > 0
    for w, tv in zip(port, bf.tap_tables(taps, mode)):
        np.testing.assert_array_equal(
            _bits(w)[nz], _bits(tv)[idx[nz].astype(np.int64) - 1])


@pytest.mark.parametrize("up,down,k", [(147, 160, 64), (3, 4, 8)])
@pytest.mark.parametrize("mode", MODES)
def test_resample_bank_tables_bit_equal(up, down, k, mode):
    """The plain version's dense bank equals the JAX kernel's (k2p, up)
    table above its zero padding; the CUDA kernel's (K, up) bank holds
    exactly the nonzero entries of each phase."""
    r = rrs.resample_taps(up, down, k)
    k2 = down + k - 1
    ref = rff._rs_tables_cached(np.asarray(r, np.float64).tobytes(), up,
                                down, mode)
    dense = ff.bank_tables(r, up, down, mode, "cpu", _dtype(mode),
                           dense=True)
    kern = ff.bank_tables(r, up, down, mode, "cpu", _dtype(mode))
    q = (np.arange(up) * down) // up
    rows = q[None, :] + (k - 1) - np.arange(k)[:, None]
    for rt, d, kt in zip(ref, dense, kern):
        rb = _bits(rt)
        np.testing.assert_array_equal(_bits(d), rb[:k2])
        assert not rb[k2:].any()
        np.testing.assert_array_equal(
            _bits(kt), _bits(d)[rows, np.arange(up)[None, :]])

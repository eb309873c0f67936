"""Kernel B2 on fewer than 8 channels, against the JAX package's
low-channel block2 fold, and B2's own envelope.

The JAX package folds 1 to 7 channels into rows of ``L`` outputs to fill its
matrix unit's 8-row tile.  The port launches B2 once on the rows as they
are: on the card the fold gave bitwise the same output more slowly
(``PERF.md``).  ``chip_smoke.py`` frames the fold (``fold_geometry``,
``fold_rows``) to hold it against the one-row launch on the card.

(a) On the CPU ``fir_filter(method="block2")`` runs B2's plain version on
the rows as they are; it is held against the JAX package's
``_fir_filter_block2_pallas_folded`` with the Pallas kernel in interpret
mode, on the shapes of the JAX package's fold test
(``tests/kernels/test_block2_fir.py:76``), at the floors of
``tests/test_torch_block2_fir.py``; ``zf`` is bitwise.

(b) Under the emulated tensor-core tile (``tests/torch_mma_tile.py``) the
fold's rows are bitwise the one-row launch at "high": each row's outputs
start at a multiple of ``L``, so of 8.  A fold cut at ``L + 4`` is not.

(c) The dispatch: ``fir_filter(method="block2")`` is one call of B2 on the
channels as they are, for any channel count; ``cuda_supports`` takes any
row count.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

import chip_smoke
from llzlab_tpu.ops import fir as rfir
from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.ops import fir as pfir
from tests.conftest import snr_db
from tests.test_torch_block2_fir import VS_KERNEL_DB, VS_SCIPY_DB
from tests.test_torch_block2_mma import b2_emulated

MODES = ["high", "highest"]
#: the fold against the JAX fold at 1024 taps.  "high": the floor of
#: tests/test_torch_block2_fir.py.  "highest": the JAX kernel sums the
#: 1024 products of an output in one f32 running sum, 125 dB from float64
#: here, where the port's 32-tap partial sums are 129 dB from it; the gap
#: between the two is the JAX kernel's error, so the floor is 120 dB and the
#: port must in addition be no further from float64 than the JAX kernel (at
#: "high" both are the bf16x3 error, 107 dB from float64)
FOLD_VS_REF_DB = {"high": VS_KERNEL_DB["high"], "highest": 120.0}
#: the JAX package's fold test (tests/kernels/test_block2_fir.py:76)
FOLD_SHAPES = [(1, 8), (2, 5), (3, 4)]


@pytest.mark.parametrize("c,nblk", FOLD_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_block2_matches_reference_fold(c, nblk, mode, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", mode)
    taps = pfir.firwin(1024, 0.25)
    block = pfir.block2_block(1024)
    t = nblk * block + (17 if c == 3 else 0)
    rng = np.random.default_rng(10 + c)
    x = rng.standard_normal((c, t)).astype(np.float32)
    zi = rng.standard_normal((c, block)).astype(np.float32)
    for hist in (None, zi):
        y_ref, zf_ref = rfir._fir_filter_block2_pallas_folded(
            jnp.asarray(x), taps, None if hist is None else jnp.asarray(hist),
            block=block, mode=mode, return_zf=True, interpret=True)
        y, zf = pfir.fir_filter(
            torch.from_numpy(x), taps, method="block2",
            zi=None if hist is None else torch.from_numpy(hist),
            return_zf=True)
        assert y.shape == (c, t) and y.dtype == torch.float32
        assert snr_db(np.asarray(y_ref), y.numpy()) >= FOLD_VS_REF_DB[mode]
        np.testing.assert_array_equal(zf.numpy(), np.asarray(zf_ref))
        if mode == "highest":
            x64 = np.concatenate([np.zeros((c, block)) if hist is None
                                  else hist, x], 1).astype(np.float64)
            golden = ss.lfilter(taps, [1.0], x64, axis=-1)[:, block:]
            assert snr_db(golden, y.numpy()) >= snr_db(golden,
                                                       np.asarray(y_ref))


@pytest.mark.parametrize("ntaps,nblk,l", [(129, 40, 128), (129, 70, 4480),
                                          (256, 9, 768)])
def test_fold_rows_are_bitwise_the_one_row_launch_at_high(ntaps, nblk, l):
    """L = 128 (40 rows), 4480 (2 rows: a row walks two 4096-output
    passes) and 768 (3 rows)."""
    taps = pfir.firwin(ntaps, 0.2)
    block = pfir.block2_block(ntaps)
    rng = np.random.default_rng(20 + ntaps)
    xpad = rng.standard_normal((1, block + nblk * block - 37)).astype(
        np.float32)
    t = xpad.shape[1] - block
    one = b2_emulated(xpad, taps, block)
    r = -(-t // l)
    assert l % block == 0 and r > 1
    rows = chip_smoke.fold_rows(torch.from_numpy(xpad), block, l).numpy()
    assert rows.shape == (r, block + l)
    folded = b2_emulated(rows, taps, block).reshape(1, r * l)[:, :t]
    np.testing.assert_array_equal(folded, one)
    # rows cut at L + 4: every row after the first starts off the 8-grid
    cut = b2_emulated(chip_smoke.fold_rows(torch.from_numpy(xpad), block,
                                           l + 4).numpy(),
                      taps, block).reshape(1, -1)[:, :t]
    assert not np.array_equal(cut, one)
    assert snr_db(one.astype(np.float64), cut) >= 120.0  # the order only


@pytest.mark.parametrize("t,l,r", [(480000, 1024, 469), (95232, 1024, 93),
                                   (4 * 1024 + 17, 1024, 5)])
def test_fold_geometry_is_the_reference_one(t, l, r):
    """Config 1 (1 × 480 000 at 1024 taps), its CLI block, the small case;
    and the JAX package's arithmetic for other channel counts."""
    assert chip_smoke.fold_geometry(1, t, 1024) == (l, r)
    for b in (1, 2, 3, 7):
        for tt in (t, 2 * 128, 40 * 128 + 5):
            for block in (128, 1024):
                cap = max(8, 1024 // b)
                ll = -(-tt // (block * cap)) * block
                assert chip_smoke.fold_geometry(b, tt, block) == \
                    (ll, -(-tt // ll))


def _record_rows(monkeypatch):
    seen = []
    real = bf.block2_fir

    def spy(xpad, taps, block, *, mode="high"):
        seen.append(tuple(xpad.shape))
        return real(xpad, taps, block, mode=mode)

    monkeypatch.setattr(bf, "block2_fir", spy)
    return seen


@pytest.mark.parametrize("c,nblk", [(1, 8), (3, 4), (7, 2), (1, 1), (8, 4),
                                    (12, 3)])
def test_block2_is_one_call_on_the_channels_as_they_are(c, nblk,
                                                        monkeypatch):
    seen = _record_rows(monkeypatch)
    taps = pfir.firwin(256, 0.3)
    block = pfir.block2_block(256)
    x = np.random.default_rng(30 + c).standard_normal(
        (c, nblk * block + 5)).astype(np.float32)
    y = pfir.fir_filter(torch.from_numpy(x), taps, method="block2")
    assert seen == [(c, block + x.shape[1])]
    golden = ss.lfilter(taps, [1.0], x.astype(np.float64), axis=-1)
    for i in range(c):
        assert snr_db(golden[i], y[i].numpy()) >= VS_SCIPY_DB["highest"]


@pytest.mark.parametrize("mode", MODES)
def test_one_channel_stream_carries_state(mode, monkeypatch):
    """One channel streamed through block2 in three calls, cut at block
    multiples, against one shot and scipy (on the CPU the plain version's
    products are batched differently in each call, so the check is a
    floor; on the card the stream is bitwise, chip_smoke.py)."""
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", mode)
    taps = pfir.firwin(1024, 0.25)
    block = pfir.block2_block(1024)
    x = torch.from_numpy(np.random.default_rng(40).standard_normal(
        (1, 9 * block + 100)).astype(np.float32))
    one = pfir.fir_filter(x, taps)
    ys, zf = [], None
    for a, b in ((0, 3 * block), (3 * block, 5 * block), (5 * block, None)):
        y, zf = pfir.fir_filter(x[:, a:b], taps, zi=zf, return_zf=True)
        ys.append(y)
    streamed = torch.cat(ys, -1).numpy()
    assert snr_db(one.numpy().astype(np.float64), streamed) >= \
        VS_KERNEL_DB[mode]
    golden = ss.lfilter(taps, [1.0], x.numpy().astype(np.float64), axis=-1)
    assert snr_db(golden, streamed) >= VS_SCIPY_DB[mode]


def test_cuda_envelope_takes_any_row_count():
    for rows in (1, 3, 7, 12, 469, bf.MAX_ROWS, bf.MAX_ROWS + 1, 131071):
        assert bf.cuda_supports(rows, 1024, 1024, 480000)
    assert not bf.cuda_supports(0, 1024, 1024, 100)
    assert not bf.cuda_supports(1, 1024, 1024, 0)
    assert bf.cuda_supports(1, 2049, 2048, 10)
    assert not bf.cuda_supports(8, 2050, pfir.block2_block(2050), 10)
    assert not bf.cuda_supports(8, 129, 192, 10)

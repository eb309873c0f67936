"""The tensor-core FIR tile of kernel B1 (``csrc/fir_mma.cuh``), emulated in
numpy: an overlapping 8-wide view of the x window times the (kt, 8)
Toeplitz of the taps, ``hi·hi + lo·hi + hi·lo`` in f32, 32 taps to a
partial sum.  The emulation follows the kernel's sum order as far as the
contract needs: by 16-row chunk of k, two chunks to a partial sum, so an
output's sum depends on the tap index and on its index mod 8.

Held against the port's plain versions, the JAX package's Pallas kernel in
interpret mode and its W tables; and the contract that keeps streamed
output equal to one shot is pinned: windows whose origins are multiples of
8 of the stream index give bit-identical y, others do not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llzlab_tpu.kernels import block2_fir as rbf
from llzlab_tpu.kernels import fused_fir_resample as rff
from llzlab_tpu.ops import fir as rfir
from llzlab_tpu.ops import resample as rrs
from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import fused_fir_resample as ff
from tests.conftest import snr_db
from tests.torch_mma_tile import N, VS_KERNEL_HIGH_DB, VS_PLAIN_DB, \
    mma_fir, split as _split, tap_tiles as _tap_tiles

UP, DOWN, K = 3, 4, 8


def _case(ntaps, seed, t=1024):
    rng = np.random.default_rng(seed)
    taps = rfir.firwin(ntaps, 0.2, window="hamming")
    return taps, rng.standard_normal((8, t)).astype(np.float32)


@pytest.mark.parametrize("ntaps", [129, 1024])
def test_tile_matches_block2_plain_at_high(ntaps):
    taps, x = _case(ntaps, 301, t=2048)
    block = rfir.block2_block(ntaps)
    y = mma_fir(x, taps, 0, x.shape[1])
    xpad = torch.from_numpy(np.pad(x, ((0, 0), (block, 0))))
    ref = bf.block2_fir_plain(xpad, taps, block, "high").numpy()
    assert snr_db(ref.astype(np.float64), y) >= VS_PLAIN_DB
    ref64 = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
    assert snr_db(ref64.numpy(), y) >= 75.0  # the bf16x3 floor


def test_tile_and_dense_stage2_match_fused_plain_and_pallas_kernel():
    """Stage 1 by the tile, stage 2 as the kernel's dense slab product in
    bf16x3: against the port's plain version and the JAX kernel."""
    ntaps = 129
    taps, _ = _case(ntaps, 302)
    rtaps = rrs.resample_taps(UP, DOWN, K)
    rng = np.random.default_rng(303)
    p = rff.fused_program_in(ntaps, UP, DOWN)
    x = rng.standard_normal((8, 2 * p)).astype(np.float32)
    zi = rng.standard_normal((8, rff.fused_state_len(ntaps))).astype(
        np.float32)
    hl = zi.shape[1]
    stream = np.concatenate([zi, x], -1)
    # y for stream indices −64 … (the first group needs y[−(K−1)])
    origin = hl - 64
    count = -(-(x.shape[1] + 64) // N) * N
    y = mma_fir(stream, taps, origin, count)
    r_hi, r_lo = (t.float().numpy() for t in ff.bank_tables(
        rtaps, UP, DOWN, "high", "cpu", torch.bfloat16, dense=True))
    groups = x.shape[1] // DOWN
    first = 64 - (K - 1)
    slab = np.lib.stride_tricks.sliding_window_view(
        y[:, first:], DOWN + K - 1, -1)[:, ::DOWN][:, :groups]
    s_hi, s_lo = _split(slab)
    z = (s_hi @ r_hi + s_lo @ r_hi + s_hi @ r_lo).reshape(8, groups * UP)
    plain = ff.fused_fir_resample_plain(
        torch.from_numpy(x), torch.from_numpy(zi), taps, UP, DOWN, rtaps,
        "high").numpy()
    assert z.shape == plain.shape
    assert snr_db(plain.astype(np.float64), z) >= VS_PLAIN_DB
    z_ref = rff.fused_fir_resample_pallas(
        jnp.asarray(x), taps, UP, DOWN, rtaps, zi=jnp.asarray(zi),
        mode="high", interpret=True)
    assert snr_db(np.asarray(z_ref, np.float64), z) >= VS_KERNEL_HIGH_DB


@pytest.mark.parametrize("ntaps", [129, 1024])
def test_aligned_origins_give_bit_identical_y_and_others_do_not(ntaps):
    """Two block grids over one stream.  A block's first y sample,
    ``s0·down − (K−1)``, is no multiple of 8; rounded down to one (as
    ``_window_origin`` does) both grids give the same bits for the same
    stream position, as the kernel's streamed == one-shot contract needs.
    Without the rounding they do not."""
    taps, x = _case(ntaps, 304, t=768)
    down, k = 4, 8
    assert (25 * down) % N and (0 * down - (k - 1)) % N

    def grid(gs, rounded):
        out = {}
        for s0 in range(0, 768 // down, gs):  # blocks of gs output groups
            first = s0 * down - (k - 1)
            o = ff._window_origin(s0, down, k) if rounded else first
            y = mma_fir(x, taps, o, -(-(gs * down + k - 1 + N) // N) * N)
            for i in range(y.shape[1]):
                out.setdefault(o + i, []).append(y[:, i])
        return out

    for rounded in (True, False):
        a, b = grid(25, rounded), grid(64, rounded)
        common = sorted(set(a) & set(b))
        assert len(common) >= 700
        same = all(np.array_equal(u, v) for n in common
                   for u in a[n] for v in b[n])
        assert same == rounded


@pytest.mark.parametrize("s0,down,k", [(0, 160, 64), (25, 160, 64),
                                       (0, 4, 8), (1020, 4, 8), (7, 3, 16)])
def test_window_origin_is_the_first_y_rounded_down_to_8(s0, down, k):
    o = ff._window_origin(s0, down, k)
    first = s0 * down - (k - 1)
    assert o % N == 0 and 0 <= first - o < N


@pytest.mark.parametrize("ntaps", [129, 1024])
def test_tile_entries_bit_equal_reference_w_tables(ntaps):
    """``W[k, c] = taps[c − k + kt − 8]`` is ``_w_matrix`` at width 8: every
    entry equals the entry of the JAX package's matrix for the same tap, in
    f64 and, as bf16 hi/lo, in the JAX kernel's banded tables; the rest is
    zero."""
    taps = rfir.firwin(ntaps, 0.25)
    block = rfir.block2_block(ntaps)
    w = bf.toeplitz_tile(taps)
    kt = bf.mma_rows(ntaps)
    assert w.shape == (kt, N) and kt % 16 == 0 and kt >= ntaps + N - 1
    ref = rbf._w_matrix(taps, block)
    # ref[r, c] = taps[block + c − r]: the same tap at r = block + k − kt + 8
    rows = block + np.arange(kt) - kt + N
    ok = (rows >= 0) & (rows < 2 * block)
    np.testing.assert_array_equal(w[ok], ref[rows[ok], :N])
    assert not w[~ok].any()
    # bf16: tile 0 of the JAX tables holds rows ms … ms + kb of ref
    kb = rbf.band_k(ntaps, block)
    ms = block + 128 - kb
    tr = rows - ms
    inb = (tr >= 0) & (tr < kb)
    for tile, jax_tile in zip(_tap_tiles(taps),
                              rbf.block2_pallas_tables(taps, block, "high")):
        jt = np.asarray(jax_tile[0].astype(jnp.float32))
        np.testing.assert_array_equal(tile[inb], jt[tr[inb], :N])
        assert not tile[~inb].any()
    assert sorted(np.unique(w[w != 0])) == sorted(np.unique(taps[taps != 0]))

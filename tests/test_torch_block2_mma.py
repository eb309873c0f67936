"""Kernels B2 and B4 at "high" on the tensor cores: what their CUDA sources
rest on and a CPU can check.

(a) The Python twins of the launch arithmetic (``block2_fir.mma_plan``,
``halo_fir_fused.tile_plan``) over the envelope: every admitted shape fits a
block's shared memory, every output of every row is computed exactly once,
the tiles that need the halo are the waiters', and the constants agree with
the ``.cu`` files.

(b) The numpy emulation of the tile (``tests/torch_mma_tile.py``) run over
those plans: B2 on a stream split at multiples of the block is
bit-identical to one shot, a split at a non-multiple of 8 is not; B4's
shards, concatenated, are bit-identical to B2 on the unsharded stream;
samples before the history meet zero rows of W only, and must be zeros.

(c) The emulated B2 against the port's plain version and the JAX package's
``_kernel_high`` in interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llzlab_tpu.kernels import block2_fir as rbf
from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import halo_fir_fused as hf
from llzlab_tpu_torch.ops.fir import block2_block, firwin
from tests.conftest import snr_db
from tests.torch_mma_tile import N, VS_KERNEL_HIGH_DB, VS_PLAIN_DB, mma_fir

CSRC = Path(bf.__file__).parent.parent / "csrc"
#: blocks the card holds at once, as read on an H100 (132 SMs x 3 for B2,
#: x 4 for B4 at "high"), a card a tenth of it, and no bound
RESIDENT = [396, 528, 40, None]


# ---- (a) the launch arithmetic ---------------------------------------------

def test_constants_agree_with_the_sources():
    b2 = (CSRC / "block2_fir.cu").read_text()
    b4 = (CSRC / "halo_fir_fused.cu").read_text()
    mma = (CSRC / "fir_mma.cuh").read_text()
    const = lambda text: dict(re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", text))
    assert int(const(b2)["SMEM_MAX"]) == bf.SMEM_MAX == 232448
    assert int(const(b4)["SMEM_MAX"]) == bf.SMEM_MAX
    assert int(const(b2)["MT"]) * 8 * 128 == bf.MMA_PASS
    assert int(const(b4)["MT"]) * 8 * 128 == bf.MMA_PASS
    assert "constexpr int PASS = FIR_MMA_WARPS * MT * FIR_MMA_TILE;" in b2
    assert "constexpr int PASS = FIR_MMA_WARPS * MT * FIR_MMA_TILE;" in b4
    assert int(const(mma)["FIR_MMA_WARPS"]) == 8
    assert int(const(mma)["FIR_MMA_TILE"]) == 128
    assert int(const(mma)["FIR_MMA_N"]) == N
    assert "constexpr int WRUN = THREADS * 4;" in b4
    assert int(const(b4)["THREADS"]) * 4 == hf.WRUN
    for name in ("MAX_SEND", "MAX_CARD_RANKS"):
        assert int(const(b4)[name]) == getattr(hf, name)
    assert int(const(b4)["MAX_WAIT"]) == hf.MAX_WAIT["highest"]
    assert int(const(b4)["MAX_WAIT_HIGH"]) == hf.MAX_WAIT["high"]
    # no fmaf emulation of the three bf16 passes is left
    tile = (CSRC / "fir_tile.cuh").read_text()
    assert "HIGH" not in tile and "bf16" not in tile.replace("bf16 passes", "")


def test_every_admitted_shape_fits_a_blocks_shared_memory():
    """``block <= 2048`` admits 2049 taps: W alone is 66 KB there."""
    worst = 0
    for ntaps in range(2, 2050):
        block = block2_block(ntaps)
        assert bf.supports(8, ntaps, block)
        kt = bf.mma_rows(ntaps)
        # fir_mma_smem_bytes: W hi, lo (8, kt + 8) and the window hi, lo
        assert bf.mma_smem_bytes(ntaps) == 2 * (
            2 * 8 * (kt + 8) + 2 * (bf.MMA_PASS + kt - 8))
        for mode in bf.MODES:
            plan = hf.tile_plan(256, 2 * block, block, ntaps, mode)
            worst = max(worst, plan["smem_bytes"], bf.mma_smem_bytes(ntaps))
    assert worst == bf.mma_smem_bytes(2049) == 90912 <= bf.SMEM_MAX
    assert not bf.supports(8, 2050, block2_block(2050))


def test_waiters_of_a_card_can_never_fill_it():
    """The launch refuses a card that holds no more blocks than the waiters
    of all other shards on it; an H100 holds 528 ("high") or 1056."""
    assert (hf.MAX_CARD_RANKS - 1) * hf.MAX_WAIT["high"] < 4 * 132
    assert (hf.MAX_CARD_RANKS - 1) * hf.MAX_WAIT["highest"] < 8 * 132


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("ntaps,t,batch", [
    (1024, 245760, 64), (1024, 3 * 4096, 8), (1024, 4096 + 1391, 8),
    (129, 777, 8), (2049, 5 * 2048 + 1, 16), (1025, 4096, 8), (2, 1, 8)])
def test_block2_plan_computes_every_output_once(ntaps, t, batch, resident):
    plan = bf.mma_plan(ntaps, t, batch, resident)
    kt = plan["kt"]
    assert kt % 16 == 0 and kt - 8 >= ntaps - 1   # every tap has its sample
    assert plan["window"] == plan["run"] + kt - 8
    assert plan["window"] % 8 == 0                # 16-byte rows for ldmatrix
    assert 1 <= plan["grid"] <= (resident or plan["units"])
    seen = np.zeros((batch, t), np.int32)
    for i in range(plan["grid"]):
        for row, n0 in bf.mma_units(plan, i):
            assert n0 % plan["run"] == 0 and n0 % N == 0 and n0 < t
            seen[row, n0:min(n0 + plan["run"], t)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("mode", bf.MODES)
@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("c,t_loc,ntaps", [
    (256, 327680, 1024), (8, 2048, 1024), (5, 5 * 1536, 1500),
    (24, 256, 129), (1, 2 * 128, 2), (256, 2 * 2048, 2049), (3, 9 * 1024, 1000)])
def test_halo_fused_plan_computes_every_output_once(c, t_loc, ntaps, mode,
                                                    resident):
    block = block2_block(ntaps)
    assert hf.halo_fused_supports(c, ntaps, t_loc)
    plan = hf.tile_plan(c, t_loc, block, ntaps, mode, resident)
    assert 1 <= plan["nwait"] <= hf.MAX_WAIT[mode]
    assert 1 <= plan["nsend"] <= min(plan["grid"], hf.MAX_SEND)
    assert plan["head"] >= min(block, t_loc)      # y-block 0 is the waiters'
    if mode == "high" and resident is not None:
        assert plan["grid"] <= resident
    seen = np.zeros((c, t_loc), np.int32)
    for i in range(plan["grid"]):
        waits = i >= plan["n_int_blocks"]
        for row, n0, width, tile_waits in hf.plan_tiles(plan, c, i):
            assert tile_waits == waits and n0 % N == 0 and n0 < t_loc
            # a tile reads back to n0 − (ntaps − 1): below 0 it needs the halo
            assert waits or n0 >= block >= ntaps - 1
            assert waits == (n0 < plan["head"])
            seen[row, n0:min(n0 + width, t_loc)] += 1
    assert (seen == 1).all()
    # the waiters' tiles are narrow: no more than y-block 0 rounded up
    assert plan["head"] - block < hf.WRUN


# ---- (b) the emulated tile over the plans ----------------------------------

def b2_emulated(xpad, taps, block):
    """Kernel B2 at "high" on ``xpad (C, block + T)``: the passes of
    ``mma_plan``, each from a window whose first output is ``xpad[block +
    n0]`` and whose samples outside the row are zeros."""
    t = xpad.shape[1] - block
    plan = bf.mma_plan(len(taps), t, xpad.shape[0])
    y = np.empty((xpad.shape[0], t), np.float32)
    for n0 in range(0, t, plan["run"]):           # every row walks them alike
        y[:, n0:n0 + plan["run"]] = mma_fir(
            xpad, taps, block + n0, plan["run"])[:, :t - n0]
    return y


def b4_emulated(parts, carry, taps, block, h, resident):
    """Kernel B4 at "high": each shard's tiles by ``tile_plan``; a waiter's
    window reads the ``h`` samples before the shard from its left neighbour
    (shard 0: the carry, or zeros) and zeros further back, an interior
    tile's window zeros before the shard."""
    out = []
    for r, x in enumerate(parts):
        c, t = x.shape
        halo = (parts[r - 1][:, -h:] if r else
                carry if carry is not None else np.zeros((c, h), np.float32))
        with_halo = np.concatenate([halo, x], axis=1)
        plan = hf.tile_plan(c, t, block, len(taps), "high", resident)
        y = np.full((c, t), np.nan, np.float32)
        for i in range(plan["grid"]):
            for row, n0, width, waits in hf.plan_tiles(plan, c, i):
                got = (mma_fir(with_halo[row:row + 1], taps, h + n0, width)
                       if waits else mma_fir(x[row:row + 1], taps, n0, width))
                y[row, n0:n0 + width] = got[0, :t - n0]
        out.append(y)
    return np.concatenate(out, axis=1)


def _stream(ntaps, nblk, seed, c=8):
    rng = np.random.default_rng(seed)
    block = block2_block(ntaps)
    x = rng.standard_normal((c, block + nblk * block)).astype(np.float32)
    return firwin(ntaps, 0.2), block, x


@pytest.mark.parametrize("ntaps,nblk", [(129, 70), (1024, 9)])
def test_block2_split_at_block_multiples_is_bit_identical(ntaps, nblk):
    """70 blocks of 128 are more than two 4096-output passes, so the later
    call's passes start elsewhere in the stream than the one shot's."""
    taps, block, xpad = _stream(ntaps, nblk, 401)
    one = b2_emulated(xpad, taps, block)
    for cut in (block, (nblk // 2) * block, (nblk - 1) * block):
        ya = b2_emulated(xpad[:, :block + cut], taps, block)
        yb = b2_emulated(xpad[:, cut:], taps, block)
        np.testing.assert_array_equal(np.concatenate([ya, yb], 1), one)


@pytest.mark.parametrize("shift", [1, 4, 7])
def test_block2_split_at_a_non_multiple_of_8_is_not(shift):
    taps, block, xpad = _stream(129, 6, 402)
    one = b2_emulated(xpad, taps, block)
    cut = 3 * block + shift
    yb = b2_emulated(xpad[:, cut:], taps, block)
    assert yb.shape == one[:, cut:].shape
    assert not np.array_equal(yb, one[:, cut:])
    assert snr_db(one[:, cut:].astype(np.float64), yb) >= 120.0  # order only
    cut = 3 * block + 8                                # a multiple of 8 is
    np.testing.assert_array_equal(
        b2_emulated(xpad[:, cut:], taps, block), one[:, cut:])


@pytest.mark.parametrize("resident", [40, None])
@pytest.mark.parametrize("h_is_block", [False, True])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("ntaps,nblk", [(129, 9), (1000, 2)])
def test_halo_fused_shards_are_bit_identical_to_block2_unsharded(
        ntaps, nblk, n, h_is_block, resident):
    taps = firwin(ntaps, 0.3)
    block = block2_block(ntaps)
    h = block if h_is_block else ntaps - 1
    rng = np.random.default_rng(403)
    c, t_loc = 2, nblk * block
    x = rng.standard_normal((c, n * t_loc)).astype(np.float32)
    parts = [x[:, r * t_loc:(r + 1) * t_loc] for r in range(n)]
    for carry in (None, rng.standard_normal((c, h)).astype(np.float32)):
        lead = np.zeros((c, block), np.float32)
        if carry is not None:
            lead[:, block - h:] = carry
        whole = b2_emulated(np.concatenate([lead, x], 1), taps, block)
        got = b4_emulated(parts, carry, taps, block, h, resident)
        np.testing.assert_array_equal(got, whole)


def test_samples_before_the_history_meet_zero_rows_and_must_be_zeros():
    """At 1024 taps the window reaches kt − 8 = 1032 samples back, 8 more
    than the history block.  Whatever finite value lies there changes no
    bit, a NaN there spoils the outputs: the kernels load zeros."""
    taps, block, xpad = _stream(1024, 1, 404, c=1)
    assert bf.mma_rows(1024) - 8 == block + 8
    y = mma_fir(xpad, taps, block, 256)             # zeros before the row
    for junk, same in ((3.0e38, True), (np.nan, False)):
        before = np.full((1, 16), junk, np.float32)
        got = mma_fir(np.concatenate([before, xpad], 1), taps, 16 + block, 256)
        assert np.array_equal(got, y) == same
    assert np.isfinite(y).all()


# ---- (c) the emulated kernel against the plain and the JAX versions --------

@pytest.mark.parametrize("ntaps,nblk", [(129, 40), (256, 5), (1024, 5)])
def test_emulated_block2_matches_plain_and_pallas_kernel_at_high(ntaps, nblk):
    taps, block, xpad = _stream(ntaps, nblk, 405)
    xpad = xpad[:, :-37]                              # a ragged t
    y = b2_emulated(xpad, taps, block)
    plain = bf.block2_fir_plain(torch.from_numpy(xpad), taps, block, "high")
    assert y.shape == tuple(plain.shape)
    assert snr_db(plain.numpy().astype(np.float64), y) >= VS_PLAIN_DB
    ref = np.asarray(rbf.block2_fir_pallas(
        jnp.asarray(xpad), taps, block, mode="high", interpret=True))
    assert snr_db(ref.astype(np.float64), y) >= VS_KERNEL_HIGH_DB
    ref64 = bf.block2_fir_plain(torch.from_numpy(xpad).double(), taps, block,
                                "highest")
    assert snr_db(ref64.numpy(), y) >= 75.0           # the bf16x3 floor

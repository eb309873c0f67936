"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  This file imports no
JAX, so on a machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import fused_fir_resample as ff
from llzlab_tpu_torch.ops.fir import block2_block, firwin
from llzlab_tpu_torch.ops.resample import resample_taps

NTAPS, UP, DOWN, K = 129, 3, 4, 8
#: kernel vs its plain version run in float64 (the floors of chip_smoke.py):
#: f32 sum order at "highest", the bf16x3 error at "high"
FLOOR_DB = {"highest": 130.0, "high": 75.0}


def _snr_db(ref, y):
    ref = ref.double().cpu().numpy()
    err = ref - y.double().cpu().numpy()
    return 10.0 * np.log10(np.sum(ref * ref) / np.sum(err * err))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
def test_kernels_match_plain_versions(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(41)
    taps = firwin(NTAPS, 0.2)
    rtaps = resample_taps(UP, DOWN, K)
    block = block2_block(NTAPS)
    t = 3 * ff.fused_program_in(NTAPS, UP, DOWN)
    x = torch.from_numpy(rng.standard_normal((8, t)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal(
        (8, 2 * block)).astype(np.float32))
    x, hist = x.cuda(), hist.cuda()
    xpad = torch.cat([hist[:, :block], x], -1).contiguous()

    n = bf.block2_fir_cuda.launches
    y = bf.block2_fir(xpad, taps, block, mode=mode)
    assert bf.block2_fir_cuda.launches == n + 1
    ref = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
    assert _snr_db(ref, y) >= FLOOR_DB[mode]

    n = ff.fused_fir_resample_cuda.launches
    z = ff.fused_fir_resample(x, taps, UP, DOWN, rtaps, zi=hist, mode=mode)
    assert ff.fused_fir_resample_cuda.launches == n + 1
    ref = ff.fused_fir_resample_plain(x.double(), hist.double(), taps, UP,
                                      DOWN, rtaps, "highest")
    assert z.shape == ref.shape
    assert _snr_db(ref, z) >= FLOOR_DB[mode]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
def test_fused_kernel_streamed_equals_one_shot_bitwise(mode):
    """Three programs as one call, as 1 + 2 and as 2 + 1: the calls' block
    grids differ, the outputs must not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(44)
    args = (firwin(NTAPS, 0.2), UP, DOWN, resample_taps(UP, DOWN, K))
    p = ff.fused_program_in(NTAPS, UP, DOWN)
    x = torch.from_numpy(
        rng.standard_normal((8, 3 * p)).astype(np.float32)).cuda()
    zi = torch.from_numpy(rng.standard_normal(
        (8, ff.fused_state_len(NTAPS))).astype(np.float32)).cuda()
    one = ff.fused_fir_resample(x, *args, zi=zi, mode=mode)
    for cut in (p, 2 * p):
        za, zf = ff.fused_fir_resample(x[:, :cut].contiguous(), *args, zi=zi,
                                       return_zf=True, mode=mode)
        zb = ff.fused_fir_resample(x[:, cut:].contiguous(), *args, zi=zf,
                                   mode=mode)
        assert torch.equal(torch.cat([za, zb], -1), one)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
@pytest.mark.parametrize("ntaps,up,down,k", [
    (256, 4, 3, 8),     # upsampling, odd down
    (513, 2, 3, 16),    # odd ntaps, odd down
    (129, 3, 4, 100),   # long phases: K − 1 near the block
    (64, 5, 7, 12),     # short filter, odd ratio
    (129, 1, 2, 32),    # one phase
    (2000, 3, 4, 8),    # the longest block
    (129, 7, 50, 16),   # down not a multiple of 4 nor of 8, few groups
])
def test_fused_kernel_over_the_envelope(ntaps, up, down, k, mode):
    """Kernel B1 against its plain version in f64 and, streamed in two
    calls, against itself, at shapes that reach every branch of its
    geometry (group stride, padded phases and taps, several slab runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(45)
    args = (firwin(ntaps, 0.2), up, down, resample_taps(up, down, k))
    p = ff.fused_program_in(ntaps, up, down)
    assert ff.fused_supports(8, ntaps, up, down, k, 2 * p)
    x = torch.from_numpy(
        rng.standard_normal((8, 2 * p)).astype(np.float32)).cuda()
    zi = torch.from_numpy(rng.standard_normal(
        (8, ff.fused_state_len(ntaps))).astype(np.float32)).cuda()
    z = ff.fused_fir_resample(x, *args, zi=zi, mode=mode)
    ref = ff.fused_fir_resample_plain(x.double(), zi.double(), *args,
                                      "highest")
    assert z.shape == ref.shape and bool(torch.isfinite(z).all())
    assert _snr_db(ref, z) >= FLOOR_DB[mode]
    za, zf = ff.fused_fir_resample(x[:, :p].contiguous(), *args, zi=zi,
                                   return_zf=True, mode=mode)
    zb = ff.fused_fir_resample(x[:, p:].contiguous(), *args, zi=zf,
                               mode=mode)
    assert torch.equal(torch.cat([za, zb], -1), z)


#: shapes of the wgmma path: the headline and the channelizer (3 phase
#: tiles), 507 groups a unit (8 group blocks in "high"'s stage 2), odd ntaps
#: with one phase tile, a shared factor (runs as 1/16 with K = 32), and the
#: longest filter that fits the path at each precision
WGMMA_CASES = [(1024, 147, 160, 64), (129, 3, 16, 8), (513, 5, 48, 16),
               (513, 2, 32, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps,up,down,k,mode",
                         [c + ("high",) for c in WGMMA_CASES]
                         + [(2000, 3, 16, 8, "high")]
                         + [c + ("highest",) for c in WGMMA_CASES]
                         + [(1777, 3, 16, 8, "highest")])
def test_wgmma_path_matches_plain_and_streams_bitwise(ntaps, up, down, k,
                                                      mode):
    """B1 on the wgmma path against its plain version in f64 (the 80 dB
    floor at "high", the kernel floor ``FLOOR_DB["highest"]`` at
    "highest", six bf16 passes) at the ratio the wrapper runs, ``up / down``
    in lowest terms, and, streamed over a program boundary, against itself;
    each call one launch, counted as a wgmma launch (and at "highest" as a
    ``wgmma_highest`` one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rtaps = resample_taps(up, down, k)
    g = math.gcd(up, down)
    u, d = up // g, down // g
    assert ff.wgmma_fits(ntaps, u, d, len(rtaps) // u, mode)
    rng = np.random.default_rng(47)
    args = (firwin(ntaps, 0.2), up, down, rtaps)
    p = ff.fused_program_in(ntaps, u, d)
    x = torch.from_numpy(
        rng.standard_normal((8, 2 * p)).astype(np.float32)).cuda()
    zi = torch.from_numpy(rng.standard_normal(
        (8, ff.fused_state_len(ntaps))).astype(np.float32)).cuda()
    n = ff.fused_fir_resample_cuda.launches
    w = ff.fused_fir_resample_cuda.wgmma_launches
    wh = ff.fused_fir_resample_cuda.wgmma_highest_launches
    z = ff.fused_fir_resample(x, *args, zi=zi, mode=mode)
    assert ff.fused_fir_resample_cuda.launches == n + 1
    assert ff.fused_fir_resample_cuda.wgmma_launches == w + 1
    assert ff.fused_fir_resample_cuda.wgmma_highest_launches == wh + int(
        mode == "highest")
    ref = ff.fused_fir_resample_plain(x.double(), zi.double(), args[0], u,
                                      d, rtaps, "highest")
    assert z.shape == ref.shape and bool(torch.isfinite(z).all())
    assert _snr_db(ref, z) >= max(80.0, FLOOR_DB[mode])
    za, zf = ff.fused_fir_resample(x[:, :p].contiguous(), *args, zi=zi,
                                   return_zf=True, mode=mode)
    zb = ff.fused_fir_resample(x[:, p:].contiguous(), *args, zi=zf,
                               mode=mode)
    assert torch.equal(torch.cat([za, zb], -1), z)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
@pytest.mark.parametrize("ntaps,up,down,k,wgmma", [
    (513, 2, 48, 16, 0),  # runs as 1/24 with K = 32: down 24, mma.sync
    (129, 2, 32, 8, 1),   # runs as 1/16 with K = 16: wgmma
])
def test_fused_kernel_runs_a_shared_factor_in_lowest_terms(ntaps, up, down,
                                                           k, wgmma, mode):
    """As in the JAX package, the wrapper divides ``up`` and ``down`` by
    their gcd and reads the resampler's taps as the reduced bank, ``K·g``
    taps a phase, so B1 on the card equals its plain version at that ratio
    (the plain version at ``up / down`` itself is another filter: about
    -3 dB from the wrapper's output); the path is that of the reduced
    shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    g = math.gcd(up, down)
    u, d = up // g, down // g
    rtaps = resample_taps(up, down, k)
    assert g > 1 and ff.wgmma_fits(ntaps, up, down, k, mode)
    assert ff.wgmma_fits(ntaps, u, d, len(rtaps) // u, mode) == bool(wgmma)
    rng = np.random.default_rng(50)
    taps = firwin(ntaps, 0.2)
    x = torch.from_numpy(rng.standard_normal(
        (8, 2 * ff.fused_program_in(ntaps, u, d))).astype(np.float32)).cuda()
    zi = torch.from_numpy(rng.standard_normal(
        (8, ff.fused_state_len(ntaps))).astype(np.float32)).cuda()
    w = ff.fused_fir_resample_cuda.wgmma_launches
    z = ff.fused_fir_resample(x, taps, up, down, rtaps, zi=zi, mode=mode)
    assert ff.fused_fir_resample_cuda.wgmma_launches == w + wgmma
    ref = ff.fused_fir_resample_plain(x.double(), zi.double(), taps, u, d,
                                      rtaps, "highest")
    assert z.shape == ref.shape
    assert _snr_db(ref, z) >= FLOOR_DB[mode]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
def test_wgmma_path_loads_unaligned_inputs_itself(mode):
    """x and hist 4 bytes past a 16-byte boundary (contiguous views into
    larger buffers) cannot be bulk-copied: the producer warp loads them
    itself, and the output is bitwise that of aligned copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    ntaps, up, down, k = 129, 3, 16, 8
    args = (firwin(ntaps, 0.2), up, down, resample_taps(up, down, k))
    t = 2 * ff.fused_program_in(ntaps, up, down)
    hl = ff.fused_state_len(ntaps)
    gen = torch.Generator("cuda").manual_seed(49)
    x = torch.randn(8 * t + 1, device="cuda", generator=gen)[1:].view(8, t)
    hist = torch.randn(8 * hl + 1, device="cuda",
                       generator=gen)[1:].view(8, hl)
    assert x.data_ptr() % 16 and hist.data_ptr() % 16
    w = ff.fused_fir_resample_cuda.wgmma_launches
    z = ff.fused_fir_resample_cuda(x, hist, *args, mode)
    ref = ff.fused_fir_resample_cuda(x.clone(), hist.clone(), *args, mode)
    assert ff.fused_fir_resample_cuda.wgmma_launches == w + 2
    assert torch.equal(z, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps,mode,wgmma", [
    (1024, "high", 1),     # the headline: the wgmma path
    (2000, "high", 0),     # its tap tables outgrow shared memory: mma.sync
    (1024, "highest", 1),  # the six-pass wgmma path
    (1536, "highest", 0),  # three parts outgrow shared memory: fp32 FMA
])
def test_wgmma_launches_count_the_path_by_shape(ntaps, mode, wgmma):
    """``wgmma_launches`` counts one launch a call where the shape takes the
    wgmma path and none elsewhere, ``wgmma_highest_launches`` those at
    "highest"; ``launches`` counts every call.  The fallbacks hold their
    floors too (80 dB at 2000 taps, the kernel floor at "highest")."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    up, down, k = 147, 160, 64
    assert ff.wgmma_fits(ntaps, up, down, k, mode) == bool(wgmma)
    rng = np.random.default_rng(48)
    args = (firwin(ntaps, 0.2), up, down, resample_taps(up, down, k))
    x = torch.from_numpy(rng.standard_normal(
        (8, ff.fused_program_in(ntaps, up, down))).astype(np.float32)).cuda()
    n = ff.fused_fir_resample_cuda.launches
    w = ff.fused_fir_resample_cuda.wgmma_launches
    wh = ff.fused_fir_resample_cuda.wgmma_highest_launches
    for _ in range(2):
        z = ff.fused_fir_resample(x, *args, mode=mode)
    assert ff.fused_fir_resample_cuda.launches == n + 2
    assert ff.fused_fir_resample_cuda.wgmma_launches == w + 2 * wgmma
    assert ff.fused_fir_resample_cuda.wgmma_highest_launches == wh + 2 * (
        wgmma and mode == "highest")
    ref = ff.fused_fir_resample_plain(
        x.double(), torch.zeros((8, ff.fused_state_len(ntaps)),
                                dtype=torch.float64, device="cuda"),
        *args, "highest")
    assert _snr_db(ref, z) >= max(80.0, FLOOR_DB[mode])


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [8, 64])
@pytest.mark.parametrize("ntaps", [129, 1024, 1025, 2049])
def test_block2_high_over_the_envelope(ntaps, channels):
    """Kernel B2 at "high" (tensor cores) against the plain version in f64:
    ``t`` a multiple of the 4096-output pass, ragged (odd, so rows are not
    8-byte aligned and ``xpad`` rows are no multiple of 4 long), and shorter
    than one pass; the history block holds NaN-free random samples."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(46)
    taps = firwin(ntaps, 0.2)
    block = block2_block(ntaps)
    assert bf.supports(channels, ntaps, block)
    assert bf.blocks_per_sm(ntaps) >= 1
    for t in (2 * bf.MMA_PASS, bf.MMA_PASS + 1391, 777):
        xpad = torch.from_numpy(rng.standard_normal(
            (channels, block + t)).astype(np.float32)).cuda()
        n = bf.block2_fir_cuda.launches
        y = bf.block2_fir(xpad, taps, block, mode="high")
        assert bf.block2_fir_cuda.launches == n + 1
        ref = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
        assert y.shape == ref.shape and bool(torch.isfinite(y).all())
        assert _snr_db(ref, y) >= FLOOR_DB["high"]
        # every row, and the last outputs of the ragged edge, one by one
        for row in (0, channels - 1):
            assert _snr_db(ref[row], y[row]) >= FLOOR_DB["high"]
        assert _snr_db(ref[:, -8:], y[:, -8:]) >= FLOOR_DB["high"] - 15.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
@pytest.mark.parametrize("ntaps", [129, 1024])
def test_block2_streamed_equals_one_shot_bitwise(ntaps, mode):
    """Three stretches of blocks as one call, as 1 + 2 and as 2 + 1, each
    call with the block before it as history: bitwise the one-shot output
    (the cuts are multiples of ``block``, so of 8).  At "high" a cut that is
    no multiple of 8 is outside the contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(47)
    taps = firwin(ntaps, 0.2)
    block = block2_block(ntaps)
    part = 5 * block  # no multiple of the 4096-output pass at 1024 taps
    xpad = torch.from_numpy(rng.standard_normal(
        (8, block + 3 * part)).astype(np.float32)).cuda()
    one = bf.block2_fir_cuda(xpad, taps, block, mode)
    for cut in (part, 2 * part):
        ya = bf.block2_fir_cuda(xpad[:, :block + cut].contiguous(), taps,
                                block, mode)
        yb = bf.block2_fir_cuda(xpad[:, cut:].contiguous(), taps, block, mode)
        assert torch.equal(torch.cat([ya, yb], -1), one)


def _time_mesh(n):
    from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh

    return DspMesh(["cuda"] * n, (TIME_AXIS,))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [7, 63, 128])
@pytest.mark.parametrize("with_carry", [False, True])
def test_halo_ring_kernel_matches_plain_version(h, with_carry):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_ring as hr

    rng = np.random.default_rng(42)
    mesh = _time_mesh(4)
    # rows strided (a column slice of a wider tensor): tails start at any
    # 4-byte alignment
    wide = torch.from_numpy(
        rng.standard_normal((4, 24, 300)).astype(np.float32)).cuda()
    parts = [wide[r, :, 3:259] for r in range(4)]
    carry = (torch.from_numpy(rng.standard_normal((24, h)).astype(np.float32))
             .cuda() if with_carry else None)
    n = hr.left_halo_ring_cuda.launches
    for _ in range(3):
        mesh.fork()
        got = hr.left_halo_ring(parts, h, mesh, first_shard_value=carry)
        mesh.join()
    # one launch per exchange: the four ranks share the card
    assert hr.left_halo_ring_cuda.launches == n + 3
    hr.check_exchanges(mesh)
    plain = hr.left_halo_ring_plain(parts, h, mesh, first_shard_value=carry)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.shape == (24, h) and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [7, 63, 128])
def test_halo_ring_protocol_branch_on_one_card(h):
    """Each rank launched alone on its own stream: every edge runs the send
    / wait protocol of the cross-card branch (one launch a rank), bitwise
    the plain version over three epochs; a sender held back within the
    wait limit is waited for."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_ring as hr

    rng = np.random.default_rng(45)
    mesh = _time_mesh(4)
    x = torch.from_numpy(
        rng.standard_normal((24, 4 * 256)).astype(np.float32)).cuda()
    parts = [x[:, r * 256:(r + 1) * 256] for r in range(4)]
    carry = torch.from_numpy(
        rng.standard_normal((24, h)).astype(np.float32)).cuda()
    plain = hr.left_halo_ring_plain(parts, h, mesh, first_shard_value=carry)
    n, cross = hr.left_halo_ring_cuda.launches, \
        hr.left_halo_ring_cuda.cross_card_launches
    for epoch in range(3):
        if epoch == 2:
            with mesh.on(0):
                torch.cuda._sleep(int(2e8))  # rank 0 sends late
        mesh.fork()
        got = hr.left_halo_ring_cuda(parts, h, mesh, first_shard_value=carry,
                                     _per_rank=True)
        mesh.join()
        hr.check_exchanges(mesh)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    assert hr.left_halo_ring_cuda.launches == n + 3 * 4
    assert hr.left_halo_ring_cuda.cross_card_launches == cross  # one card


@pytest.mark.cuda
@pytest.mark.parametrize("h", [7, 63, 128])
def test_halo_ring_net_branch_on_one_card(h):
    """Every edge a ``NET`` edge (``_net=True``: the tails through a
    device copy on each receiving rank's transfer stream, the epoch
    published by a one-thread kernel, the kernel's receive half alone):
    one launch a rank, each across a ``NET`` edge, bitwise the normal
    launch and the plain version over three epochs, rank 0's stream held
    back in the last."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_ring as hr

    rng = np.random.default_rng(46)
    mesh = _time_mesh(4)
    wide = torch.from_numpy(
        rng.standard_normal((4, 24, 300)).astype(np.float32)).cuda()
    parts = [wide[r, :, 3:259] for r in range(4)]  # strided rows
    carry = torch.from_numpy(
        rng.standard_normal((24, h)).astype(np.float32)).cuda()
    plain = hr.left_halo_ring_plain(parts, h, mesh, first_shard_value=carry)
    n, net = hr.left_halo_ring_cuda.launches, \
        hr.left_halo_ring_cuda.cross_host_launches
    for epoch in range(3):
        if epoch == 2:
            with mesh.on(0):
                torch.cuda._sleep(int(2e8))
        mesh.fork()
        got = hr.left_halo_ring_cuda(parts, h, mesh, first_shard_value=carry,
                                     _net=True)
        normal = hr.left_halo_ring_cuda(parts, h, mesh,
                                        first_shard_value=carry)
        mesh.join()
        hr.check_exchanges(mesh)
        for a, b, c in zip(got, normal, plain):
            assert torch.equal(a, c) and torch.equal(b, c)
    assert hr.left_halo_ring_cuda.launches == n + 3 * (4 + 1)
    assert hr.left_halo_ring_cuda.cross_host_launches == net + 3 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
def test_halo_fir_fused_net_branch_on_one_card(mode):
    """B4 with every edge a ``NET`` edge: its senders store nothing, its
    waiters wait for the flag of the transfer stream; bitwise the normal
    launch over three epochs (no carry, then a block of carry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr

    rng = np.random.default_rng(47)
    taps = firwin(1024, 0.3)
    block = block2_block(1024)
    mesh = _time_mesh(4)
    x = torch.from_numpy(
        rng.standard_normal((16, 4 * 3 * block)).astype(np.float32)).cuda()
    parts = list(x.reshape(16, 4, 3 * block).permute(1, 0, 2).contiguous())
    carry = None
    net = hf.block2_fir_halo_fused_cuda.cross_host_launches
    for _ in range(3):
        mesh.fork()
        got = hf.block2_fir_halo_fused_cuda(
            parts, taps, mesh, first_shard_value=carry, mode=mode, _net=True)
        normal = hf.block2_fir_halo_fused_cuda(
            parts, taps, mesh, first_shard_value=carry, mode=mode)
        mesh.join()
        hr.check_exchanges(mesh)
        for a, b in zip(got, normal):
            assert torch.equal(a, b)
        carry = parts[-1][:, -block:].contiguous()
    assert hf.block2_fir_halo_fused_cuda.cross_host_launches == net + 3 * 4


@pytest.mark.cuda
def test_halo_ring_protocol_receive_that_times_out_raises(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_ring as hr

    mesh = _time_mesh(2)
    x = torch.randn((8, 512), device="cuda")
    parts = [x[:, :256], x[:, 256:]]
    hr.left_halo_ring_cuda(parts, 63, mesh, _per_rank=True)
    hr.check_exchanges(mesh)
    monkeypatch.setattr(hr, "WAIT_LIMIT_S", 0.1)
    with mesh.on(0):
        torch.cuda._sleep(int(2e9))  # about a second late
    hr.left_halo_ring_cuda(parts, 63, mesh, _per_rank=True)
    with pytest.raises(RuntimeError, match="never arrived"):
        hr.check_exchanges(mesh)
    got = hr.left_halo_ring_cuda(parts, 63, mesh, _per_rank=True)
    hr.check_exchanges(mesh)  # and the exchange works again
    assert torch.equal(got[1], parts[0][:, -63:])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("ntaps,c", [(256, 8), (1024, 24), (1500, 5)])
def test_halo_fir_fused_kernel_matches_plain_and_unsharded_kernel(
        ntaps, c, n, mode):
    """Three epochs over one mesh: no carry, a carry of ``ntaps − 1``
    samples, a carry of a whole block.  The shards, concatenated, are
    bitwise kernel B2 on the unsharded stream, in both modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr

    rng = np.random.default_rng(43)
    taps = firwin(ntaps, 0.3)
    block = block2_block(ntaps)
    t_loc = 5 * block
    mesh = _time_mesh(n)
    per_sm = hf.blocks_per_sm(ntaps, mode)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert per_sm * sms > (hf.MAX_CARD_RANKS - 1) * hf.MAX_WAIT[mode]
    x = torch.from_numpy(
        rng.standard_normal((c, n * t_loc)).astype(np.float32)).cuda()
    parts = [x[:, r * t_loc:(r + 1) * t_loc].contiguous() for r in range(n)]
    for h in (None, ntaps - 1, block):
        carry = None if h is None else torch.from_numpy(
            rng.standard_normal((c, h)).astype(np.float32)).cuda()
        mesh.fork()
        got = hf.block2_fir_halo_fused(parts, taps, mesh,
                                       first_shard_value=carry, mode=mode)
        mesh.join()
        hr.check_exchanges(mesh)
        lead = torch.zeros((c, block), device="cuda")
        if carry is not None:
            lead[:, block - h:] = carry
        xpad = torch.cat([lead, x], -1)
        ref = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
        if c % 8 == 0:  # kernel B2's envelope
            whole = bf.block2_fir_cuda(xpad, taps, block, mode)
            assert torch.equal(torch.cat(got, -1), whole)
        assert _snr_db(ref, torch.cat(got, -1)) >= FLOOR_DB[mode]
        plain = hf.block2_fir_halo_fused_plain(
            parts, taps, mesh, first_shard_value=carry, mode=mode)
        assert _snr_db(ref, torch.cat(plain, -1)) >= FLOOR_DB[mode]


@pytest.mark.cuda
def test_empty_halo_launches_no_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_ring as hr

    mesh = _time_mesh(2)
    parts = [torch.zeros((8, 64), device="cuda") for _ in range(2)]
    n = hr.left_halo_ring_cuda.launches
    got = hr.left_halo_ring(parts, 0, mesh)
    assert [tuple(g.shape) for g in got] == [(8, 0), (8, 0)]
    assert hr.left_halo_ring_cuda.launches == n


@pytest.mark.cuda
def test_halo_ring_with_a_rank_held_back_is_right_by_stream_order():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_ring as hr

    mesh = _time_mesh(2)
    parts = [torch.randn((8, 256), device="cuda") for _ in range(2)]
    want = parts[0][:, -63:] + 1.0
    torch.cuda.synchronize()
    with mesh.on(0):
        torch.cuda._sleep(int(1e9))  # rank 0's stream is about 0.5 s late
        parts[0].add_(1.0)           # and only then writes its shard
    mesh.fork()
    got = hr.left_halo_ring(parts, 63, mesh)
    mesh.join()
    hr.check_exchanges(mesh)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want) and not got[0].any()


@pytest.mark.cuda
def test_halo_of_a_late_rank_is_not_reused_by_the_first_ranks_stream():
    """The halos of a card are one allocation under its first rank's stream.
    Dropped while rank 1 still has to read its slice, the memory must not go
    to new work on rank 0's stream.  No ``fork`` / ``join`` around the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import halo_ring as hr

    mesh = _time_mesh(2)
    parts = [torch.randn((64, 4096), device="cuda") for _ in range(2)]
    want = parts[0][:, -1024:].clone()
    torch.cuda.synchronize()
    got = hr.left_halo_ring(parts, 1024, mesh)
    first, size = got[0].data_ptr(), 2 * got[0].numel()
    with mesh.on(1):
        torch.cuda._sleep(int(1e9))  # rank 1 reads its halo about 0.5 s late
        kept = got[1].clone()
    del got
    with mesh.on(0):  # the same size, so the allocator's first candidate
        junk = torch.full((size,), float("nan"), device="cuda")
    assert junk.data_ptr() != first
    torch.cuda.synchronize()
    hr.check_exchanges(mesh)
    assert torch.equal(kept, want)


@pytest.mark.cuda
def test_sharded_step_after_a_timed_out_receive_raises(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch import Channelizer, shard_time
    from llzlab_tpu_torch.kernels import halo_ring as hr

    chan = Channelizer(fir_taps=firwin(256, 0.4), up=3, down=4,
                       taps_per_phase=8, fft_n=128, fir_method="block2",
                       device="cuda")
    mesh = _time_mesh(2)
    x = torch.randn((8, 2 * chan.block_multiple()), device="cuda")
    parts = shard_time(x, mesh)
    # kernel B4 waits for its sender; B3 on one card waits for nothing
    step = chan.sharded_step(mesh, halo="rdma_fused")
    st = chan.init_state(8)
    step(parts, st)
    monkeypatch.setattr(hr, "WAIT_LIMIT_S", 0.1)
    with mesh.on(0):
        torch.cuda._sleep(int(2e9))  # rank 0 sends about a second late
    step(parts, st)  # returns: the receive times out on the card
    with pytest.raises(RuntimeError, match="never arrived"):
        step(parts, st)
    step(parts, st)  # the error was reported once; the exchange works again
    hr.check_exchanges(mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
@pytest.mark.parametrize("channels", [1, 3, 12])
def test_block2_runs_any_channel_count(channels, mode, monkeypatch):
    """``fir_filter(method="block2")`` launches B2 once for 1, 3 and 12
    channels, on the channels as they are; its output is bitwise the launch
    on the rows padded to 8, and the launch on the JAX package's fold of
    the rows (``chip_smoke.fold_rows``); a stream of three calls is bitwise
    one shot."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.ops.fir import fir_filter

    monkeypatch.setenv("LLZ_MATMUL_PRECISION", mode)
    rng = np.random.default_rng(60 + channels)
    taps = firwin(1024, 0.25)
    block = block2_block(1024)
    x = torch.from_numpy(rng.standard_normal(
        (channels, 9 * block + 37)).astype(np.float32)).cuda()
    n = bf.block2_fir_cuda.launches
    y = fir_filter(x, taps, method="block2")
    assert bf.block2_fir_cuda.launches == n + 1
    xpad = torch.cat([torch.zeros((channels, block), device="cuda"), x], -1)
    ref = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
    assert y.shape == x.shape and _snr_db(ref, y) >= FLOOR_DB[mode]
    pad8 = torch.cat([xpad, torch.zeros((8, xpad.shape[1]), device="cuda")])
    assert torch.equal(bf.block2_fir_cuda(pad8[:max(8, channels)], taps,
                                          block, mode)[:channels], y)
    l, _ = chip_smoke.fold_geometry(channels, x.shape[1], block)
    folded = bf.block2_fir_cuda(chip_smoke.fold_rows(xpad, block, l), taps,
                                block, mode)
    assert torch.equal(folded.reshape(channels, -1)[:, :x.shape[1]], y)
    ys, zf = [], None
    for a, b in ((0, 3 * block), (3 * block, 5 * block), (5 * block, None)):
        part, zf = fir_filter(x[:, a:b], taps, zi=zf, return_zf=True)
        ys.append(part)
    assert torch.equal(torch.cat(ys, -1), y)


@pytest.mark.cuda
def test_block2_above_2049_taps_runs_tensor_code_and_auto_takes_ols():
    """Beyond B2's envelope ``method="block2"`` runs the two-product tensor
    code, chosen before any launch: no kernel launch, the CPU's output at
    the streaming floor; ``"auto"`` takes ols."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.ops.fir import fir_filter

    taps = firwin(3001, 0.25)
    x = torch.from_numpy(np.random.default_rng(47).standard_normal(
        (2, 9000)).astype(np.float32))
    n = bf.block2_fir_cuda.launches
    y = fir_filter(x.cuda(), taps, method="block2")
    assert bf.block2_fir_cuda.launches == n
    assert _snr_db(fir_filter(x, taps, method="block2"), y) >= 120.0
    y, zf = fir_filter(x.cuda(), taps, return_zf=True)
    assert bf.block2_fir_cuda.launches == n
    assert torch.equal(y, fir_filter(x.cuda(), taps, method="ols"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
def test_block2_over_65535_rows_equals_chunked_launches(mode):
    """65 544 rows of 1152 samples: one call (at "highest" two launches,
    the grid's y extent being the row) bitwise equal, row by row, to calls
    of at most 65 535 rows, and at the plain version's floor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    taps = firwin(1024, 0.25)
    block = block2_block(1024)
    rows = 65536 + 8
    gen = torch.Generator(device="cuda").manual_seed(48)
    xpad = torch.randn((rows, block + 1152), generator=gen, device="cuda")
    n = bf.block2_fir_cuda.launches
    y = bf.block2_fir_cuda(xpad, taps, block, mode)
    assert bf.block2_fir_cuda.launches == n + len(bf.row_chunks(rows, mode))
    assert len(bf.row_chunks(rows, mode)) == (1 if mode == "high" else 2)
    for r0, r1 in ((0, 65535), (65535, rows), (rows - 8, rows)):
        assert torch.equal(
            y[r0:r1], bf.block2_fir_cuda(xpad[r0:r1], taps, block, mode))
    ref = bf.block2_fir_plain(xpad[-64:].double(), taps, block, "highest")
    assert _snr_db(ref, y[-64:]) >= FLOOR_DB[mode]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["reference", "wdft", "cwola"])
def test_config4_stage_on_the_card_matches_its_cpu_run(engine):
    """Config 4's stage (2048-point frames, hop 512, Hann) on 4 channels of
    1 s, streamed in two blocks, against the same stream on the CPU: cuFFT
    or cuBLAS against the CPU's libraries, on the interior."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.pipeline import Chain, SpectralGainStage

    gain = np.full(1025, 10 ** (-6 / 20), np.float32)
    gain[43:86] = 0.0
    x = torch.from_numpy(np.random.default_rng(49).standard_normal(
        (4, 48128)).astype(np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        chain = Chain([SpectralGainStage(gain, engine=engine)])
        ys = list(chain.stream([x[:, :24064].to(dev), x[:, 24064:].to(dev)]))
        outs[dev] = torch.cat(ys, -1).cpu()
    lo, hi = 1536 + 2048, 48128 - 2048
    assert _snr_db(outs["cpu"][:, lo:hi], outs["cuda"][:, lo:hi]) >= 120.0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ols", "direct", "im2col"])
def test_fir_engines_on_the_card(method):
    """The plain engines on a CUDA tensor (cuFFT, cuDNN with TF32 off,
    cuBLAS) against the float64 plain version of B2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.ops.fir import fir_filter

    taps = firwin(1024, 0.25)
    block = block2_block(1024)
    x = torch.randn((2, 20000), device="cuda")
    y = fir_filter(x, taps, method=method)
    xpad = torch.cat([torch.zeros((2, block), device="cuda"), x], -1)
    ref = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
    assert y.is_cuda and _snr_db(ref, y) >= 110.0


def _eq_and_butter():
    """Config 3's 8-section EQ (coupled form) and a 7th-order Butterworth
    (one real-pole section: the companion form)."""
    from llzlab_tpu_torch.ops.iir import butter_sos, peaking_eq_sos

    return {"eq": peaking_eq_sos([100, 200, 400, 800, 1600, 3200, 6400,
                                  12800], [3, -4, 5, -2, 6, -3, 2, -5],
                                 48000.0),
            "butter7": butter_sos(7, 0.3)}


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["eq", "butter7"])
def test_iir_scan_engine_on_the_card(design):
    """``sosfilt`` on a CUDA tensor: a 2-way and a 3-way split at multiples
    of the block bitwise one shot (output and states), against scipy
    float64 at the JAX package's floors (120 dB for the EQ, 100 for a
    real-pole design), and bitwise its own run on the CPU (the same
    float32 mul/add and the same host carry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import scipy.signal as ss

    from llzlab_tpu_torch.ops.iir import sosfilt

    sos = _eq_and_butter()[design]
    x = torch.from_numpy(np.random.default_rng(50).standard_normal(
        (8, 6 * 1024 + 300)).astype(np.float32))
    xc = x.cuda()
    one, zf = sosfilt(sos, xc, block_size=1024, return_zf=True)
    for cuts in ((2048,), (1024, 4096)):
        parts, zi = [], None
        for a, b in zip((0,) + cuts, cuts + (x.shape[1],)):
            y, zi = sosfilt(sos, xc[:, a:b], zi=zi, block_size=1024,
                            return_zf=True)
            parts.append(y)
        assert torch.equal(torch.cat(parts, -1), one)
        assert torch.equal(zi, zf)
    ref = ss.sosfilt(sos, x.double().numpy(), axis=-1)
    assert _snr_db(torch.from_numpy(ref), one) >= (
        120.0 if design == "eq" else 100.0)
    y_cpu, zf_cpu = sosfilt(sos, x, block_size=1024, return_zf=True)
    assert torch.equal(one.cpu(), y_cpu) and torch.equal(zf.cpu(), zf_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("design,rows,t,block", [
    ("eq", 64, 4096, 4096), ("eq", 1, 480_000, 4096),
    ("eq", 1024, 4096 + 300, 4096), ("eq", 8, 300, 4096),
    ("butter7", 64, 4096, 4096), ("butter7", 8, 6 * 1024 + 300, 1024)])
def test_sos_scan_kernel_is_bitwise_the_tensor_cascade(design, rows, t,
                                                       block):
    """The scan kernel (``sosfilt`` on a CUDA tensor, one launch) against
    the tensor cascade on the card, ``apply_section_host`` a section at a
    time (``ops.iir._cascade``), against its plain version on the card
    (``sos_scan_plain``) and against ``sosfilt`` on the CPU: the same
    bits, outputs and states, from a state that is not zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import sos_scan
    from llzlab_tpu_torch.ops import iir

    sos = _eq_and_butter()[design]
    rng = np.random.default_rng(52)
    x = torch.from_numpy(rng.standard_normal((rows, t)).astype(np.float32))
    zi = torch.from_numpy(rng.standard_normal(
        (rows, len(sos), 2)).astype(np.float32))
    n = sos_scan.sos_scan_cuda.launches
    y, zf = iir.sosfilt(sos, x.cuda(), zi=zi.cuda(), block_size=block,
                        return_zf=True)
    assert sos_scan.sos_scan_cuda.launches == n + 1
    kinds, params = iir.sos_plan(sos)
    y_t, zf_t = iir._cascade(kinds, params, x.cuda(), zi.cuda(), block)
    assert torch.equal(y, y_t) and torch.equal(zf, zf_t)
    y_p, zf_p = sos_scan.sos_scan_plain(
        x.cuda(), sos_scan.scan_tables(sos, block, "cuda"), zi.cuda(), True)
    assert torch.equal(y, y_p) and torch.equal(zf, zf_p)
    y_cpu, zf_cpu = iir.sosfilt(sos, x, zi=zi, block_size=block,
                                return_zf=True)
    assert torch.equal(y.cpu(), y_cpu) and torch.equal(zf.cpu(), zf_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("design,repeat,rows,t,block", [
    ("eq", 1, 8, 3 * 16384 + 300, 16384), ("butter7", 1, 3, 70_000, 65536),
    ("eq_and_inverse", 100, 2, 5 * 1024 + 300, 1024)])
def test_sos_scan_wide_variant_is_bitwise_the_tensor_cascade(
        design, repeat, rows, t, block):
    """Blocks above ``MAX_BLOCK`` and a cascade of 1600 sections, which
    shared memory does not hold, take the kernel's wide variant: one
    launch, bitwise the tensor cascade on the card and ``sosfilt`` on the
    CPU, outputs and states; a stream cut at a multiple of the block is
    bitwise one call.  The long cascade is the EQ and its inverse (the
    gains negated) in turn, so that its output stays finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import sos_scan
    from llzlab_tpu_torch.ops import iir

    designs = _eq_and_butter()
    inverse = iir.peaking_eq_sos([100, 200, 400, 800, 1600, 3200, 6400,
                                  12800], [-3, 4, -5, 2, -6, 3, -2, 5],
                                 48000.0)
    designs["eq_and_inverse"] = np.concatenate([designs["eq"], inverse])
    sos = np.tile(designs[design], (repeat, 1))
    assert sos_scan.scan_tables(sos, block, "cuda").wide
    rng = np.random.default_rng(54)
    x = torch.from_numpy(rng.standard_normal((rows, t)).astype(np.float32))
    zi = torch.from_numpy(rng.standard_normal(
        (rows, len(sos), 2)).astype(np.float32))
    n = sos_scan.sos_scan_cuda.launches
    y, zf = iir.sosfilt(sos, x.cuda(), zi=zi.cuda(), block_size=block,
                        return_zf=True)
    assert sos_scan.sos_scan_cuda.launches == n + 1
    kinds, params = iir.sos_plan(sos)
    y_t, zf_t = iir._cascade(kinds, params, x.cuda(), zi.cuda(), block)
    assert torch.equal(y, y_t) and torch.equal(zf, zf_t)
    y_cpu, zf_cpu = iir.sosfilt(sos, x, zi=zi, block_size=block,
                                return_zf=True)
    assert torch.equal(y.cpu(), y_cpu) and torch.equal(zf.cpu(), zf_cpu)
    y1, z1 = iir.sosfilt(sos, x[:, :block].cuda(), zi=zi.cuda(),
                         block_size=block, return_zf=True)
    y2, z2 = iir.sosfilt(sos, x[:, block:].cuda(), zi=z1,
                         block_size=block, return_zf=True)
    assert torch.equal(torch.cat([y1, y2], -1), y) and torch.equal(z2, zf)
    assert bool(torch.isfinite(y).all())


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["eq", "butter7"])
def test_sos_scan_kernel_splits_at_blocks_are_one_shot(design):
    """A stream through the kernel cut at multiples of the block, the
    state carried, is bitwise one call: outputs and states; each call is
    one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.kernels import sos_scan
    from llzlab_tpu_torch.ops.iir import sosfilt

    sos, L = _eq_and_butter()[design], 4096
    x = torch.randn((64, 10 * L + 300), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(53))
    one, zf = sosfilt(sos, x, block_size=L, return_zf=True)
    for cuts in ((L,), (L, 3 * L, 9 * L), (10 * L,)):
        parts, zi = [], None
        n = sos_scan.sos_scan_cuda.launches
        for a, b in zip((0,) + cuts, cuts + (x.shape[1],)):
            y, zi = sosfilt(sos, x[:, a:b], zi=zi, block_size=L,
                            return_zf=True)
            parts.append(y)
        assert sos_scan.sos_scan_cuda.launches == n + len(cuts) + 1
        assert torch.equal(torch.cat(parts, -1), one)
        assert torch.equal(zi, zf)


@pytest.mark.cuda
def test_sosfilt_on_the_card_reads_no_state_to_the_host(monkeypatch):
    """On the card ``sosfilt`` opens the kernel's span and neither the host
    carry's (``llz/ops/sos_carry``) nor a read of states
    (``counters()["state_reads"]``).  The spans are taken as the program
    opens them, with no profiler running: a profile taken before
    ``test_spans_on_the_card_are_not_device_work`` leaves that test's
    profile short of kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import contextlib

    from llzlab_tpu_torch.ops.iir import sosfilt
    from llzlab_tpu_torch.runtime import profiler

    sos = _eq_and_butter()["eq"]
    x = torch.randn((64, 4096), device="cuda")
    zi = torch.zeros((64, len(sos), 2), device="cuda")
    sosfilt(sos, x, zi=zi, return_zf=True)  # built and tables made
    reads = dict(profiler.counters()["state_reads"])
    names = []

    def record(name, *args):
        names.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(profiler, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(profiler, "_RecordFunctionFast", record)
    sosfilt(sos, x, zi=zi, return_zf=True)
    torch.cuda.synchronize()
    assert names == ["llz/ops/sosfilt", "llz/kernels/sos_scan"]
    assert profiler.counters()["state_reads"] == reads


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["eq", "butter7"])
def test_iir_matmul_engine_on_the_card(design):
    """``sosfilt_matmul`` on a CUDA tensor (fp32 cuBLAS, TF32 off) against
    scipy float64 above the JAX package's 110 dB, ragged tail included,
    on two signals of one shape: the second call replays the first's
    captured graph with new inputs and states, and leaves the first
    call's outputs as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import scipy.signal as ss

    from llzlab_tpu_torch.ops.iir_matmul import sosfilt_matmul

    sos = _eq_and_butter()[design]
    x = np.random.default_rng(51).standard_normal((2, 8, 20000)).astype(
        np.float32)
    zi = torch.zeros((8, len(sos), 2), device="cuda")
    y0, z0 = sosfilt_matmul(sos, torch.from_numpy(x[0]).cuda(), zi=zi,
                            return_zf=True)
    kept = (y0.clone(), z0.clone())
    y1 = sosfilt_matmul(sos, torch.from_numpy(x[1]).cuda(), zi=z0)
    assert torch.equal(y0, kept[0]) and torch.equal(z0, kept[1])
    ref = ss.sosfilt(sos, x.astype(np.float64).transpose(1, 0, 2).reshape(
        8, -1), axis=-1)
    assert y0.is_cuda and _snr_db(torch.from_numpy(ref[:, :20000]), y0) > 110.0
    assert _snr_db(torch.from_numpy(ref[:, 20000:]), y1) > 110.0


@pytest.mark.cuda
def test_iir_matmul_graphs_hold_memory_until_cleared(monkeypatch):
    """``sosfilt_matmul`` captures a CUDA graph only for a call of at most
    ``GRAPH_MAX_SAMPLES``; the graph's pool stays reserved until
    ``clear_graphs`` drops it, and a larger call runs eagerly, capturing
    none, to the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.ops import iir_matmul

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    sos = _eq_and_butter()["eq"]
    x = torch.randn((8, 20000), device="cuda")
    iir_matmul.sosfilt_matmul(sos, x[:, :1000])  # the capture stream's
    iir_matmul.clear_graphs()  # cuBLAS workspace, kept for the process
    monkeypatch.setattr(iir_matmul, "GRAPH_MAX_SAMPLES", 8 * 20000 - 1)
    eager = iir_matmul.sosfilt_matmul(sos, x)  # padded past the limit
    assert len(iir_matmul._graphs) == 0
    before = reserved()
    monkeypatch.setattr(iir_matmul, "GRAPH_MAX_SAMPLES", 1 << 24)
    replayed = iir_matmul.sosfilt_matmul(sos, x)
    assert len(iir_matmul._graphs) == 1
    assert torch.equal(eager, replayed)
    del replayed
    assert reserved() > before
    assert iir_matmul.clear_graphs() == 1
    assert reserved() == before


@pytest.mark.cuda
def test_sosfilt_auto_reads_the_card_artifact():
    """On a CUDA tensor ``sosfilt_auto`` ranks the engines by this card's
    packaged artifact (``llzlab_tpu_torch/calib/``), and
    ``bit_exact_carry`` takes the scan engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import json
    import os

    from llzlab_tpu_torch.ops import iir_select

    kind = torch.cuda.get_device_name(0)
    path = iir_select.calib_path(kind)
    assert os.path.exists(path), f"no artifact for {kind!r}"
    with open(path) as f:
        rows = json.load(f)["measured"]
    iir_select.load_engine_matrix.cache_clear()
    for need in (80.0, 120.0):
        meets = [r for r in rows
                 if r["snr"] - iir_select.SNR_MARGIN_DB >= need]
        best = max(meets, key=lambda r: r["msps"])
        assert iir_select.select_engine("cuda", min_snr_db=need) == (
            best["engine"], best["precision"])
    assert iir_select.select_engine("cuda", bit_exact_carry=True) == (
        "scan", "f32")
    sos = _eq_and_butter()["eq"]
    x = torch.randn((4, 9000), device="cuda")
    assert iir_select.sosfilt_auto(sos, x).is_cuda


def _remaining_ops():
    """Queue A slice 7's device ops on two seed-made inputs, with the
    floor each holds against its own run on the CPU (``chip_smoke.py``'s
    phase-9 floors against float64; the two float32 runs differ by less)."""
    import importlib

    import llzlab_tpu_torch as lt
    from llzlab_tpu_torch.ops import compat

    mdct = importlib.import_module("llzlab_tpu_torch.ops.mdct")
    taps = torch.from_numpy(firwin(129, 0.25).astype(np.float32))
    fl = chip_smoke.P9_FLOOR_DB
    fs = 48000.0

    def on(v, x):
        return v.to(x.device)

    return {
        "spectrogram": (lambda x, y: lt.spectrogram(x, n_fft=256, hop=64),
                        fl["psd"]),
        "welch": (lambda x, y: lt.welch(x, fs=fs, nperseg=256)[1],
                  fl["psd"]),
        "csd": (lambda x, y: lt.csd(x, y, fs=fs, nperseg=256)[1],
                fl["psd"]),
        "coherence": (lambda x, y: lt.coherence(x, y[:, :3000], fs=fs,
                                                nperseg=256)[1], fl["psd"]),
        "periodogram": (lambda x, y: lt.periodogram(x, fs=fs)[1],
                        fl["psd"]),
        "hilbert": (lambda x, y: lt.hilbert(x), fl["hilbert"]),
        "analytic_envelope": (lambda x, y: lt.analytic_envelope(x, 4100),
                              fl["hilbert"]),
        "detrend": (lambda x, y: lt.detrend(x), fl["detrend"]),
        "savgol_filter": (lambda x, y: lt.savgol_filter(x, 101, 3),
                          fl["smooth"]),
        "savgol_filter mirror": (lambda x, y: lt.savgol_filter(
            x, 11, 3, mode="mirror"), fl["smooth"]),
        "medfilt": (lambda x, y: lt.medfilt(x, 5), None),
        "wiener": (lambda x, y: lt.wiener(x, 5), fl["smooth"]),
        "fftconvolve": (lambda x, y: lt.fftconvolve(x, on(taps, x)),
                        fl["conv"]),
        "correlate": (lambda x, y: lt.correlate(x, y[0, :50]), fl["conv"]),
        "convolve direct": (lambda x, y: compat.convolve(
            x[0], on(taps, x), method="direct"), fl["conv"]),
        "oaconvolve": (lambda x, y: compat.oaconvolve(x, on(taps, x),
                                                      mode="valid"),
                       fl["conv"]),
        "upfirdn": (lambda x, y: compat.upfirdn(
            lt.resample_taps(147, 160, 16), x[:, :500], 147, 160),
                    fl["conv"]),
        "zoom_fft": (lambda x, y: lt.zoom_fft(x, [900.0, 1100.0], 512,
                                              fs=fs), fl["czt"]),
        "czt": (lambda x, y: lt.czt(x[0]), fl["czt"]),
        "mdct": (lambda x, y: mdct.mdct(x, 256), fl["mdct"]),
        "imdct": (lambda x, y: mdct.imdct(mdct.mdct(x, 256)), fl["mdct"]),
        "dct": (lambda x, y: lt.dct(x.reshape(4, 16, 256), type=2,
                                    norm="ortho"), fl["mdct"]),
        "idst": (lambda x, y: lt.idst(x.reshape(4, 16, 256), type=3),
                 fl["mdct"]),
        "lombscargle": (lambda x, y: lt.lombscargle(
            torch.cumsum(x[0].abs(), 0) / 1000.0, y[0], on(
                torch.linspace(0.5, 30.0, 512), x)), fl["psd"]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_remaining_ops()))
def test_remaining_ops_on_the_card_match_their_cpu_runs(name):
    """Each op on a CUDA tensor returns a CUDA tensor that agrees with the
    port's own run of it on the CPU (bitwise for the median)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    fn, floor = _remaining_ops()[name]
    rng = np.random.default_rng(88)
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32))
    y = torch.from_numpy((0.5 * x.numpy() + rng.standard_normal(
        (4, 4096))).astype(np.float32))
    cpu = fn(x, y)
    card = fn(x.cuda(), y.cuda())
    assert card.is_cuda and card.shape == cpu.shape
    assert card.dtype == cpu.dtype
    if floor is None:
        assert torch.equal(card.cpu(), cpu)
        return
    snr = chip_smoke.min_channel_snr_db(cpu.reshape(1, -1).numpy(),
                                        card.cpu().reshape(1, -1).numpy())
    assert snr >= floor, snr


@pytest.mark.cuda
def test_clear_tables_gives_back_the_card_memory_of_a_long_dct():
    """A 4096-point DCT holds its 64 MiB float32 matrix on the card until
    ``ops.clear_tables`` drops it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import llzlab_tpu_torch as lt

    lt.ops.clear_tables()
    x = torch.randn((2, 4096), device="cuda")
    torch.matmul(x, x.T)  # cuBLAS's workspace, kept for the process
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = lt.dct(x, type=2, norm="ortho")
    del y
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before >= 4096 * 4096 * 4
    assert lt.ops.clear_tables() == 1
    assert torch.cuda.memory_allocated() == before


def _card_mesh(nc, nt):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.parallel.mesh import make_dsp_mesh

    return make_dsp_mesh(nc, nt)


@pytest.mark.cuda
@pytest.mark.parametrize("method,kernel", [("fused", ff.fused_fir_resample_cuda),
                                           ("block2", bf.block2_fir_cuda)])
def test_2d_channelizer_on_the_card_is_unsharded_streaming(method, kernel):
    """A (2, 2) mesh of the card: each rank launches its kernel, and the
    frames and states equal unsharded streaming bit for bit."""
    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.parallel.mesh import gather, shard

    mesh = _card_mesh(2, 2)
    chan = Channelizer(fir_taps=firwin(256, 0.4), up=UP, down=DOWN,
                       fft_n=128, taps_per_phase=K, fir_method=method,
                       device="cuda")
    t_loc = chan.block_multiple()
    x = torch.randn((16, 2 * t_loc), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    n = kernel.launches
    spec, st = chan.sharded_step(mesh)(shard(x, mesh), chan.init_state(16))
    assert kernel.launches == n + 4
    got = gather(spec, mesh, dim=1)
    st_r, ref = chan.init_state(16), []
    for j in range(2):
        s_, st_r = chan.step(x[:, j * t_loc:(j + 1) * t_loc], st_r)
        ref.append(s_)
    assert torch.equal(got, torch.cat(ref, dim=1))
    assert all(torch.equal(a, b) for a, b in zip(st, st_r))


@pytest.mark.cuda
def test_sharded_ops_on_the_card():
    """fir_filter_sharded(block2) launches B2 on every rank, bitwise
    unsharded streaming; the IIR carry holds its floor; the heartbeat sees
    a NaN on any rank."""
    from llzlab_tpu_torch.ops.fir import fir_filter
    from llzlab_tpu_torch.ops.iir import peaking_eq_sos, sosfilt
    from llzlab_tpu_torch.parallel import sharded_ops as so
    from llzlab_tpu_torch.parallel.mesh import gather, shard
    from llzlab_tpu_torch.runtime.health import heartbeat

    mesh = _card_mesh(2, 2)
    taps = firwin(NTAPS, 0.2)
    x = torch.randn((8, 2 * 4096), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    n = bf.block2_fir_cuda.launches
    y = gather(so.fir_filter_sharded(shard(x, mesh), taps, mesh,
                                     method="block2"), mesh)
    assert bf.block2_fir_cuda.launches == n + 4
    zi, ref = None, []
    for j in range(2):
        yj, zi = fir_filter(x[:, j * 4096:(j + 1) * 4096], taps,
                            method="block2", zi=zi, return_zf=True)
        ref.append(yj)
    assert torch.equal(y, torch.cat(ref, dim=-1))
    sos = peaking_eq_sos([100, 1000, 8000], [3, -4, 5], 48000.0)
    got = gather(so.sosfilt_sharded(shard(x, mesh), sos, mesh,
                                    block_size=1024), mesh)
    assert _snr_db(sosfilt(sos, x, block_size=1024), got) >= 135.0
    bad = torch.zeros(64, device="cuda")
    bad[50] = float("nan")
    assert heartbeat(mesh)["ok"] and not heartbeat(mesh, bad)["ok"]


@pytest.mark.cuda
def test_halo_kernels_between_two_processes_of_one_card(tmp_path):
    """Kernels B3 and B4 between two processes on ``cuda:0`` (gloo for the
    handshake of CUDA IPC, the mesh ``[P0, P0, P1, P1]``): each process's
    ranks bitwise the same ranks in one process and B3 the plain version,
    over three epochs with a carry, B4 at both precisions (the worker
    raises otherwise); every launch of the path crosses to the other
    process at one edge; a sender held back past the wait limit raises in
    the receiving process alone, and the next exchange is right."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from scripts import halo_ipc_worker_torch as hw

    res = hw.launch("card", 2, str(tmp_path), [
        "--channels", "24", "--t-loc", "4096", "--b4-channels", "24", "--h",
        "63", "--iters", "2"])
    for r in res:
        for path, counts in r["paths"].items():
            kernel = "halo_ring" if path.startswith("B3") else \
                "halo_fir_fused"
            other = "halo_fir_fused" if kernel == "halo_ring" else \
                "halo_ring"
            assert counts[other] == [0, 0], (path, counts)
            n, across = counts[kernel]
            # one B3 launch a process an epoch; B4 one a rank
            assert n == (3 if kernel == "halo_ring" else 2), (path, counts)
            assert across == (3 if kernel == "halo_ring" else 1)
        assert r["b4_snr_db"]["highest"] >= FLOOR_DB["highest"]
        assert r["b4_snr_db"]["high"] >= FLOOR_DB["high"]
    receiver = res[0]["late_receiver"] * 2 // 4  # its process
    for r in res:
        if r["process"] == receiver:
            assert "never arrived" in r["late_sender"], r["late_sender"]
        else:
            assert r["late_sender"] == "no error"


@pytest.mark.cuda
def test_spans_on_the_card_are_not_device_work():
    """A stream block of config 1's shape under ``profile_calls``: the
    program's spans are on the host's timeline, B2 and the history's
    ``cat`` are the only device work, and a card's busy time is at most
    its event time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from llzlab_tpu_torch.pipeline.chain import Chain, FIRStage
    from llzlab_tpu_torch.runtime import profiler

    chain = Chain([FIRStage(firwin(1024, 0.25), method="auto")])
    state = [chain.init_state((1,), device="cuda")]
    x = torch.randn(1, 4096, device="cuda")

    def block():
        _, state[0] = chain.apply(x, state[0])

    block()
    n = bf.block2_fir_cuda.launches
    calls = profiler.counters()["calls"]["Chain.apply"]
    prof = profiler.profile_calls(block, iters=4)
    assert bf.block2_fir_cuda.launches == n + 4
    assert profiler.counters()["calls"]["Chain.apply"] == calls + 4
    assert not any(name.startswith("llz/") for name, _, _ in prof.rows)
    assert prof.kernels == 2.0 and prof.copies == 0.0
    assert 0.0 < prof.busy_by_device[0] <= prof.busy_ms + 1e-9
    assert 0.0 <= prof.idle_pct < 100.0

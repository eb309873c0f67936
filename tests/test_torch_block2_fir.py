"""Kernel B2's plain version and the port's ``fir_filter(method="block2")``
against the JAX package on CPU.  The JAX Pallas kernel runs in interpret
mode, as its own tests run it; on a CPU tensor the port runs the plain
version of its CUDA kernel."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

from llzlab_tpu.kernels import block2_fir as rbf
from llzlab_tpu.ops import fir as rfir
from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.ops import fir as pfir
from tests.conftest import snr_db

MODES = ["high", "highest"]
#: port plain vs the JAX kernel: both form the same bf16x3 (or f32)
#: products and differ only in the f32 order of the sums (measured
#: 134-138 dB at these shapes)
VS_KERNEL_DB = {"highest": 130.0, "high": 120.0}
#: port vs the JAX ``fir_filter(method="block2")``, which runs plain f32 on
#: CPU: at "high" the gap is the bf16x3 error itself (~105 dB measured)
VS_XLA_DB = {"highest": 130.0, "high": 100.0}
#: against scipy float64 (the floors of the JAX package's chain tests)
VS_SCIPY_DB = {"highest": 110.0, "high": 80.0}


def _signal(ntaps, seed=5):
    rng = np.random.default_rng(seed)
    block = rfir.block2_block(ntaps)
    x = rng.standard_normal((8, 5 * block + 37)).astype(np.float32)
    hist = rng.standard_normal((8, block)).astype(np.float32)
    return rfir.firwin(ntaps, 0.2), block, x, hist


@pytest.mark.parametrize("ntaps", [129, 256])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_kernel(ntaps, mode):
    taps, block, x, hist = _signal(ntaps)
    xpad = np.concatenate([hist, x], axis=1)
    ref = np.asarray(rbf.block2_fir_pallas(
        jnp.asarray(xpad), taps, block, mode=mode, interpret=True))
    got = bf.block2_fir(torch.from_numpy(xpad), taps, block, mode=mode)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert snr_db(ref, got.numpy()) >= VS_KERNEL_DB[mode]


@pytest.mark.parametrize("ntaps", [129, 256])
@pytest.mark.parametrize("mode", MODES)
def test_fir_filter_matches_reference_and_scipy(ntaps, mode, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", mode)
    taps, block, x, hist = _signal(ntaps, seed=6)
    y_ref, zf_ref = rfir.fir_filter(jnp.asarray(x), taps, method="block2",
                                    zi=jnp.asarray(hist), return_zf=True)
    y, zf = pfir.fir_filter(torch.from_numpy(x), taps, method="block2",
                            zi=torch.from_numpy(hist), return_zf=True)
    assert snr_db(np.asarray(y_ref), y.numpy()) >= VS_XLA_DB[mode]
    np.testing.assert_array_equal(zf.numpy(), np.asarray(zf_ref))
    y0 = pfir.fir_filter(torch.from_numpy(x), taps).numpy()
    golden = ss.lfilter(taps, [1.0], x.astype(np.float64), axis=-1)
    for c in range(x.shape[0]):
        assert snr_db(golden[c], y0[c]) >= VS_SCIPY_DB[mode]


@pytest.mark.parametrize("mode", MODES)
def test_streaming_split_bit_exact(mode, monkeypatch):
    """Splitting at a block boundary and carrying zf reproduces the one-shot
    output bit for bit (the plain version's block grid is anchored at the
    history block, so a split at a block multiple changes no operand)."""
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", mode)
    taps, block, x, _ = _signal(256, seed=7)
    x = torch.from_numpy(x)
    full = pfir.fir_filter(x, taps, method="block2")
    ya, zf = pfir.fir_filter(x[:, : 3 * block], taps, return_zf=True)
    yb = pfir.fir_filter(x[:, 3 * block:], taps, zi=zf)
    torch.testing.assert_close(torch.cat([ya, yb], -1), full, rtol=0, atol=0)


def test_cpu_path_runs_plain_version_and_kernel_wrapper_needs_cuda():
    taps, block, x, hist = _signal(129)
    xpad = torch.from_numpy(np.concatenate([hist, x], axis=1))
    before = bf.block2_fir_cuda.launches
    bf.block2_fir(xpad, taps, block)
    assert bf.block2_fir_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        bf.block2_fir_cuda(xpad, taps, block)


@pytest.mark.parametrize("method", ["im2col"])
def test_unported_methods_raise(method):
    """"im2col" was the one method left to port: it now agrees with the JAX
    package (f32 products in another sum order, VS_XLA_DB["highest"]), and
    "fft", which the JAX package does not know either, still raises."""
    taps, _, x, _ = _signal(129, seed=9)
    y_ref = rfir.fir_filter(jnp.asarray(x), taps, method=method)
    y = pfir.fir_filter(torch.from_numpy(x), taps, method=method)
    assert snr_db(np.asarray(y_ref), y.numpy()) >= VS_XLA_DB["highest"]
    with pytest.raises(ValueError, match="unknown method"):
        pfir.fir_filter(torch.zeros(8, 256), pfir.firwin(129, 0.2),
                        method="fft")


@pytest.mark.parametrize("ntaps", [129, 256])
def test_plain_matches_pallas_kernel_highcat_body(ntaps):
    """``_kernel_highcat`` is an alternate body behind the same
    ``pallas_call`` as ``_kernel_high`` and computes the same bf16x3
    function, so kernel B2 is its counterpart too."""
    taps, block, x, hist = _signal(ntaps, seed=8)
    xpad = np.concatenate([hist, x], axis=1)
    ref = np.asarray(rbf.block2_fir_pallas(
        jnp.asarray(xpad), taps, block, mode="highcat", interpret=True))
    got = bf.block2_fir_plain(torch.from_numpy(xpad), taps, block,
                              mode="high")
    assert got.shape == ref.shape
    assert snr_db(ref, got.numpy()) >= VS_KERNEL_DB["high"]


@pytest.mark.parametrize("rows", [1, 8, 65535, 65536, 65544, 131071, 131072,
                                  200001])
@pytest.mark.parametrize("mode", MODES)
def test_row_chunks_cover_every_row_once(rows, mode):
    """Kernel B2's launches over rows: at "highest" the grid's y extent is
    the row, so chunks of at most 65 535 rows; at "high" one launch."""
    chunks = bf.row_chunks(rows, mode)
    covered = np.zeros(rows, np.int64)
    for r0, r1 in chunks:
        assert 0 <= r0 < r1 <= rows
        assert r1 - r0 <= (rows if mode == "high" else bf.MAX_ROWS)
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert [r0 for r0, _ in chunks] == sorted(r0 for r0, _ in chunks)
    expect = 1 if mode == "high" else -(-rows // bf.MAX_ROWS)
    assert len(chunks) == expect
    assert bf.cuda_supports(rows, 1024, 1024, 1152)

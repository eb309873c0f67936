"""The port's ``ops/convolve.py`` and ``ops/dct.py`` against the JAX
package and numpy/scipy float64 on the CPU, on the same seed-made inputs."""

import importlib

import numpy as np
import pytest
import scipy.fft as sf
import torch

import jax.numpy as jnp

from llzlab_tpu.ops import convolve as rcv
import llzlab_tpu_torch as lt
from llzlab_tpu_torch.ops import convolve as pcv
from tests.conftest import snr_db

rdct = importlib.import_module("llzlab_tpu.ops.dct")
pdct = importlib.import_module("llzlab_tpu_torch.ops.dct")

#: fftconvolve / correlate against numpy float64: the JAX package's floor
#: (tests/ops/test_extras.py:25,42); two float32 FFT engines of the same
#: product against each other clear it too
CONV_DB = 110.0


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("nb", [64, 1200])
def test_fftconvolve_matches_reference_and_numpy(mode, nb):
    rng = np.random.default_rng(nb)
    a = rng.standard_normal((2, 1000)).astype(np.float32)
    b = rng.standard_normal(nb).astype(np.float32)
    y = pcv.fftconvolve(torch.from_numpy(a), torch.from_numpy(b), mode)
    ref = np.asarray(rcv.fftconvolve(jnp.asarray(a), jnp.asarray(b), mode))
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert snr_db(ref, y.numpy()) >= CONV_DB
    for i in range(2):
        golden = np.convolve(a[i].astype(np.float64), b.astype(np.float64),
                             mode)
        assert snr_db(golden, y[i].numpy()) >= CONV_DB


def test_fftconvolve_broadcasts_and_correlates():
    rng = np.random.default_rng(163)
    a = rng.standard_normal((3, 1, 300)).astype(np.float32)
    b = rng.standard_normal((4, 50)).astype(np.float32)
    y = lt.fftconvolve(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(rcv.fftconvolve(a, b))
    assert y.shape == ref.shape == (3, 4, 349)
    assert snr_db(ref, y.numpy()) >= CONV_DB
    c = lt.correlate(torch.from_numpy(a[0, 0]), torch.from_numpy(b[0]),
                     mode="same")
    ref = np.asarray(rcv.correlate(a[0, 0], b[0], mode="same"))
    golden = np.correlate(a[0, 0].astype(np.float64),
                          b[0].astype(np.float64), "same")
    assert snr_db(ref, c.numpy()) >= CONV_DB
    assert snr_db(golden, c.numpy()) >= CONV_DB


def test_float64_inputs_compute_in_float32():
    """The JAX package runs with float64 off: a float64 input computes in
    float32 there, and so it does here."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal(500), rng.standard_normal(33)
    y = pcv.fftconvolve(torch.from_numpy(a), b)
    ref = rcv.fftconvolve(a, b)
    assert y.dtype == torch.float32 and ref.dtype == jnp.float32
    assert snr_db(np.asarray(ref), y.numpy()) >= CONV_DB
    d = pdct.dct(torch.from_numpy(a))
    assert d.dtype == torch.float32
    assert rdct.dct(a).dtype == jnp.float32


def test_unknown_mode_raises_in_both():
    a = np.zeros(16, np.float32)
    with pytest.raises(ValueError, match="mode"):
        rcv.fftconvolve(a, a, mode="circular")
    with pytest.raises(ValueError, match="mode"):
        pcv.fftconvolve(torch.from_numpy(a), a, mode="circular")


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct_matrices_bit_equal(kind, t, norm):
    for n in (2, 7, 64):
        got = getattr(pdct, f"{kind}_matrix")(n, t, norm)
        want = getattr(rdct, f"{kind}_matrix")(n, t, norm)
        assert got.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct_dst_and_inverses_match_reference_and_scipy(t, norm):
    x = np.random.default_rng(t).standard_normal((3, 128)).astype(np.float32)
    xt = torch.from_numpy(x)
    for kind, golden in (("dct", sf.dct), ("dst", sf.dst)):
        y = getattr(pdct, kind)(xt, type=t, norm=norm)
        ref = np.asarray(getattr(rdct, kind)(x, type=t, norm=norm))
        want = golden(x.astype(np.float64), type=t, norm=norm, axis=-1)
        # the JAX package's tolerance against scipy (tests/ops/test_dct.py:25)
        atol = 2e-5 * np.max(np.abs(want))
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=atol)
        np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=atol)
        back = getattr(pdct, f"i{kind}")(y, type=t, norm=norm)
        ref_back = np.asarray(getattr(rdct, f"i{kind}")(ref, type=t,
                                                         norm=norm))
        np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=5e-5)
        np.testing.assert_allclose(back.numpy(), ref_back, rtol=0, atol=5e-5)


def test_dct_at_a_codec_frame():
    """A 960-point frame (AAC's), batched over frames: one (960, 960)
    product, as in the JAX package."""
    x = np.random.default_rng(960).standard_normal((2, 5, 960)).astype(
        np.float32)
    y = lt.dct(torch.from_numpy(x), type=2, norm="ortho")
    want = sf.dct(x.astype(np.float64), type=2, norm="ortho", axis=-1)
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=2e-5 * np.max(np.abs(want)))
    back = lt.idct(y, type=2, norm="ortho")
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=5e-5)


def test_clear_tables_drops_the_cached_transform_tables():
    """``ops.clear_tables`` empties the DCT, MDCT and chirp-Z caches, and
    the transforms rebuild their tables to the same result."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 64)).astype(np.float32))
    lt.ops.clear_tables()
    first = (lt.dct(x), lt.ops.mdct(x, 16), lt.czt(x))
    assert lt.ops.clear_tables() == 3
    assert lt.ops.clear_tables() == 0
    for a, b in zip(first, (lt.dct(x), lt.ops.mdct(x, 16), lt.czt(x))):
        assert torch.equal(a, b)

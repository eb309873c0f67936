"""The port's ``ops/smooth.py`` and ``ops/chirpz.py`` against the JAX
package and scipy float64 on the CPU: host coefficients, the chirp tables
and the median bit for bit, the rest by SNR."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

from llzlab_tpu.ops import chirpz as rcz
from llzlab_tpu.ops import smooth as rsm
import llzlab_tpu_torch as lt
from llzlab_tpu_torch.ops import chirpz as pcz
from llzlab_tpu_torch.ops import smooth as psm
from tests.test_torch_transform import snr_db

#: the JAX package's floors against scipy float64
#: (tests/ops/test_smooth_czt.py:25,42,63,70-87); the port against the JAX
#: package's float32 output clears them too
DETREND_DB, SMOOTH_DB, CZT_DB = 120.0, 100.0, 100.0


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(3).standard_normal((3, 500)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["constant", "linear"])
def test_detrend(x, kind):
    y = lt.detrend(torch.from_numpy(x), type=kind)
    ref = np.asarray(rsm.detrend(jnp.asarray(x), type=kind))
    golden = ss.detrend(x.astype(np.float64), type=kind)
    assert snr_db(ref, y.numpy()) >= DETREND_DB
    assert snr_db(golden, y.numpy()) >= DETREND_DB
    with pytest.raises(ValueError):
        lt.detrend(torch.from_numpy(x), type="cubic")


@pytest.mark.parametrize("wl,po,d,pos", [(11, 3, 0, None), (21, 4, 0, None),
                                         (15, 3, 1, None), (10, 2, 0, None),
                                         (9, 2, 3, None), (9, 3, 1, 2)])
def test_savgol_coeffs_bit_equal(wl, po, d, pos):
    got = psm.savgol_coeffs(wl, po, deriv=d, delta=0.5, pos=pos)
    want = rsm.savgol_coeffs(wl, po, deriv=d, delta=0.5, pos=pos)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["interp", "nearest", "mirror", "constant",
                                  "wrap"])
def test_savgol_filter(x, mode):
    y = lt.savgol_filter(torch.from_numpy(x), 11, 3, mode=mode)
    ref = np.asarray(rsm.savgol_filter(jnp.asarray(x), 11, 3, mode=mode))
    golden = ss.savgol_filter(x.astype(np.float64), 11, 3, mode=mode)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert snr_db(ref, y.numpy()) >= SMOOTH_DB
    assert snr_db(golden, y.numpy()) >= SMOOTH_DB


def test_savgol_deriv_and_float64(x):
    x64 = x.astype(np.float64)
    y = lt.savgol_filter(torch.from_numpy(x64), 15, 4, deriv=2, delta=0.5)
    ref = np.asarray(rsm.savgol_filter(x64, 15, 4, deriv=2, delta=0.5))
    golden = ss.savgol_filter(x64, 15, 4, deriv=2, delta=0.5)
    assert y.dtype == torch.float32
    assert snr_db(ref, y.numpy()) >= SMOOTH_DB
    assert snr_db(golden, y.numpy()) >= SMOOTH_DB


@pytest.mark.parametrize("k", [3, 5, 9])
def test_medfilt_bit_equal(x, k):
    y = lt.medfilt(torch.from_numpy(x), k)
    ref = np.asarray(rsm.medfilt(jnp.asarray(x), k))
    assert np.array_equal(y.numpy(), ref)
    golden = np.stack([ss.medfilt(r, k) for r in x.astype(np.float64)])
    np.testing.assert_allclose(y.numpy(), golden, atol=1e-6)


def test_medfilt_even_kernel_raises_in_both(x):
    with pytest.raises(ValueError, match="odd"):
        rsm.medfilt(jnp.asarray(x), 4)
    with pytest.raises(ValueError, match="odd"):
        lt.medfilt(torch.from_numpy(x), 4)


@pytest.mark.parametrize("k,noise", [(3, None), (7, None), (5, 0.1)])
def test_wiener(x, k, noise):
    y = lt.wiener(torch.from_numpy(x), k, noise)
    ref = np.asarray(rsm.wiener(jnp.asarray(x), k, noise))
    golden = np.stack([ss.wiener(r, k, noise) for r in x.astype(np.float64)])
    assert snr_db(ref, y.numpy()) >= SMOOTH_DB
    assert snr_db(golden, y.numpy()) >= SMOOTH_DB


@pytest.mark.parametrize("n,m,w,a", [
    (500, 500, np.exp(-2j * np.pi / 500), 1.0),
    (500, 100, np.exp(-2j * np.pi * 0.001), np.exp(2j * np.pi * 0.05)),
    (37, 300, np.exp(-2j * np.pi / 300), 1.0 + 0.0j)])
def test_czt_tables_bit_equal(n, m, w, a):
    nfft = 1 << max(4, int(np.ceil(np.log2(n + m - 1))))
    got = pcz.czt_tables(n, m, complex(w), complex(a), nfft)
    want = rcz._czt_tables(n, m, complex(w), complex(a), nfft)
    for g, r in zip(got, want):
        assert g.dtype == np.complex64 and np.array_equal(g, np.asarray(r))


def test_czt_and_zoom_fft(x):
    xt = torch.from_numpy(x)
    y = lt.czt(xt[0])
    assert y.dtype == torch.complex64
    assert snr_db(np.asarray(rcz.czt(jnp.asarray(x[0]))), y.numpy()) >= CZT_DB
    assert snr_db(ss.czt(x[0].astype(np.float64)), y.numpy()) >= CZT_DB
    w, a = np.exp(-2j * np.pi * 0.001), np.exp(2j * np.pi * 0.05)
    y = lt.czt(xt, 100, w, a)
    ref = np.asarray(rcz.czt(jnp.asarray(x), 100, w, a))
    golden = ss.czt(x.astype(np.float64), 100, w, a, axis=-1)
    assert y.shape == (3, 100)
    assert snr_db(ref, y.numpy()) >= CZT_DB
    assert snr_db(golden, y.numpy()) >= CZT_DB
    y = lt.zoom_fft(xt, [0.1, 0.3], 200, fs=2.0)
    ref = np.asarray(rcz.zoom_fft(jnp.asarray(x), [0.1, 0.3], 200, fs=2.0))
    golden = ss.zoom_fft(x.astype(np.float64), [0.1, 0.3], m=200, fs=2.0,
                         axis=-1)
    assert snr_db(ref, y.numpy()) >= CZT_DB
    assert snr_db(golden, y.numpy()) >= CZT_DB
    y = lt.zoom_fft(xt[1], [900.0, 1100.0], 64, fs=48000.0, endpoint=True)
    ref = np.asarray(rcz.zoom_fft(jnp.asarray(x[1]), [900.0, 1100.0], 64,
                                  fs=48000.0, endpoint=True))
    assert snr_db(ref, y.numpy()) >= CZT_DB


@pytest.mark.parametrize("as_tensor", [True, False])
def test_czt_and_zoom_fft_keep_a_complex_input(x, as_tensor):
    """A complex signal (the analytic signal of ``x``) keeps its imaginary
    part, as a complex64 tensor and as a complex128 numpy array."""
    z = ss.hilbert(x.astype(np.float64), axis=-1)
    zin = torch.from_numpy(z.astype(np.complex64)) if as_tensor else z
    w, a = np.exp(-2j * np.pi * 0.001), np.exp(2j * np.pi * 0.05)
    y = lt.czt(zin, 100, w, a)
    assert y.dtype == torch.complex64 and y.shape == (3, 100)
    ref = np.asarray(rcz.czt(jnp.asarray(z), 100, w, a))
    assert snr_db(ref, y.numpy()) >= CZT_DB
    assert snr_db(ss.czt(z, 100, w, a, axis=-1), y.numpy()) >= CZT_DB
    y = lt.zoom_fft(zin, [0.1, 0.3], 200, fs=2.0)
    ref = np.asarray(rcz.zoom_fft(jnp.asarray(z), [0.1, 0.3], 200, fs=2.0))
    golden = ss.zoom_fft(z, [0.1, 0.3], m=200, fs=2.0, axis=-1)
    assert snr_db(ref, y.numpy()) >= CZT_DB
    assert snr_db(golden, y.numpy()) >= CZT_DB


@pytest.mark.parametrize("num", [250, 333, 500, 1000])
def test_resample_fourier(x, num):
    y = pcz.resample_fourier(torch.from_numpy(x), num)
    ref = np.asarray(rcz.resample_fourier(jnp.asarray(x), num))
    golden = ss.resample(x.astype(np.float64), num, axis=-1)
    assert y.shape == (3, num)
    assert snr_db(ref, y.numpy()) >= SMOOTH_DB
    assert snr_db(golden, y.numpy()) >= SMOOTH_DB

"""The port's ``ops/analysis.py`` against the JAX package and scipy float64
on the CPU: the host responses bit for bit, the tensor ops by SNR."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

from llzlab_tpu.ops import analysis as ran
import llzlab_tpu_torch as lt
from llzlab_tpu_torch.ops import analysis as pan
from tests.test_torch_transform import snr_db

#: the JAX package's floors against scipy float64
#: (tests/ops/test_extras.py:152,161,169); the port against the JAX
#: package's float32 output clears the same floors
HILBERT_DB, PSD_DB = 100.0, 90.0
FS = 48000.0


def test_responses_bit_equal():
    taps = lt.firwin(101, 0.3)
    b, a = ss.butter(6, 0.3)
    sos = lt.butter_sos(6, 0.4)
    for worN in (256, np.linspace(10.0, 20000.0, 97)):
        fs = FS if np.ndim(worN) else 2 * np.pi
        for got, want in (
                (pan.freqz(taps, worN=worN, fs=fs),
                 ran.freqz(taps, worN=worN, fs=fs)),
                (pan.freqz(b, a, worN=worN, fs=fs),
                 ran.freqz(b, a, worN=worN, fs=fs)),
                (pan.sosfreqz(sos, worN=worN, fs=fs),
                 ran.sosfreqz(sos, worN=worN, fs=fs))):
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got, want = pan.group_delay(b, a, worN=300), ran.group_delay(b, a,
                                                                 worN=300)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("power,log", [(2.0, False), (1.0, True)])
def test_spectrogram_matches_reference(power, log):
    x = np.random.default_rng(31).standard_normal((2, 4096)).astype(
        np.float32)
    y = lt.spectrogram(torch.from_numpy(x), n_fft=256, power=power, log=log)
    ref = np.asarray(ran.spectrogram(jnp.asarray(x), n_fft=256, power=power,
                                     log=log))
    assert y.shape == ref.shape == (2, 61, 129) and y.dtype == torch.float32
    assert snr_db(ref, y.numpy()) >= (HILBERT_DB if log else PSD_DB)


@pytest.mark.parametrize("n", [None, 4000, 4097])
def test_hilbert_matches_reference_and_scipy(n):
    x = np.random.default_rng(21).standard_normal((2, 4096)).astype(
        np.float32)
    a = lt.hilbert(torch.from_numpy(x), n)
    ref = np.asarray(ran.hilbert(jnp.asarray(x), n))
    golden = ss.hilbert(x.astype(np.float64), n, axis=-1)
    assert a.dtype == torch.complex64 and a.shape == ref.shape
    assert snr_db(ref, a.numpy()) >= HILBERT_DB
    assert snr_db(golden, a.numpy()) >= HILBERT_DB


@pytest.mark.parametrize("window,nfft", [("boxcar", None), ("hann", 3000)])
def test_periodogram_matches_reference_and_scipy(window, nfft):
    x = np.random.default_rng(22).standard_normal((2, 2048)).astype(
        np.float32)
    f, p = lt.periodogram(torch.from_numpy(x), fs=FS, window=window,
                          nfft=nfft)
    rf, rp = ran.periodogram(jnp.asarray(x), fs=FS, window=window, nfft=nfft)
    # the JAX package's named window is the symmetric one (scipy's
    # periodogram takes the periodic): scipy gets it as an array
    w = lt.get_window(window, 2048) if window != "boxcar" else window
    gf, gp = ss.periodogram(x.astype(np.float64), fs=FS, window=w,
                            nfft=nfft, axis=-1)
    assert np.array_equal(f, rf) and np.allclose(f, gf)
    assert snr_db(np.asarray(rp), p.numpy()) >= PSD_DB
    assert snr_db(gp, p.numpy()) >= PSD_DB


@pytest.mark.parametrize("nperseg,noverlap", [(256, None), (256, 192)])
def test_welch_matches_reference_and_scipy(nperseg, noverlap):
    x = np.random.default_rng(23).standard_normal((3, 4096)).astype(
        np.float32)
    f, p = lt.welch(torch.from_numpy(x), fs=FS, nperseg=nperseg,
                    noverlap=noverlap)
    rf, rp = ran.welch(jnp.asarray(x), fs=FS, nperseg=nperseg,
                       noverlap=noverlap)
    gf, gp = ss.welch(x.astype(np.float64), fs=FS, nperseg=nperseg,
                      noverlap=noverlap)
    assert np.array_equal(f, rf) and np.allclose(f, gf)
    assert p.dtype == torch.float32
    assert snr_db(np.asarray(rp), p.numpy()) >= PSD_DB
    assert snr_db(gp, p.numpy()) >= PSD_DB


@pytest.mark.parametrize("ty", [4096, 3500])
def test_csd_and_coherence_match_reference_and_scipy(ty):
    """Equal lengths, and a shorter y: only the cross term pads, P_xx and
    P_yy stay the unpadded inputs' (scipy)."""
    rng = np.random.default_rng(ty)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    y = (0.5 * x[:, :ty] + rng.standard_normal((2, ty))).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    f, pxy = lt.csd(xt, yt, fs=FS, nperseg=256)
    _, rxy = ran.csd(jnp.asarray(x), jnp.asarray(y), fs=FS, nperseg=256)
    _, gxy = ss.csd(x.astype(np.float64), y.astype(np.float64), fs=FS,
                    nperseg=256)
    assert pxy.dtype == torch.complex64
    assert snr_db(np.asarray(rxy), pxy.numpy()) >= PSD_DB
    assert snr_db(gxy, pxy.numpy()) >= PSD_DB
    _, coh = lt.coherence(xt, yt, fs=FS, nperseg=256)
    _, rcoh = ran.coherence(jnp.asarray(x), jnp.asarray(y), fs=FS,
                            nperseg=256)
    _, gcoh = ss.coherence(x.astype(np.float64), y.astype(np.float64),
                           fs=FS, nperseg=256)
    assert snr_db(np.asarray(rcoh), coh.numpy()) >= PSD_DB
    assert snr_db(gcoh, coh.numpy()) >= PSD_DB


def test_float64_input_computes_in_float32():
    x = np.random.default_rng(24).standard_normal(2048)
    f, p = lt.welch(torch.from_numpy(x), fs=FS)
    _, rp = ran.welch(x, fs=FS)
    assert p.dtype == torch.float32 and rp.dtype == jnp.float32
    assert snr_db(np.asarray(rp), p.numpy()) >= PSD_DB
    assert lt.hilbert(torch.from_numpy(x)).dtype == torch.complex64


def test_welch_hop_must_divide_nperseg_in_both():
    x = np.zeros(4096, np.float32)
    with pytest.raises(ValueError, match="divide"):
        ran.welch(jnp.asarray(x), nperseg=256, noverlap=100)
    with pytest.raises(ValueError, match="divide"):
        lt.welch(torch.from_numpy(x), nperseg=256, noverlap=100)

"""The port's FFT entry points and its ``ols`` / ``direct`` FIR engines
against the JAX package on CPU and against numpy."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

from llzlab_tpu.ops import fir as rfir
from llzlab_tpu.ops import transform as rtf
from llzlab_tpu_torch.ops import fir as pfir
from llzlab_tpu_torch.ops import transform as ptf

#: f32 FFTs of two libraries (pocketfft both sides, or the JAX package's
#: f32 matrix-product tables for the pair layout)
FFT_DB = 120.0
#: f32 FIR engines of the two packages against each other
FIR_DB = 130.0


def snr_db(ref, y) -> float:
    """Signal-to-error ratio in dB of real or complex arrays."""
    ref = np.asarray(ref)
    err = np.abs(ref - np.asarray(y)).astype(np.float64)
    perr = float(np.sum(err ** 2))
    return float("inf") if perr == 0.0 else 10.0 * np.log10(
        float(np.sum(np.abs(ref).astype(np.float64) ** 2)) / perr)


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n", [None, 96, 128, 200])
def test_rfft_irfft_match_reference_and_numpy(n):
    x = _signal((3, 5, 128), 11)
    got = ptf.rfft(torch.from_numpy(x), n)
    assert got.dtype == torch.complex64
    assert snr_db(np.asarray(rtf.rfft(jnp.asarray(x), n)), got.numpy()) \
        >= FFT_DB
    ref64 = np.fft.rfft(x.astype(np.float64), n=n, axis=-1)
    assert snr_db(ref64, got.numpy()) >= FFT_DB
    back = ptf.irfft(got, n)
    assert snr_db(np.asarray(rtf.irfft(jnp.asarray(got.numpy()), n)),
                  back.numpy()) >= FFT_DB
    assert snr_db(np.fft.irfft(ref64, n=n or 128, axis=-1), back.numpy()) \
        >= FFT_DB


@pytest.mark.parametrize("n", [None, 64, 100])
def test_fft_ifft_match_reference_and_numpy(n):
    x = (_signal((4, 64), 12) + 1j * _signal((4, 64), 13)).astype(
        np.complex64)
    got = ptf.fft(torch.from_numpy(x), n)
    assert snr_db(np.asarray(rtf.fft(jnp.asarray(x), n)), got.numpy()) \
        >= FFT_DB
    assert snr_db(np.fft.fft(x.astype(np.complex128), n=n), got.numpy()) \
        >= FFT_DB
    back = ptf.ifft(got, n)
    assert snr_db(np.asarray(rtf.ifft(jnp.asarray(got.numpy()), n)),
                  back.numpy()) >= FFT_DB


@pytest.mark.parametrize("n", [None, 64, 128, 256])
def test_rfft_pair_layout_matches_reference(n):
    x = _signal((2, 6, 128), 14)
    got = ptf.rfft_pair(torch.from_numpy(x), n)
    m = n or 128
    assert got.shape == (2, 6, m + 2) and got.dtype == torch.float32
    ref = np.asarray(rtf.rfft_pair(jnp.asarray(x), n))
    assert snr_db(ref, got.numpy()) >= FFT_DB
    spec = np.fft.rfft(x.astype(np.float64), n=m, axis=-1)
    assert snr_db(np.concatenate([spec.real, spec.imag], -1),
                  got.numpy()) >= FFT_DB
    packed = ptf.pair_to_complex(got)
    assert packed.dtype == torch.complex64
    assert snr_db(np.asarray(rtf.pair_to_complex(jnp.asarray(ref))),
                  packed.numpy()) >= FFT_DB
    np.testing.assert_array_equal(packed.numpy(),
                                  ptf.rfft(torch.from_numpy(x), m).numpy())


def test_rfft_pair_rejects_odd_n_and_methods_are_checked():
    with pytest.raises(ValueError, match="even"):
        ptf.rfft_pair(torch.zeros(2, 9))
    with pytest.raises(ValueError, match="even"):
        ptf.rfft_pair(torch.zeros(2, 16), 9)
    x = torch.from_numpy(_signal((2, 32), 15))
    for method in ("auto", "xla", "matmul"):  # one engine behind each name
        np.testing.assert_array_equal(ptf.rfft(x, method=method).numpy(),
                                      ptf.rfft(x).numpy())
    with pytest.raises(ValueError, match="unknown method"):
        ptf.rfft(x, method="fftw")


@pytest.mark.parametrize("method", ["ols", "direct"])
@pytest.mark.parametrize("ntaps", [96, 256])
def test_fir_filter_matches_reference(method, ntaps):
    taps = rfir.firwin(ntaps, 0.4)
    hlen = rfir.fir_state_len(ntaps, None, method)
    assert pfir.fir_state_len(ntaps, None, method) == hlen
    x = _signal((4, 3000), 16)
    zi = _signal((4, hlen), 17)
    y_ref, zf_ref = rfir.fir_filter(jnp.asarray(x), taps, method=method,
                                    zi=jnp.asarray(zi), return_zf=True)
    y, zf = pfir.fir_filter(torch.from_numpy(x), taps, method=method,
                            zi=torch.from_numpy(zi), return_zf=True)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert snr_db(np.asarray(y_ref), y.numpy()) >= FIR_DB
    np.testing.assert_array_equal(zf.numpy(), np.asarray(zf_ref))
    golden = ss.lfilter(taps, [1.0], np.concatenate(
        [zi[:, hlen - (ntaps - 1):], x], -1).astype(np.float64), axis=-1)
    assert snr_db(golden[:, ntaps - 1:], y.numpy()) >= 125.0


@pytest.mark.parametrize("method", ["ols", "block2"])
def test_fir_filter_streams_bit_exactly_at_its_hop(method):
    ntaps = 256
    taps = pfir.firwin(ntaps, 0.4)
    hop = (pfir.ols_hop(ntaps, pfir.default_nfft(ntaps)) if method == "ols"
           else pfir.block2_block(ntaps))
    x = torch.from_numpy(_signal((2, 5 * hop + 17), 18))
    full = pfir.fir_filter(x, taps, method=method)
    ya, zf = pfir.fir_filter(x[:, : 2 * hop], taps, method=method,
                             return_zf=True)
    yb = pfir.fir_filter(x[:, 2 * hop:], taps, method=method, zi=zf)
    torch.testing.assert_close(torch.cat([ya, yb], -1), full, rtol=0, atol=0)


def test_fir_geometry_helpers_match_reference():
    for ntaps in (2, 96, 129, 256, 1024, 2049):
        assert pfir.fir_halo(ntaps) == rfir.fir_halo(ntaps)
        assert pfir.default_nfft(ntaps) == rfir.default_nfft(ntaps)
        nfft = pfir.default_nfft(ntaps)
        assert pfir.ols_hop(ntaps, nfft) == rfir.ols_hop(ntaps, nfft)
        for method in ("ols", "direct", "block2", "im2col"):
            assert pfir.fir_state_len(ntaps, nfft, method) == \
                rfir.fir_state_len(ntaps, nfft, method)


def test_block2_takes_a_short_history_and_others_reject_it():
    ntaps = 200
    taps = pfir.firwin(ntaps, 0.3)
    block = pfir.block2_block(ntaps)
    x = torch.from_numpy(_signal((8, 3 * block), 19))
    hist = torch.from_numpy(_signal((8, block), 20))
    hist[:, : block - (ntaps - 1)] = 0.0
    full = pfir.fir_filter(x, taps, method="block2", zi=hist)
    for h in (ntaps - 1, ntaps + 10, block):
        y, zf = pfir.fir_filter(x, taps, method="block2",
                                zi=hist[:, block - h:], return_zf=True)
        torch.testing.assert_close(y, full, rtol=0, atol=0)
        assert zf.shape == (8, block)
    with pytest.raises(ValueError, match="zi must hold"):
        pfir.fir_filter(x, taps, method="block2",
                        zi=hist[:, block - (ntaps - 2):])
    with pytest.raises(ValueError, match="zi must hold"):
        pfir.fir_filter(x, taps, method="direct",
                        zi=hist[:, block - (ntaps - 2):])
    # a longer history is taken by its last ntaps − 1 samples
    torch.testing.assert_close(
        pfir.fir_filter(x, taps, method="direct", zi=hist),
        pfir.fir_filter(x, taps, method="direct",
                        zi=hist[:, block - (ntaps - 1):]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="too small"):
        pfir.fir_filter(x, taps, method="ols", nfft=256)

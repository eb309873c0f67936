"""The port's FIR design functions, bit-equal to the JAX package's on the
cases of its own tests (``tests/ops/test_signals.py``,
``tests/ops/test_scipy_parity.py``, ``tests/ops/test_remez.py``).  Both are
host float64 numpy of the same code, so no tolerance applies; the scipy
checks are the JAX tests' own, with their tolerances."""

import numpy as np
import pytest
import scipy.signal as ss

from llzlab_tpu.ops import fir as rfir
from llzlab_tpu.ops.remez import remez as r_remez
import llzlab_tpu_torch as lt
from llzlab_tpu_torch.ops import fir as pfir
from llzlab_tpu_torch.ops.remez import remez as p_remez


@pytest.mark.parametrize("nt,fr,gn", [
    (129, [0, 0.3, 0.5, 1], [1, 1, 0, 0]),
    (101, [0, 0.2, 0.2, 1], [1, 1, 0, 0]),  # step edge (duplicate frequency)
    (64, [0, 0.5, 1], [1, 1, 0]),
    (255, [0, 9600, 14400, 24000], [1, 1, 0, 0]),
])
def test_firwin2_bit_equal(nt, fr, gn):
    fs = 48000.0 if fr[-1] > 1 else 2.0
    h = pfir.firwin2(nt, fr, gn, fs=fs)
    np.testing.assert_array_equal(h, rfir.firwin2(nt, fr, gn, fs=fs))
    np.testing.assert_allclose(h, ss.firwin2(nt, fr, gn, fs=fs), atol=1e-14)


@pytest.mark.parametrize("ripple,width", [(65, 0.05), (30, 0.1), (120, 0.01)])
def test_kaiser_helpers_equal(ripple, width):
    assert pfir.kaiserord(ripple, width) == rfir.kaiserord(ripple, width)
    assert pfir.kaiserord(ripple, width) == ss.kaiserord(ripple, width)
    for a in (10.0, 30.0, ripple):
        assert pfir.kaiser_beta(a) == rfir.kaiser_beta(a) == ss.kaiser_beta(a)
    for n in (101, 1024):
        assert (pfir.kaiser_atten(n, width) == rfir.kaiser_atten(n, width)
                == ss.kaiser_atten(n, width))


@pytest.mark.parametrize("n,bands,desired,weight,fs", [
    (31, [0, 0.2, 0.3, 1.0], [1, 1, 0, 0], None, 2.0),
    (73, [0, 0.1, 0.15, 0.4, 0.45, 1.0], [1, 1, 0.5, 0.5, 0, 0], [1, 2, 10],
     2.0),
    (11, [0, 0.5, 0.6, 1.0], [1, 0.8, 0, 0], [1, 3], 2.0),
    (41, [0, 4800, 7200, 24000], [1, 1, 0, 0], None, 48000.0),
])
def test_firls_bit_equal(n, bands, desired, weight, fs):
    h = pfir.firls(n, bands, desired, weight=weight, fs=fs)
    np.testing.assert_array_equal(
        h, rfir.firls(n, bands, desired, weight=weight, fs=fs))
    np.testing.assert_allclose(
        h, ss.firls(n, bands, desired, weight=weight, fs=fs), atol=1e-12)


def test_firls_even_numtaps_rejected():
    with pytest.raises(ValueError):
        pfir.firls(30, [0, 0.5, 0.6, 1.0], [1, 1, 0, 0])


@pytest.mark.parametrize("n", [31, 63, 64, 127])
def test_minimum_phase_bit_equal(n):
    h = ss.firwin(n, 0.3)
    hm = pfir.minimum_phase(h)
    np.testing.assert_array_equal(hm, rfir.minimum_phase(h))
    np.testing.assert_allclose(hm, ss.minimum_phase(h), atol=1e-5)


def _resp_err(h1, h2, worn=8192):
    _, a = ss.freqz(h1, worN=worn)
    _, b = ss.freqz(h2, worN=worn)
    return float(np.max(np.abs(np.abs(a) - np.abs(b))))


@pytest.mark.parametrize("nt,b,d,w", [
    (65, [0, 0.2, 0.25, 0.5], [1, 0], None),
    (101, [0, 0.15, 0.2, 0.5], [1, 0], [1, 10]),
    (55, [0, 0.1, 0.15, 0.35, 0.4, 0.5], [0, 1, 0], None),  # bandpass
    (64, [0, 0.2, 0.25, 0.5], [1, 0], None),  # type II
    (33, [0, 0.18, 0.24, 0.5], [1, 0], [2, 1]),
    (128, [0, 0.3, 0.35, 0.5], [1, 0], None),
    (181, [0, 0.1, 0.13, 0.37, 0.4, 0.5], [1, 0, 1], [1, 5, 1]),
    (255, [0, 0.22, 0.26, 0.5], [1, 0], None),  # the IRLS fallback
])
def test_remez_bit_equal(nt, b, d, w):
    h = p_remez(nt, b, d, weight=w)
    np.testing.assert_array_equal(h, r_remez(nt, b, d, weight=w))
    assert len(h) == nt
    assert _resp_err(h, ss.remez(nt, b, d, weight=w)) < 2e-3


def test_remez_nyquist_type2_rejected():
    with pytest.raises(ValueError):
        p_remez(64, [0, 0.2, 0.25, 0.5], [1, 1])


def test_design_exports_match_the_reference():
    """The names the JAX package exports for these modules, at the top
    level and in ``ops`` (``resample`` only at the top level, so that it
    never shadows the ``ops.resample`` module; ``ops.resample_fft``)."""
    import llzlab_tpu as rlz
    import llzlab_tpu.ops as rops
    import llzlab_tpu_torch.ops as pops

    top = ["remez", "firwin", "firwin2", "firls", "minimum_phase",
           "kaiserord", "kaiser_beta", "kaiser_atten", "fir_filter",
           "resample", "decimate", "resample_poly", "resample_taps"]
    ops = ["firwin", "firwin2", "firls", "minimum_phase", "kaiserord",
           "kaiser_beta", "kaiser_atten", "fir_filter", "fir_halo",
           "default_nfft", "ols_hop", "fir_state_len", "remez",
           "resample_poly", "resample_taps", "resample_output_len",
           "decimate", "resample_fft"]
    for name in top:
        assert callable(getattr(rlz, name)) and callable(getattr(lt, name))
    for name in ops:
        assert callable(getattr(rops, name)) and callable(getattr(pops, name))
    assert not callable(pops.resample) and not callable(rops.resample)

"""The port's ``ops/compat.py`` against the JAX package and scipy float64 on
the CPU: the designers, conversions and host utilities bit for bit, the
signal path by SNR."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from llzlab_tpu.ops import compat as rc
import llzlab_tpu_torch as lt
from llzlab_tpu_torch.ops import compat as pc
from tests.test_torch_transform import snr_db

#: the signal path against float64: convolution and upfirdn at the JAX
#: package's floor (tests/ops/test_compat.py:162, tests/ops/test_extras.py:25),
#: the envelope at hilbert's (tests/ops/test_extras.py:152); lombscargle's
#: float32 trig sums at the JAX package's 1e-3 of the peak against scipy
#: (tests/ops/test_compat.py:202) and 80 dB against the JAX package's float32
CONV_DB, ENVELOPE_DB, LOMB_REL, LOMB_DB = 110.0, 100.0, 1e-3, 80.0


def _equal(got, want):
    """Bitwise equality of nested tuples / dicts of arrays and scalars."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _equal(got[k], want[k]) for k in want)
    if isinstance(want, tuple):
        return len(got) == len(want) and all(
            _equal(g, w) for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got, want)


DESIGNS = [
    ("butter", (5, 0.3), {}),
    ("butter", (5, 0.4), dict(btype="high", output="sos")),
    ("butter", (4, [0.2, 0.5]), dict(btype="bandpass", output="zpk")),
    ("butter", (6, 4000.0), dict(fs=48000.0, output="sos")),
    ("butter", (3, 100.0), dict(analog=True)),
    ("cheby1", (5, 1.0, 0.3), {}),
    ("cheby1", (4, 0.5, [0.25, 0.6]), dict(btype="bandstop",
                                           output="sos")),
    ("cheby2", (5, 40.0, 0.4), {}),
    ("ellip", (4, 1.0, 40.0, 0.35), dict(output="sos")),
    ("bessel", (4, 0.25), {}),
    ("bessel", (3, 0.2), dict(norm="mag", output="zpk")),
    ("iirfilter", (4, [0.3, 0.6]), dict(rp=1, rs=40, ftype="ellip")),
    ("iirdesign", (0.2, 0.3, 1.0, 40.0), dict(ftype="butter",
                                              output="sos")),
    ("iirdesign", ([0.2, 0.5], [0.1, 0.6], 1.0, 40.0), {}),
    ("buttord", (0.2, 0.3, 1.0, 40.0), {}),
    ("ellipord", ([0.1, 0.6], [0.2, 0.5], 1.0, 40.0), {}),
]


@pytest.mark.parametrize("i", range(len(DESIGNS)))
def test_designers_bit_equal(i):
    name, args, kw = DESIGNS[i]
    assert _equal(getattr(pc, name)(*args, **kw),
                  getattr(rc, name)(*args, **kw))
    if name in ("butter", "cheby1"):  # the top level names the same function
        assert getattr(lt, name) is getattr(pc, name)


def test_conversions_bit_equal():
    b, a = ss.butter(4, 0.3)
    z, p, k = ss.butter(3, 10.0, analog=True, output="zpk")
    sos = ss.butter(5, 0.3, output="sos")
    for fn, args in (("tf2zpk", (b, a)), ("zpk2tf", rc.tf2zpk(b, a)),
                     ("zpk2sos", ss.butter(6, 0.4, output="zpk")),
                     ("sos2tf", (sos,)), ("sos2zpk", (sos,)),
                     ("normalize", ([2.0, 4.0], [2.0, 0.0, 1.0])),
                     ("bilinear_zpk", (z, p, k, 100.0)),
                     ("tf2sos", (b, a))):
        assert _equal(getattr(pc, fn)(*args), getattr(rc, fn)(*args)), fn
    with pytest.raises(ValueError):
        pc.normalize([1.0], [0.0, 0.0])


def test_host_utilities_bit_equal():
    b, a = ss.butter(3, 0.3)
    args = (b, a, [0.5, -0.2, 0.1], [1.0, 0.3, -0.4])
    assert _equal(pc.lfiltic(*args), rc.lfiltic(*args))
    assert _equal(pc.lfiltic(*args[:3]), rc.lfiltic(*args[:3]))
    for sig, div in (([3.0, 2.0, 1.0, 4.0, 5.0, 6.0], [1.0, 2.0, 1.0]),
                     ([1.0, 2.0], [1.0, 2.0, 3.0])):
        assert _equal(pc.deconvolve(sig, div), rc.deconvolve(sig, div))
    bs, as_ = ss.butter(3, 100.0, analog=True)
    for worN in (200, np.logspace(0, 4, 50)):
        assert _equal(pc.freqs(bs, as_, worN), rc.freqs(bs, as_, worN))
    for args in ((7,), (7, "mid"), ((3, 3), (1, 2))):
        assert _equal(pc.unit_impulse(*args), rc.unit_impulse(*args))


@pytest.mark.parametrize("kw", [{}, dict(height=0.5, distance=20),
                                dict(prominence=1.0),
                                dict(threshold=0.05, height=(0.2, 1.5))])
def test_find_peaks_bit_equal(kw):
    rng = np.random.default_rng(4)
    x = np.sin(np.linspace(0, 40, 1000)) + 0.3 * rng.standard_normal(1000)
    x[500:504] = x[500]  # a plateau
    got, want = pc.find_peaks(x, **kw), rc.find_peaks(x, **kw)
    assert _equal(got, want)
    assert _equal(pc.find_peaks(torch.from_numpy(x), **kw), want)
    assert np.array_equal(got[0], ss.find_peaks(x, **kw)[0])


@pytest.mark.parametrize("method", ["direct", "fft"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve_and_oaconvolve(method, mode):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(100).astype(np.float32)
    v = rng.standard_normal(17).astype(np.float32)
    golden = np.convolve(a.astype(np.float64), v.astype(np.float64), mode)
    for x, y in ((a, v), (v, a)):
        got = pc.convolve(torch.from_numpy(x), y, mode=mode, method=method)
        ref = np.asarray(rc.convolve(x, y, mode=mode, method=method))
        assert got.shape == ref.shape == golden.shape
        assert got.dtype == torch.float32
        assert snr_db(ref, got.numpy()) >= CONV_DB
        assert snr_db(golden if x is a else
                      np.convolve(v.astype(np.float64),
                                  a.astype(np.float64), mode),
                      got.numpy()) >= CONV_DB
    got = pc.oaconvolve(torch.from_numpy(a), torch.from_numpy(v), mode=mode)
    assert snr_db(golden, got.numpy()) >= CONV_DB
    # a batch takes the FFT path, as in the JAX package
    batch = np.stack([a, -a])
    got = pc.convolve(torch.from_numpy(batch), v, mode=mode, method=method)
    ref = np.asarray(rc.convolve(batch, v, mode=mode, method=method))
    assert snr_db(ref, got.numpy()) >= CONV_DB


def test_upfirdn_matches_reference_and_scipy():
    x = np.random.default_rng(0).standard_normal((2, 257))
    h = ss.firwin(31, 0.4)
    for up, down in [(1, 1), (3, 2), (2, 3), (7, 5), (1, 4)]:
        got = pc.upfirdn(h, torch.from_numpy(x.astype(np.float32)), up, down)
        ref = np.asarray(rc.upfirdn(h, x.astype(np.float32), up, down))
        golden = ss.upfirdn(h, x.astype(np.float32).astype(np.float64), up,
                            down)
        assert got.shape == ref.shape == golden.shape, (up, down)
        assert got.dtype == torch.float32
        assert snr_db(ref, got.numpy()) >= CONV_DB
        assert snr_db(golden, got.numpy()) >= CONV_DB


def test_analytic_envelope():
    t = np.arange(4096) / 4096
    x = (np.sin(2 * np.pi * 100 * t) *
         (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    env = lt.analytic_envelope(torch.from_numpy(x))
    ref = np.asarray(rc.analytic_envelope(x))
    golden = np.abs(ss.hilbert(x.astype(np.float64)))
    assert env.dtype == torch.float32
    assert snr_db(ref, env.numpy()) >= ENVELOPE_DB
    assert snr_db(golden, env.numpy()) >= ENVELOPE_DB


@pytest.mark.parametrize("precenter,normalize", [(False, False),
                                                 (True, True)])
def test_lombscargle(precenter, normalize):
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 10, 300))
    y = np.sin(2 * np.pi * 1.5 * t) + 0.1 * rng.standard_normal(300)
    freqs = np.linspace(0.5, 30.0, 200)
    got = lt.lombscargle(torch.from_numpy(t), y, freqs, precenter=precenter,
                         normalize=normalize)
    ref = np.asarray(rc.lombscargle(t, y, freqs, precenter=precenter,
                                    normalize=normalize))
    golden = ss.lombscargle(t, y - y.mean() if precenter else y, freqs,
                            normalize=normalize)
    assert got.dtype == torch.float32
    assert snr_db(ref, got.numpy()) >= LOMB_DB
    assert np.abs(got.numpy() - golden).max() / golden.max() < LOMB_REL
    assert abs(freqs[int(torch.argmax(got))] - 2 * np.pi * 1.5) < 0.5

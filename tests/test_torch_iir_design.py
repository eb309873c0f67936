"""The port's IIR design functions against the JAX package's: host float64
numpy of the same code, so every array is bit-equal (no tolerance), for
every designer and band type, the minimum-order functions, the RBJ
sections, ``tf2sos``, the initial conditions and the scan realization."""

import numpy as np
import pytest
import scipy.signal as ss

from llzlab_tpu.ops import iir as riir
import llzlab_tpu_torch as lt
from llzlab_tpu_torch.ops import iir as piir

BANDS = {"lowpass": 0.3, "highpass": 0.4, "bandpass": [0.2, 0.5],
         "bandstop": [0.3, 0.6]}
DESIGNERS = {
    "butter": lambda m, n, wn, bt, fs: m.butter_sos(n, wn, bt, fs=fs),
    "cheby1": lambda m, n, wn, bt, fs: m.cheby1_sos(n, 1.0, wn, bt, fs=fs),
    "cheby2": lambda m, n, wn, bt, fs: m.cheby2_sos(n, 40.0, wn, bt, fs=fs),
    "ellip": lambda m, n, wn, bt, fs: m.ellip_sos(n, 0.5, 50.0, wn, bt,
                                                  fs=fs),
    "bessel": lambda m, n, wn, bt, fs: m.bessel_sos(n, wn, bt, fs=fs),
}
EQ_FREQS = [100, 200, 400, 800, 1600, 3200, 6400, 12800]
EQ_GAINS = [3, -4, 5, -2, 6, -3, 2, -5]


@pytest.mark.parametrize("order", [3, 4])
@pytest.mark.parametrize("btype", list(BANDS))
@pytest.mark.parametrize("designer", list(DESIGNERS))
def test_designers_bit_equal(designer, btype, order):
    fn = DESIGNERS[designer]
    sos = fn(piir, order, BANDS[btype], btype, 2.0)
    np.testing.assert_array_equal(sos, fn(riir, order, BANDS[btype], btype,
                                          2.0))
    assert sos.dtype == np.float64 and sos.shape[1] == 6


@pytest.mark.parametrize("ftype,kw", [
    ("butter", {}), ("cheby1", {"rp": 0.5}), ("cheby2", {"rs": 60.0}),
    ("ellip", {"rp": 1.0, "rs": 40.0}), ("bessel", {"norm": "delay"}),
    ("bessel", {"norm": "mag"}),
])
def test_iirfilter_sos_bit_equal_and_matches_scipy(ftype, kw):
    wn = [6000.0, 9000.0]
    sos = piir.iirfilter_sos(5, wn, btype="bandpass", ftype=ftype, fs=48000,
                             **kw)
    np.testing.assert_array_equal(sos, riir.iirfilter_sos(
        5, wn, btype="bandpass", ftype=ftype, fs=48000, **kw))
    if ftype == "bessel":
        ref = ss.bessel(5, wn, btype="bandpass", fs=48000, output="sos",
                        **kw)
    else:
        ref = ss.iirfilter(5, wn, btype="bandpass", ftype=ftype, fs=48000,
                           output="sos", **kw)
    _, h = ss.sosfreqz(sos, worN=512)
    _, h0 = ss.sosfreqz(ref, worN=512)
    assert np.max(np.abs(h - h0)) < 1e-8


@pytest.mark.parametrize("fn", ["buttord", "cheb1ord", "cheb2ord",
                                "ellipord"])
@pytest.mark.parametrize("wp,ws,fs", [
    (0.2, 0.3, 2.0), (0.4, 0.3, 2.0), ([0.2, 0.5], [0.1, 0.6], 2.0),
    ([4800, 14400], [7200, 9600], 48000.0),
])
def test_minimum_order_bit_equal(fn, wp, ws, fs):
    order, wn = getattr(piir, fn)(wp, ws, 1.0, 40.0, fs=fs)
    r_order, r_wn = getattr(riir, fn)(wp, ws, 1.0, 40.0, fs=fs)
    assert order == r_order
    np.testing.assert_array_equal(wn, r_wn)


@pytest.mark.parametrize("kind", ["peaking", "lowpass", "highpass", "notch",
                                  "lowshelf", "highshelf"])
def test_rbj_sections_bit_equal(kind):
    kw = dict(q=0.9, gain_db=4.5)
    np.testing.assert_array_equal(piir.rbj_biquad(kind, 1000.0, 48000.0, **kw),
                                  riir.rbj_biquad(kind, 1000.0, 48000.0, **kw))
    if kind.endswith("shelf"):
        np.testing.assert_array_equal(
            piir.shelf_sos(kind, 250.0, 48000.0, -3.0),
            riir.shelf_sos(kind, 250.0, 48000.0, -3.0))


def test_peaking_eq_bit_equal():
    np.testing.assert_array_equal(
        lt.peaking_eq_sos(EQ_FREQS, EQ_GAINS, 48000.0, q=1.0),
        riir.peaking_eq_sos(EQ_FREQS, EQ_GAINS, 48000.0, q=1.0))


@pytest.mark.parametrize("ba", [
    ss.butter(4, 0.2), ss.cheby1(5, 1.0, 0.3), ss.ellip(3, 0.5, 40, 0.25),
    ([0.5, 0.0, 0.2], [1.0, -0.3, 0.1, 0.05]),
])
def test_tf2sos_bit_equal(ba):
    b, a = ba
    np.testing.assert_array_equal(piir.tf2sos(b, a), riir.tf2sos(b, a))


@pytest.mark.parametrize("design", ["eq", "butter7", "cheby1_6", "ellip5"])
def test_initial_conditions_bit_equal(design):
    sos = {"eq": piir.peaking_eq_sos(EQ_FREQS, EQ_GAINS, 48000.0),
           "butter7": piir.butter_sos(7, 0.3),
           "cheby1_6": piir.cheby1_sos(6, 1.0, 0.35),
           "ellip5": piir.ellip_sos(5, 0.5, 50.0, 0.2)}[design]
    np.testing.assert_array_equal(piir.sosfilt_zi(sos), riir.sosfilt_zi(sos))
    np.testing.assert_array_equal(piir.sosfilt_zi_scan(sos),
                                  riir.sosfilt_zi_scan(sos))
    b, a = ss.sos2tf(sos)
    np.testing.assert_array_equal(piir.lfilter_zi(b, a),
                                  riir.lfilter_zi(b, a))


@pytest.mark.parametrize("design", ["eq", "butter7"])
def test_realization_and_plan_equal(design):
    """Per row: the realization (coupled for complex poles, companion for
    real ones) and its float64 coefficients, the f64-powered transition
    over a scan block and over the iir tool's block, and the plan's kinds.
    The plan's float64 coefficients are the realization's; the JAX
    package's plan keeps float32 copies of the same values."""
    sos = (piir.peaking_eq_sos(EQ_FREQS, EQ_GAINS, 48000.0) if design == "eq"
           else piir.butter_sos(7, 0.3))
    kinds, params = piir.sos_plan(sos)
    r_kinds, r_params = riir.sos_plan(sos)
    assert kinds == r_kinds
    assert ("companion" in kinds) == (design == "butter7")
    for row, kind, prm in zip(sos, kinds, params):
        k, p = piir.section_realization(row)
        rk, rp = riir.section_realization(row)
        assert k == rk == kind
        np.testing.assert_array_equal(np.asarray(p), np.asarray(rp))
        np.testing.assert_array_equal(prm, np.asarray(p, np.float64))
        for n in (1, 4096, 94208):
            np.testing.assert_array_equal(piir.section_transition(row, n),
                                          riir.section_transition(row, n))
    a, b = piir.sos_state_matrices(sos)
    ra, rb = riir.sos_state_matrices(sos)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))


def test_plan_rejects_bad_sections():
    with pytest.raises(ValueError, match=r"\(ns, 6\)"):
        piir.sos_plan(np.ones((2, 5)))
    with pytest.raises(ValueError, match="a0 == 1"):
        piir.sos_plan(np.array([[1.0, 0, 0, 2.0, 0, 0]]))

"""scipy.signal-compatible front doors over the port's engines (port of
``llzlab_tpu/ops/compat.py``).

Coefficient math (the designers, the representation conversions, initial
conditions, ``deconvolve``, ``freqs``, ``unit_impulse`` and the peak
selection of ``find_peaks``) is host-side float64 numpy over the private
helpers of ``ops/iir.py``: the JAX package's code copied, so the results
are bit-equal.  On the signal path the functions return float32 tensors on
the input's device: ``convolve`` (a plain direct convolution for
``method="direct"`` on 1-D inputs, else ``ops.convolve.fftconvolve``),
``oaconvolve``, ``upfirdn``, ``analytic_envelope`` and ``lombscargle``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.ops import iir as _iir
from llzlab_tpu_torch.ops.iir import (  # noqa: F401  (re-exported)
    buttord, cheb1ord, cheb2ord, ellipord, tf2sos,
)
from llzlab_tpu_torch.ops.analysis import hilbert as _hilbert
from llzlab_tpu_torch.ops.convolve import (
    MODES, cut_mode, f32_on_one_device, fftconvolve as _fftconvolve,
)

__all__ = [
    "butter", "cheby1", "cheby2", "ellip", "bessel", "iirfilter",
    "iirdesign",
    "bilinear_zpk", "zpk2tf", "tf2zpk", "zpk2sos", "sos2tf", "sos2zpk",
    "normalize",
    "lfiltic", "deconvolve", "freqs",
    "convolve", "oaconvolve", "upfirdn",
    "analytic_envelope", "unit_impulse", "lombscargle", "find_peaks",
    "buttord", "cheb1ord", "cheb2ord", "ellipord", "tf2sos",
]


# ---------------------------------------------------------------------------
# zpk-level design (scipy signatures)
# ---------------------------------------------------------------------------

_PROTOS = {
    "butter": lambda n, rp, rs: _iir._buttap(n),
    "cheby1": lambda n, rp, rs: _iir._cheb1ap(n, rp),
    "cheby2": lambda n, rp, rs: _iir._cheb2ap(n, rs),
    "ellip": lambda n, rp, rs: _iir._ellipap(n, rp, rs),
    "bessel": lambda n, rp, rs: _iir._besselap(n, "phase"),
}


def _design_zpk(ftype, n, wn, btype, analog, fs, rp=None, rs=None,
                proto=None):
    z, p, k = proto if proto is not None else _PROTOS[ftype](n, rp, rs)
    wn = np.atleast_1d(np.asarray(wn, np.float64))
    btype = btype.lower()
    if analog:
        if fs is not None:
            raise ValueError("fs cannot be given for analog filters")
        warped = wn
    else:
        if fs is not None:
            wn = wn * 2.0 / fs
        if np.any(wn <= 0) or np.any(wn >= 1):
            raise ValueError("digital critical frequencies must lie in "
                             "(0, 1) (Nyquist units) or (0, fs/2)")
        fs_d = 2.0
        warped = 2.0 * fs_d * np.tan(np.pi * wn / fs_d)
    if btype in ("lowpass", "low", "lp"):
        z, p, k = _iir._lp2lp(z, p, k, warped[0])
    elif btype in ("highpass", "high", "hp"):
        z, p, k = _iir._lp2hp(z, p, k, warped[0])
    elif btype in ("bandpass", "bp", "band", "pass"):
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _iir._lp2bp(z, p, k, wo, bw)
    elif btype in ("bandstop", "bs", "notch", "stop"):
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _iir._lp2bs(z, p, k, wo, bw)
    else:
        raise ValueError(f"unknown btype {btype!r}")
    if not analog:
        z, p, k = _iir._bilinear_zpk(z, p, k, 2.0)
    return z, p, float(np.real(k))


def _to_output(z, p, k, output):
    output = output.lower()
    if output == "zpk":
        return z, p, k
    if output == "sos":
        return _iir._zpk2sos(z, p, k)
    if output == "ba":
        return zpk2tf(z, p, k)
    raise ValueError(f"unknown output {output!r}")


def butter(N, Wn, btype="low", analog=False, output="ba", fs=None):
    """Butterworth design, scipy.signal.butter-compatible."""
    return _to_output(*_design_zpk("butter", N, Wn, btype, analog, fs),
                      output)


def cheby1(N, rp, Wn, btype="low", analog=False, output="ba", fs=None):
    return _to_output(
        *_design_zpk("cheby1", N, Wn, btype, analog, fs, rp=rp), output)


def cheby2(N, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    return _to_output(
        *_design_zpk("cheby2", N, Wn, btype, analog, fs, rs=rs), output)


def ellip(N, rp, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    return _to_output(
        *_design_zpk("ellip", N, Wn, btype, analog, fs, rp=rp, rs=rs),
        output)


def bessel(N, Wn, btype="low", analog=False, output="ba", norm="phase",
           fs=None):
    return _to_output(
        *_design_zpk("bessel", N, Wn, btype, analog, fs,
                     proto=_iir._besselap(N, norm)),
        output)


def iirfilter(N, Wn, rp=None, rs=None, btype="band", analog=False,
              ftype="butter", output="ba", fs=None):
    """scipy.signal.iirfilter-compatible generic design."""
    return _to_output(
        *_design_zpk(ftype, N, Wn, btype, analog, fs, rp=rp, rs=rs),
        output)


_ORD = {"butter": buttord, "cheby1": cheb1ord, "cheby2": cheb2ord,
        "ellip": ellipord}


def iirdesign(wp, ws, gpass, gstop, analog=False, ftype="ellip",
              output="ba", fs=None):
    """Design from band-edge specs: minimum order via the *ord rules,
    then the corresponding designer (scipy.signal.iirdesign analog;
    analog designs are not supported — the reference lab is digital)."""
    if analog:
        raise NotImplementedError("iirdesign supports digital only")
    if ftype not in _ORD:
        raise ValueError(f"ftype {ftype!r} not supported")
    fs_eff = 2.0 if fs is None else fs
    n, wn = _ORD[ftype](wp, ws, gpass, gstop, fs=fs_eff)
    kw = {}
    if ftype in ("cheby1", "ellip"):
        kw["rp"] = gpass
    if ftype in ("cheby2", "ellip"):
        kw["rs"] = gstop
    return _to_output(
        *_design_zpk(ftype, n, wn, _iir._ord_btype(wp, ws), False, fs,
                     **kw),
        output)


# ---------------------------------------------------------------------------
# representation conversions (host-side f64)
# ---------------------------------------------------------------------------

def zpk2tf(z, p, k):
    b = np.atleast_1d(k * np.poly(np.asarray(z, complex)))
    a = np.atleast_1d(np.poly(np.asarray(p, complex)))
    if np.all(np.abs(b.imag) < 1e-12 * np.maximum(1, np.abs(b.real).max())):
        b = b.real
    if np.all(np.abs(a.imag) < 1e-12 * np.maximum(1, np.abs(a.real).max())):
        a = a.real
    return b, a


def tf2zpk(b, a):
    b, a = normalize(b, a)
    z = np.roots(b) if len(b) > 1 else np.array([])
    p = np.roots(a) if len(a) > 1 else np.array([])
    k = b[0] / a[0]
    return z, p, k


def zpk2sos(z, p, k):
    """zpk → second-order sections via the design pipeline's pairing.

    Pairing order differs from scipy's (compare frequency responses,
    not raw rows)."""
    return _iir._zpk2sos(z, p, k)


def sos2tf(sos):
    sos = np.asarray(sos, np.float64)
    b, a = np.ones(1), np.ones(1)
    for row in sos:
        b = np.convolve(b, row[:3])
        a = np.convolve(a, row[3:])
    return b, a


def sos2zpk(sos):
    b, a = sos2tf(sos)
    return tf2zpk(b, a)


def normalize(b, a):
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    a = np.trim_zeros(a, "f")
    if a.size == 0 or a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    return b / a[0], a / a[0]


def bilinear_zpk(z, p, k, fs):
    """Analog zpk → digital zpk via the bilinear transform
    (scipy.signal.bilinear_zpk)."""
    return _iir._bilinear_zpk(
        np.asarray(z, complex), np.asarray(p, complex), float(k),
        float(fs))


# ---------------------------------------------------------------------------
# filtering utilities
# ---------------------------------------------------------------------------

def lfiltic(b, a, y, x=None):
    """Initial conditions for :func:`llzlab_tpu_torch.lfilter` reproducing past
    outputs ``y = [y[-1], y[-2], …]`` / inputs ``x`` (scipy.signal.lfiltic,
    direct-form II transposed)."""
    b, a = normalize(b, a)
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    y = np.asarray(y, np.float64)
    x = np.zeros(0) if x is None else np.asarray(x, np.float64)
    zi = np.zeros(n - 1)
    for m in range(n - 1):
        s = 0.0
        for i in range(m + 1, n):
            if i - m - 1 < len(x):
                s += b[i] * x[i - m - 1]
            if i - m - 1 < len(y):
                s -= a[i] * y[i - m - 1]
        zi[m] = s
    return zi


def deconvolve(signal, divisor):
    """Polynomial long division: ``signal = conv(divisor, quot) + rem``
    (scipy.signal.deconvolve, host-side f64)."""
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if den[0] == 0:
        raise ValueError("divisor[0] must be nonzero")
    if len(num) < len(den):
        return np.array([0.0]), num.copy()
    nq = len(num) - len(den) + 1
    quot = np.zeros(nq)
    rem = num.copy()
    for i in range(nq):
        quot[i] = rem[i] / den[0]
        rem[i : i + len(den)] -= quot[i] * den
    return quot, rem


def freqs(b, a, worN=200):
    """Analog transfer-function frequency response H(jω)
    (scipy.signal.freqs)."""
    if np.isscalar(worN):
        b_, a_ = normalize(b, a)
        roots = np.concatenate([
            np.roots(b_) if len(b_) > 1 else np.zeros(0),
            np.roots(a_) if len(a_) > 1 else np.zeros(0),
        ])
        mags = np.abs(roots[np.abs(roots) > 0])
        hi = 10.0 * (mags.max() if mags.size else 1.0)
        w = np.logspace(np.log10(hi) - 4, np.log10(hi), int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = np.polyval(np.atleast_1d(b), s) / np.polyval(np.atleast_1d(a), s)
    return w, h


# ---------------------------------------------------------------------------
# convolution family (the FFT path underneath)
# ---------------------------------------------------------------------------

def _direct_convolve(a: torch.Tensor, v: torch.Tensor, mode: str):
    """1-D convolution as one ``conv1d`` over the zero-padded longer
    signal with the flipped shorter one (cuDNN on a CUDA tensor, TF32 off),
    cut to ``mode`` as ``numpy.convolve`` cuts it."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    na, nv = a.shape[-1], v.shape[-1]
    long_, short = (a, v) if na >= nv else (v, a)
    ns = short.shape[-1]
    y = F.conv1d(F.pad(long_, (ns - 1, ns - 1))[None, None],
                 torch.flip(short, dims=(-1,))[None, None])[0, 0]
    return cut_mode(y, na, nv, mode)


def convolve(in1, in2, mode="full", method="auto"):
    """1-D convolution on the last axis (scipy.signal.convolve for 1-D);
    ``method`` "fft" / "auto" run the FFT path, "direct" a plain direct
    convolution on 1-D inputs (the FFT path on any other)."""
    a, v = f32_on_one_device(in1, in2)
    if method == "direct" and a.ndim == 1 and v.ndim == 1:
        return _direct_convolve(a, v, mode)
    return _fftconvolve(a, v, mode=mode)


def oaconvolve(in1, in2, mode="full"):
    """Overlap-add convolution with scipy.oaconvolve's 1-D semantics, on
    the FFT path in one piece (as the JAX package: a separate overlap-add
    segmentation changes no value)."""
    return _fftconvolve(in1, in2, mode=mode)


def upfirdn(h, x, up=1, down=1):
    """Upsample–FIR–downsample with scipy.signal.upfirdn's output length,
    on the FFT convolution path: zero-stuff by ``up``, convolve "full" with
    ``h``, take every ``down``-th sample."""
    x, h = f32_on_one_device(x, h)
    n_in = x.shape[-1]
    if up > 1:
        xs = x.new_zeros(x.shape[:-1] + (n_in, up))
        xs[..., 0] = x
        x = xs.reshape(x.shape[:-1] + (n_in * up,))[
            ..., : (n_in - 1) * up + 1]
    y = _fftconvolve(x, h, mode="full")
    return y[..., ::down]


# ---------------------------------------------------------------------------
# analysis utilities
# ---------------------------------------------------------------------------

def analytic_envelope(x, n: Optional[int] = None):
    """Analytic-signal amplitude envelope ``|hilbert(x)|``.

    NOT scipy.signal.envelope (which takes bp_in/n_out/residual and
    returns a stacked (2, ...) envelope+residual array): this helper
    carries a non-scipy name so the scipy-compatible names stay exact.
    """
    return _hilbert(x, n).abs()


def unit_impulse(shape, idx=None, dtype=np.float64):
    """scipy.signal.unit_impulse."""
    out = np.zeros(shape, dtype)
    if idx is None:
        idx = (0,) * out.ndim
    elif idx == "mid":
        idx = tuple(s // 2 for s in out.shape)
    out[idx] = 1
    return out


def lombscargle(x, y, freqs, precenter=False, normalize=False):
    """Lomb–Scargle periodogram for unevenly sampled data
    (scipy.signal.lombscargle's classic Scargle formulation), float32 on
    the device of the first tensor argument: the trig sums over an
    ``(F, N)`` outer product, the projections two matrix-vector products."""
    x, y, freqs = f32_on_one_device(x, y, freqs)
    if precenter:
        y = y - torch.mean(y)
    wt = freqs[:, None] * x[None, :]            # (F, N)
    s2 = torch.sum(torch.sin(2 * wt), dim=1)
    c2 = torch.sum(torch.cos(2 * wt), dim=1)
    tau_arg = 0.5 * torch.atan2(s2, c2)         # ω·τ
    wtt = wt - tau_arg[:, None]
    cw = torch.cos(wtt)
    sw = torch.sin(wtt)
    yc = cw @ y
    ys = sw @ y
    cc = torch.sum(cw * cw, dim=1)
    ss = torch.sum(sw * sw, dim=1)
    p = 0.5 * (yc * yc / cc + ys * ys / ss)
    if normalize:
        p = p * 2.0 / torch.sum(y * y)
    return p


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None):
    """Local-maxima finder (scipy.signal.find_peaks subset: height,
    threshold, distance, prominence; plateaus resolve to their middle
    sample like scipy).  Host-side numpy: the selection is data-dependent
    control flow; a tensor input is copied to the host first."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError("find_peaks expects a 1-D signal")
    # plateau-aware local maxima (scipy's midpoint convention)
    peaks = []
    i, n = 1, len(x)
    while i < n - 1:
        if x[i - 1] < x[i]:
            if x[i + 1] < x[i]:
                peaks.append(i)
            elif x[i + 1] == x[i]:
                j = i
                while j < n - 1 and x[j + 1] == x[j]:
                    j += 1
                if j < n - 1 and x[j + 1] < x[i]:
                    peaks.append((i + j) // 2)
                i = j
        i += 1
    peaks = np.asarray(peaks, np.intp)
    props = {}

    def _minmax(interval):
        v = np.asarray(interval, np.float64)
        return (v[0], v[1]) if v.ndim else (float(v), np.inf)

    if height is not None:
        hmin, hmax = _minmax(height)
        keep = (x[peaks] >= hmin) & (x[peaks] <= hmax)
        peaks = peaks[keep]
    if threshold is not None:
        tmin, tmax = _minmax(threshold)
        left = x[peaks] - x[peaks - 1]
        right = x[peaks] - x[peaks + 1]
        t = np.minimum(left, right)
        keep = (t >= tmin) & (t <= tmax)
        peaks = peaks[keep]
    if prominence is not None or distance is not None:
        prom = _prominences(x, peaks)
    if prominence is not None:
        pmin, pmax = _minmax(prominence)
        keep = (prom >= pmin) & (prom <= pmax)
        peaks, prom = peaks[keep], prom[keep]
    if distance is not None:
        # scipy: highest peaks claim their neighbourhood first
        order = np.argsort(x[peaks])[::-1]
        keep = np.ones(len(peaks), bool)
        for idx in order:
            if not keep[idx]:
                continue
            close = np.abs(peaks - peaks[idx]) < distance
            close[idx] = False
            keep[close] = False
        peaks = peaks[keep]
    if prominence is not None:
        props["prominences"] = _prominences(x, peaks)
    if height is not None:
        props["peak_heights"] = x[peaks]
    return peaks, props


def _prominences(x, peaks):
    prom = np.zeros(len(peaks))
    for n, p in enumerate(peaks):
        h = x[p]
        # walk left until a higher sample or the border
        lo_l = h
        i = p - 1
        m = h
        while i >= 0 and x[i] <= h:
            m = min(m, x[i])
            i -= 1
        lo_l = m if i >= 0 else min(m, x[: p + 1].min())
        lo_r = h
        i = p + 1
        m = h
        while i < len(x) and x[i] <= h:
            m = min(m, x[i])
            i += 1
        lo_r = m if i < len(x) else min(m, x[p:].min())
        prom[n] = h - max(lo_l, lo_r)
    return prom

"""IIR filter design and blockwise-scan filtering (port of
``llzlab_tpu/ops/iir.py``).

Design is host-side float64 numpy, the JAX package's code copied, so the
sections, orders and initial conditions are bit-equal to its own.
Filtering re-expresses each biquad as a two-state linear recurrence in its
scan realization (:func:`section_realization`):

* coupled form (complex poles): ``w[n] = p·w[n−1] + x[n]`` with the state
  ``(Re w, Im w)``, ``y[n] = b0·x[n] + c1·Re w[n−1] + c2·Im w[n−1]``;
* companion form (real poles): ``s[n] = A·s[n−1] + B·x[n]``,
  ``y[n] = b0·x[n] + s[n−1][0]``.

Both are ``s[n] = P·s[n−1] + u[n]`` with a 2×2 ``P``, and the engine runs
one code for both.  The signal is cut into blocks of ``block_size`` = L
samples, and per section (:func:`apply_section`):

1. the zero-state scan of every block at once: a doubling over the L axis
   of a ``(B, nblk, L, 2)`` view, step i adding ``P^(2^i)`` times the
   state ``2^i`` samples back inside the block (``ceil(log2 L)`` steps of
   four elementwise launches over the whole signal);
2. the carry across blocks, ``s_j = z_j[L−1] + P^L·s_{j−1}`` from ``zi``:
   the one sequential part, a loop over the ``(B, nblk, 2)`` block end
   states on the host (one copy each way: a few kilobytes; the span
   ``llz/ops/sos_carry``);
3. the output with the carry folded in,
   ``y[j, k] = b0·x + c·z[j, k−1] + (cᵀP^k)·s_{j−1}``.

The powers of ``P`` are computed in float64 on the host and rounded to
float32 once.  Block j's bits depend only on its own input and on
``s_{j−1}``, and the state returned (``zf``, at sample ``t − 1``) is
computed by the carry's own expression, so splitting a stream at any
multiple of ``block_size`` and carrying ``zf`` reproduces the unsplit
output and states bit for bit, on either device.  Steps 1 to 3 use only
separate float32 ``mul``, ``add`` and ``sub`` (no fused or complex
products), which round alike on a CPU's vector and scalar paths and on
the card.  The states interchange with the JAX package's and with
:func:`llzlab_tpu_torch.ops.iir_matmul.sosfilt_matmul`'s.

No Pallas kernel backs this module in the JAX package (its biquad scan is
``lax.associative_scan`` inside blocks and ``lax.scan`` across them).  On
the CPU the port runs the steps above as tensor code.  On a CUDA tensor
:func:`sosfilt` launches the hand-written kernel
:mod:`llzlab_tpu_torch.kernels.sos_scan` instead: every section of every
block in one launch, the carry kept on the card, bit for bit the tensor
code.  :func:`apply_section` and :func:`apply_section_host` stay tensor
code on every device (the sharded composition needs host states).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.kernels import sos_scan as _sos_scan
from llzlab_tpu_torch.runtime.profiler import count_state_reads, span

__all__ = [
    "butter_sos",
    "cheby1_sos",
    "cheby2_sos",
    "ellip_sos",
    "bessel_sos",
    "iirfilter_sos",
    "buttord",
    "cheb1ord",
    "cheb2ord",
    "ellipord",
    "peaking_eq_sos",
    "shelf_sos",
    "rbj_biquad",
    "sosfilt",
    "sosfiltfilt",
    "filtfilt",
    "lfilter",
    "lfilter_zi",
    "sosfilt_zi",
    "sosfilt_zi_scan",
    "tf2sos",
    "sos_state_matrices",
    "sos_plan",
    "padded_len",
    "apply_section",
    "section_transition",
    "section_realization",
]


# ---------------------------------------------------------------------------
# Design (host-side, float64, zpk pipeline)
# ---------------------------------------------------------------------------


def _buttap(n: int):
    k = np.arange(1, n + 1)
    theta = np.pi * (2 * k - 1) / (2 * n)
    p = -np.sin(theta) + 1j * np.cos(theta)  # left-half-plane unit circle
    return np.array([]), p, 1.0


def _cheb1ap(n: int, rp: float):
    eps = np.sqrt(10.0 ** (rp / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / n
    k = np.arange(1, n + 1)
    theta = np.pi * (2 * k - 1) / (2 * n)
    p = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    gain = np.real(np.prod(-p))
    if n % 2 == 0:
        gain /= np.sqrt(1.0 + eps * eps)
    return np.array([]), p, gain


def _cheb2ap(n: int, rs: float):
    """Inverse-Chebyshev (type II) analog prototype: monotone passband,
    equiripple stopband ``rs`` dB down, stopband edge at ω=1."""
    de = 1.0 / np.sqrt(10.0 ** (rs / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / de) / n
    k = np.arange(1, n + 1)
    theta = np.pi * (2 * k - 1) / (2 * n)
    # Type-I poles for the reciprocal filter, then invert into the stopband.
    p1 = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    p = 1.0 / p1
    # Zeros where T_n(1/ω) = 0 → s = ±j/cos(θ_k); an odd order's middle
    # node (θ = π/2, cos = 0) is the zero at infinity and is dropped.
    if n % 2:
        theta_z = np.delete(theta, n // 2)
    else:
        theta_z = theta
    z = 1j / np.cos(theta_z)
    gain = np.real(np.prod(-p) / np.prod(-z))
    return z, p, gain


# --- Jacobi elliptic machinery (Landen recursion; standard textbook math) --


def _landen_seq(k: float, iters: int = 12) -> np.ndarray:
    """Descending Landen sequence k → 0 (quadratic convergence)."""
    ks = []
    for _ in range(iters):
        kp = np.sqrt(max(0.0, 1.0 - k * k))
        k = (k / (1.0 + kp)) ** 2
        ks.append(k)
        if k < 1e-300:
            break
    return np.asarray(ks)


def _ellipk(k: float) -> float:
    """Complete elliptic integral of the first kind, modulus ``k``."""
    return float(np.prod(1.0 + _landen_seq(k)) * np.pi / 2.0)


def _cde(u, k: float):
    """Jacobi ``cd(u·K(k), k)`` for normalized (possibly complex) ``u``."""
    ks = _landen_seq(k)
    w = np.cos(np.asarray(u) * np.pi / 2.0)
    for kn in ks[::-1]:
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _sne(u, k: float):
    """Jacobi ``sn(u·K(k), k)`` for normalized (possibly complex) ``u``."""
    ks = _landen_seq(k)
    w = np.sin(np.asarray(u) * np.pi / 2.0)
    for kn in ks[::-1]:
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _asne(w, k: float):
    """Inverse sn, normalized: returns ``u`` with ``sn(u·K, k) = w``."""
    ks = np.concatenate([[k], _landen_seq(k)])
    w = np.asarray(w, dtype=complex)
    for n in range(1, len(ks)):
        w = 2.0 * w / ((1.0 + ks[n]) * (1.0 + np.sqrt(1.0 - (ks[n - 1] * w) ** 2)))
    return 2.0 / np.pi * np.arcsin(w)


def _ellip_degree_k(n: int, k1: float) -> float:
    """Solve the elliptic degree equation for the selectivity modulus ``k``
    given order ``n`` and discrimination modulus ``k1`` via nome duality:
    ``q = q1^(1/n)``, then ``k = (θ2(q)/θ3(q))²``."""
    k1p = np.sqrt(1.0 - k1 * k1)
    q1 = np.exp(-np.pi * _ellipk(k1p) / _ellipk(k1))
    q = q1 ** (1.0 / n)
    m = np.arange(1, 16)
    theta2 = 2.0 * q**0.25 * (1.0 + np.sum(q ** (m * (m + 1))))
    theta3 = 1.0 + 2.0 * np.sum(q ** (m * m))
    return float((theta2 / theta3) ** 2)


def _ellipap(n: int, rp: float, rs: float):
    """Elliptic (Cauer) analog prototype: ``rp`` dB passband ripple,
    ``rs`` dB stopband attenuation, passband edge at ω=1.

    Zeros/poles via the Jacobi-cd rational characteristic (Landen
    recursion); the degree equation fixes the transition selectivity.
    """
    if n == 1:
        # Degenerates to a real pole at the rp-dB point.
        p = -np.sqrt(1.0 / (10.0 ** (rp / 10.0) - 1.0))
        return np.array([]), np.array([p], dtype=complex), -p
    ep = np.sqrt(10.0 ** (rp / 10.0) - 1.0)
    es = np.sqrt(10.0 ** (rs / 10.0) - 1.0)
    k1 = ep / es
    k = _ellip_degree_k(n, k1)
    L, r = n // 2, n % 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / n
    zeta = _cde(ui, k)  # real, in (0, 1)
    za = 1j / (k * zeta)  # upper-half-plane zeros
    v0 = float(np.real(-1j * _asne(1j / ep, k1) / n))
    pa = 1j * _cde(ui - 1j * v0, k)  # upper-half-plane poles
    z = np.concatenate([za, np.conj(za)])
    p = np.concatenate([pa, np.conj(pa)])
    if r:
        p0 = 1j * _sne(1j * v0, k)
        p = np.append(p, complex(np.real(p0), 0.0))
    gain = np.real(np.prod(-p) / np.prod(-z))
    if r == 0:
        gain *= 10.0 ** (-rp / 20.0)
    return z, p, gain


def _bessel_poly_roots(n: int) -> np.ndarray:
    """Roots of the degree-n reverse Bessel polynomial θ_n(s)."""
    # a_k = (2n−k)! / (2^{n−k} k! (n−k)!), k = 0..n  (highest power first
    # for np.roots).
    from math import factorial

    coeffs = [
        factorial(2 * n - k) / (2 ** (n - k) * factorial(k) * factorial(n - k))
        for k in range(n, -1, -1)
    ]
    return np.roots(np.asarray(coeffs, np.float64))


def _besselap(n: int, norm: str = "phase"):
    """Bessel/Thomson analog prototype (maximally flat group delay).

    ``norm``: "delay" → unit group delay at DC; "phase" → poles scaled by
    the geometric mean of their magnitudes, ``(θ_n(0))^(1/n)``, so the
    asymptotic Bode phase crosses its midpoint at ω=1 (scipy's default);
    "mag" → −3 dB at ω=1 (numeric).
    """
    p = _bessel_poly_roots(n)

    def mag2(w):
        k0 = np.real(np.prod(-p))
        return np.abs(k0 / np.prod(1j * w - p)) ** 2 - 0.5

    if norm == "delay":
        scale = 1.0
    elif norm == "phase":
        scale = np.real(np.prod(-p)) ** (1.0 / n)
    elif norm == "mag":
        lo, hi = 1e-6, 1e6
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if mag2(mid) > 0:
                lo = mid
            else:
                hi = mid
        scale = 0.5 * (lo + hi)
    else:
        raise ValueError(f"unknown bessel norm {norm!r}")
    p = p / scale
    gain = np.real(np.prod(-p))
    return np.array([]), p, gain


def _lp2lp(z, p, k, wo):
    degree = len(p) - len(z)
    return z * wo, p * wo, k * wo**degree


def _lp2hp(z, p, k, wo):
    degree = len(p) - len(z)
    zh = wo / z if len(z) else np.array([])
    ph = wo / p
    kh = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(
        1.0 / np.prod(-p)
    )
    zh = np.append(zh, np.zeros(degree))
    return zh, ph, kh


def _lp2bp(z, p, k, wo, bw):
    degree = len(p) - len(z)
    z_s, p_s = z * bw / 2.0, p * bw / 2.0
    z_b = np.concatenate(
        [z_s + np.sqrt(z_s**2 - wo**2), z_s - np.sqrt(z_s**2 - wo**2)]
    ) if len(z) else np.array([])
    p_b = np.concatenate(
        [p_s + np.sqrt(p_s**2 - wo**2), p_s - np.sqrt(p_s**2 - wo**2)]
    )
    z_b = np.append(z_b, np.zeros(degree))
    return z_b, p_b, k * bw**degree


def _lp2bs(z, p, k, wo, bw):
    degree = len(p) - len(z)
    z_i = (bw / 2.0) / z if len(z) else np.array([])
    p_i = (bw / 2.0) / p
    z_b = np.concatenate(
        [z_i + np.sqrt(z_i**2 - wo**2), z_i - np.sqrt(z_i**2 - wo**2)]
    ) if len(z) else np.array([])
    p_b = np.concatenate(
        [p_i + np.sqrt(p_i**2 - wo**2), p_i - np.sqrt(p_i**2 - wo**2)]
    )
    z_b = np.concatenate([z_b, np.full(degree, 1j * wo), np.full(degree, -1j * wo)])
    kb = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(
        1.0 / np.prod(-p)
    )
    return z_b, p_b, kb


def _bilinear_zpk(z, p, k, fs: float):
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z) if len(z) else np.array([])
    pd = (fs2 + p) / (fs2 - p)
    degree = len(p) - len(z)
    zd = np.append(zd, -np.ones(degree))
    num = np.prod(fs2 - z) if len(z) else 1.0
    kd = k * np.real(num / np.prod(fs2 - p))
    return zd, pd, kd


def _split_conjugates(roots: np.ndarray):
    """Split roots into (conjugate-pair representatives, real roots)."""
    tol = 1e-9 * max(1.0, np.max(np.abs(roots)) if len(roots) else 1.0)
    complex_r = [r for r in roots if abs(r.imag) > tol]
    real_r = [r.real for r in roots if abs(r.imag) <= tol]
    pos = sorted(
        (r for r in complex_r if r.imag > 0), key=lambda r: (-abs(r), r.real)
    )
    return pos, sorted(real_r, key=lambda r: -abs(r))


def _zpk2sos(z, p, k) -> np.ndarray:
    """Pair poles and zeros into second-order sections.

    Strategy: conjugate pole pairs (sorted nearest the unit circle first)
    each take the nearest remaining conjugate zero pair; real poles pair up
    amongst themselves with real zeros.  The overall gain is applied to the
    first section.  (The reference cascades RBJ-style sections directly; the
    sections here are numerically well-scaled for f32 state recurrences.)
    """
    z, p = np.asarray(z, dtype=complex), np.asarray(p, dtype=complex)
    if len(z) > len(p):
        raise ValueError("more zeros than poles")
    p_pairs, p_real = _split_conjugates(p)
    z_pairs, z_real = _split_conjugates(z)

    sections = []
    z_pairs = list(z_pairs)
    z_real = list(z_real)
    # Conjugate pole pairs, closest to unit circle first.
    for pp in sorted(p_pairs, key=lambda r: -abs(r)):
        if z_pairs:
            j = int(np.argmin([abs(zz - pp) for zz in z_pairs]))
            zz = z_pairs.pop(j)
            num = np.poly([zz, np.conj(zz)]).real
        elif len(z_real) >= 2:
            j = int(np.argmin([abs(zr - pp.real) for zr in z_real]))
            zr1 = z_real.pop(j)
            j = int(np.argmin([abs(zr - pp.real) for zr in z_real]))
            zr2 = z_real.pop(j)
            num = np.poly([zr1, zr2]).real
        elif z_real:
            num = np.append(np.poly([z_real.pop(0)]).real, 0.0)
            num = np.array([0.0, num[0], num[1]])
        else:
            num = np.array([0.0, 0.0, 1.0])[::-1]  # [1, 0, 0]
        den = np.poly([pp, np.conj(pp)]).real
        sections.append(np.concatenate([num, den]))
    # Real poles: pair them up two at a time.
    p_real = list(p_real)
    while p_real:
        pr1 = p_real.pop(0)
        pr2 = p_real.pop(0) if p_real else None
        den = np.poly([pr1, pr2]).real if pr2 is not None else np.append(
            np.poly([pr1]).real, 0.0
        )
        nzs = []
        for _ in range(2 if pr2 is not None else 1):
            if z_real:
                nzs.append(z_real.pop(0))
        if z_pairs and len(nzs) == 0 and pr2 is not None:
            zz = z_pairs.pop(0)
            nzs = [zz, np.conj(zz)]
        num = np.poly(nzs).real if nzs else np.array([1.0])
        num = np.pad(num, (0, 3 - len(num)))
        den = np.pad(den, (0, 3 - len(den)))
        sections.append(np.concatenate([num, den]))
    if not sections:
        sections.append(np.array([1.0, 0, 0, 1.0, 0, 0]))
    sos = np.array(sections, dtype=np.float64)
    sos[0, :3] *= k
    return sos


def butter_sos(order: int, wn, btype: str = "lowpass", fs: float = 2.0) -> np.ndarray:
    """Butterworth digital filter as second-order sections ``(ns, 6)``.

    ``wn`` in the units of ``fs`` (default Nyquist units, like scipy).
    """
    return _iirfilter_sos(_buttap(order), order, wn, btype, fs)


def cheby1_sos(
    order: int, rp: float, wn, btype: str = "lowpass", fs: float = 2.0
) -> np.ndarray:
    """Chebyshev type-I digital filter (passband ripple ``rp`` dB) as SOS."""
    return _iirfilter_sos(_cheb1ap(order, rp), order, wn, btype, fs)


def cheby2_sos(
    order: int, rs: float, wn, btype: str = "lowpass", fs: float = 2.0
) -> np.ndarray:
    """Chebyshev type-II digital filter (stopband attenuation ``rs`` dB,
    ``wn`` = stopband edge) as SOS."""
    return _iirfilter_sos(_cheb2ap(order, rs), order, wn, btype, fs)


def ellip_sos(
    order: int, rp: float, rs: float, wn, btype: str = "lowpass", fs: float = 2.0
) -> np.ndarray:
    """Elliptic (Cauer) digital filter (``rp`` dB passband ripple, ``rs`` dB
    stopband attenuation) as SOS."""
    return _iirfilter_sos(_ellipap(order, rp, rs), order, wn, btype, fs)


def bessel_sos(
    order: int, wn, btype: str = "lowpass", fs: float = 2.0, norm: str = "phase"
) -> np.ndarray:
    """Bessel/Thomson digital filter (maximally flat group delay) as SOS.

    Note the bilinear transform does not preserve the flat group delay
    exactly (same caveat as scipy's ``bessel``); accurate for ``wn`` well
    below Nyquist.
    """
    return _iirfilter_sos(_besselap(order, norm), order, wn, btype, fs)


def iirfilter_sos(
    order: int,
    wn,
    *,
    btype: str = "lowpass",
    ftype: str = "butter",
    rp: Optional[float] = None,
    rs: Optional[float] = None,
    fs: float = 2.0,
    norm: str = "phase",
) -> np.ndarray:
    """Generic IIR design front door (scipy.signal.iirfilter analog).

    ``ftype``: "butter" | "cheby1" | "cheby2" | "ellip" | "bessel".
    Returns normalised second-order sections ready for :func:`sosfilt`.
    """
    ftype = ftype.lower()
    if ftype in ("butter", "butterworth"):
        proto = _buttap(order)
    elif ftype in ("cheby1", "chebyshev1", "cheby_1"):
        if rp is None:
            raise ValueError("cheby1 needs rp (passband ripple, dB)")
        proto = _cheb1ap(order, rp)
    elif ftype in ("cheby2", "chebyshev2", "cheby_2"):
        if rs is None:
            raise ValueError("cheby2 needs rs (stopband attenuation, dB)")
        proto = _cheb2ap(order, rs)
    elif ftype in ("ellip", "elliptic", "cauer"):
        if rp is None or rs is None:
            raise ValueError("ellip needs rp and rs (dB)")
        proto = _ellipap(order, rp, rs)
    elif ftype in ("bessel", "thomson"):
        proto = _besselap(order, norm)
    else:
        raise ValueError(f"unknown ftype {ftype!r}")
    return _iirfilter_sos(proto, order, wn, btype, fs)


# --- Minimum-order selection (scipy buttord/cheb1ord/cheb2ord/ellipord) ----


def _golden_max(f, lo: float, hi: float, iters: int = 100) -> float:
    """Golden-section maximisation of a unimodal f on [lo, hi]."""
    inv_phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - inv_phi * (b - a)
    d = a + inv_phi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - inv_phi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + inv_phi * (b - a)
            fd = f(d)
    return 0.5 * (a + b)


def _ord_band_edges(wp, ws, btype, fs):
    """Normalise passband/stopband spec to a single analog selectivity ratio.

    Returns (nat, warped_wp) where ``nat ≥ 1`` is the stopband-to-passband
    frequency ratio of the equivalent analog lowpass prototype.
    """
    wp = np.atleast_1d(np.asarray(wp, np.float64)) * 2.0 / fs
    ws = np.atleast_1d(np.asarray(ws, np.float64)) * 2.0 / fs
    if np.any(wp <= 0) or np.any(wp >= 1) or np.any(ws <= 0) or np.any(ws >= 1):
        raise ValueError("band edges must lie inside (0, fs/2)")
    warp = lambda w: 2.0 * 2.0 * np.tan(np.pi * w / 2.0)
    Wp, Ws = warp(wp), warp(ws)
    btype = btype.lower()
    if btype in ("lowpass", "low", "lp"):
        nat = Ws[0] / Wp[0]
    elif btype in ("highpass", "high", "hp"):
        nat = Wp[0] / Ws[0]
    elif btype in ("bandpass", "bp"):
        wo = np.sqrt(Wp[0] * Wp[1])
        bw = Wp[1] - Wp[0]
        nat = float(np.min(np.abs((Ws**2 - wo**2) / (Ws * bw))))
    elif btype in ("bandstop", "bs", "notch"):
        # A bandstop prototype transform couples its two transition bands
        # through wo; the spec only bounds the given edges, so the passband
        # edges may be tightened toward the stopband to balance the two
        # transitions and minimise the order (order is monotone decreasing
        # in nat for every family, so maximising nat is family-agnostic).
        def nat_for(p0, p1):
            wo2 = p0 * p1
            bwv = p1 - p0
            return float(np.min(np.abs((Ws * bwv) / (Ws**2 - wo2))))

        p0 = _golden_max(lambda v: nat_for(v, Wp[1]), Wp[0], Ws[0] * (1 - 1e-12))
        p1 = _golden_max(lambda v: nat_for(p0, v), Ws[1] * (1 + 1e-12), Wp[1])
        nat = nat_for(p0, p1)
        Wp = np.array([p0, p1])  # the tightened edges ARE the prototype's
    else:
        raise ValueError(f"unknown btype {btype!r}")
    if nat <= 1.0:
        raise ValueError("stopband must be strictly beyond the passband")
    return float(nat), wp, Wp


def buttord(wp, ws, gpass: float, gstop: float, fs: float = 2.0):
    """Minimum Butterworth order meeting ≤``gpass`` dB passband loss and
    ≥``gstop`` dB stopband attenuation.  Returns ``(order, wn)`` with
    ``wn`` the −3 dB corner(s) to pass to :func:`butter_sos`.

    ``wn`` is ADJUSTED so the rounded-up order meets the passband spec
    exactly, with the margin going to the stopband (scipy semantics).
    Returning the raw passband edge — as this function did before r3 —
    silently violates any ``gpass`` < 3 dB spec, since a Butterworth is
    always −3 dB at its corner.
    """
    btype = _ord_btype(wp, ws)
    nat, wp_n, Wp_w = _ord_band_edges(wp, ws, btype, fs)
    d = (10.0 ** (0.1 * gstop) - 1.0) / (10.0 ** (0.1 * gpass) - 1.0)
    order = max(int(np.ceil(np.log(d) / (2.0 * np.log(nat)))), 1)
    # prototype cutoff meeting gpass exactly at the passband edge v = 1
    w0 = (10.0 ** (0.1 * gpass) - 1.0) ** (-1.0 / (2.0 * order))

    def warp(w):
        return 4.0 * np.tan(np.pi * np.asarray(w, np.float64) / 2.0)

    def unwarp(W):
        return (2.0 / np.pi) * np.arctan(np.asarray(W) / 4.0)

    Wp = Wp_w  # warped (bandstop: tightened) passband edges
    btype = btype.lower()
    if btype in ("lowpass", "low", "lp"):
        WN = np.array([w0 * Wp[0]])
    elif btype in ("highpass", "high", "hp"):
        WN = np.array([Wp[0] / w0])
    elif btype in ("bandpass", "bp"):
        bw = Wp[1] - Wp[0]
        wo2 = Wp[0] * Wp[1]
        disc = np.sqrt((w0 * bw) ** 2 + 4.0 * wo2)
        WN = np.array([(-w0 * bw + disc) / 2.0, (w0 * bw + disc) / 2.0])
    else:  # bandstop
        bw = Wp[1] - Wp[0]
        wo2 = Wp[0] * Wp[1]
        disc = np.sqrt(bw * bw + 4.0 * w0 * w0 * wo2)
        WN = np.array([(-bw + disc) / (2.0 * w0), (bw + disc) / (2.0 * w0)])
    return order, np.squeeze(unwarp(WN) * fs / 2.0)


def cheb1ord(wp, ws, gpass: float, gstop: float, fs: float = 2.0):
    nat, wp_n, _ = _ord_band_edges(wp, ws, _ord_btype(wp, ws), fs)
    d = (10.0 ** (0.1 * gstop) - 1.0) / (10.0 ** (0.1 * gpass) - 1.0)
    order = int(np.ceil(np.arccosh(np.sqrt(d)) / np.arccosh(nat)))
    return max(order, 1), np.squeeze(wp_n * fs / 2.0)


def cheb2ord(wp, ws, gpass: float, gstop: float, fs: float = 2.0):
    """Returns ``(order, wn)`` with ``wn`` the *stopband* edge(s) for
    :func:`cheby2_sos` (scipy returns a tightened edge; we return ws —
    the spec is still met, with margin at the passband side)."""
    nat, _, _ = _ord_band_edges(wp, ws, _ord_btype(wp, ws), fs)
    d = (10.0 ** (0.1 * gstop) - 1.0) / (10.0 ** (0.1 * gpass) - 1.0)
    order = int(np.ceil(np.arccosh(np.sqrt(d)) / np.arccosh(nat)))
    return max(order, 1), np.squeeze(np.asarray(ws, np.float64))


def ellipord(wp, ws, gpass: float, gstop: float, fs: float = 2.0):
    nat, wp_n, _ = _ord_band_edges(wp, ws, _ord_btype(wp, ws), fs)
    ep = np.sqrt(10.0 ** (0.1 * gpass) - 1.0)
    es = np.sqrt(10.0 ** (0.1 * gstop) - 1.0)
    k = 1.0 / nat  # selectivity
    k1 = ep / es  # discrimination
    kp = np.sqrt(1.0 - k * k)
    k1p = np.sqrt(1.0 - k1 * k1)
    order = int(np.ceil(
        (_ellipk(k) * _ellipk(k1p)) / (_ellipk(kp) * _ellipk(k1))
    ))
    return max(order, 1), np.squeeze(wp_n * fs / 2.0)


def _ord_btype(wp, ws) -> str:
    """Infer band type from the edge layout (scipy-compatible shorthand)."""
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if wp.size == 1:
        return "lowpass" if wp[0] < ws[0] else "highpass"
    if wp[0] > ws[0] and wp[1] < ws[1]:
        return "bandpass"
    if wp[0] < ws[0] and wp[1] > ws[1]:
        return "bandstop"
    raise ValueError("inconsistent wp/ws band edges")


def _iirfilter_sos(prototype, order, wn, btype, fs):
    z, p, k = prototype
    wn = np.atleast_1d(np.asarray(wn, dtype=np.float64)) * 2.0 / fs
    if np.any(wn <= 0) or np.any(wn >= 1):
        raise ValueError("critical frequencies must lie inside (0, fs/2)")
    fs_d = 2.0
    warped = 2.0 * fs_d * np.tan(np.pi * wn / fs_d)
    btype = btype.lower()
    if btype in ("lowpass", "low", "lp"):
        z, p, k = _lp2lp(z, p, k, warped[0])
    elif btype in ("highpass", "high", "hp"):
        z, p, k = _lp2hp(z, p, k, warped[0])
    elif btype in ("bandpass", "bp"):
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _lp2bp(z, p, k, wo, bw)
    elif btype in ("bandstop", "bs", "notch"):
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _lp2bs(z, p, k, wo, bw)
    else:
        raise ValueError(f"unknown btype {btype!r}")
    z, p, k = _bilinear_zpk(z, p, k, fs_d)
    return _zpk2sos(z, p, k)


# --- RBJ Audio-EQ-Cookbook biquads (the reference's EQ-section analog) -----


def rbj_biquad(
    kind: str, f0: float, fs: float, *, q: float = 0.7071067811865476,
    gain_db: float = 0.0
) -> np.ndarray:
    """One RBJ cookbook biquad as a normalised ``(6,)`` SOS row."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * f0 / fs
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * q)
    kind = kind.lower()
    if kind == "peaking":
        b = [1 + alpha * A, -2 * cw, 1 - alpha * A]
        a = [1 + alpha / A, -2 * cw, 1 - alpha / A]
    elif kind == "lowpass":
        b = [(1 - cw) / 2, 1 - cw, (1 - cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "highpass":
        b = [(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "notch":
        b = [1.0, -2 * cw, 1.0]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "lowshelf":
        sq = 2.0 * np.sqrt(A) * alpha
        b = [
            A * ((A + 1) - (A - 1) * cw + sq),
            2 * A * ((A - 1) - (A + 1) * cw),
            A * ((A + 1) - (A - 1) * cw - sq),
        ]
        a = [(A + 1) + (A - 1) * cw + sq, -2 * ((A - 1) + (A + 1) * cw),
             (A + 1) + (A - 1) * cw - sq]
    elif kind == "highshelf":
        sq = 2.0 * np.sqrt(A) * alpha
        b = [
            A * ((A + 1) + (A - 1) * cw + sq),
            -2 * A * ((A - 1) + (A + 1) * cw),
            A * ((A + 1) + (A - 1) * cw - sq),
        ]
        a = [(A + 1) - (A - 1) * cw + sq, 2 * ((A - 1) - (A + 1) * cw),
             (A + 1) - (A - 1) * cw - sq]
    else:
        raise ValueError(f"unknown RBJ biquad kind {kind!r}")
    b, a = np.asarray(b, np.float64), np.asarray(a, np.float64)
    return np.concatenate([b / a[0], a / a[0]])


def peaking_eq_sos(freqs, gains_db, fs: float, q: float = 1.0) -> np.ndarray:
    """N-section peaking-EQ cascade (the BASELINE.json:9 workload shape)."""
    rows = [
        rbj_biquad("peaking", f, fs, q=q, gain_db=g)
        for f, g in zip(freqs, gains_db)
    ]
    return np.stack(rows)


def shelf_sos(kind: str, f0: float, fs: float, gain_db: float) -> np.ndarray:
    return rbj_biquad(kind, f0, fs, gain_db=gain_db)[None, :]


# ---------------------------------------------------------------------------
# Filtering (blockwise scan, on the device of the signal)
# ---------------------------------------------------------------------------


def section_realization(row: np.ndarray):
    """Choose the numerically best scan realization for one SOS row.

    Complex-conjugate poles → coupled (Gold–Rader) form: the state update
    is one complex first-order recurrence ``w[n] = p·w[n-1] + x[n]`` with
    ``p = α+jβ`` the pole, ``y[n] = b0·x[n] + c1·Re(w[n-1]) + c2·Im(w[n-1])``.
    Its transition is a scaled rotation, so scan partial products have norm
    exactly ``|p|^k`` — no transient overshoot, unlike the companion/TDF2
    matrix whose powers can grow ~1/sinθ before decaying and amplify f32
    rounding in a parallel scan (SURVEY.md §7 hard part 1).

    Real poles → companion (TDF2) matrix form (no oscillatory transient).

    Returns ("coupled", (alpha, beta, c1, c2, b0)) or ("companion", row).
    """
    b0, b1, b2, _, a1, a2 = (float(v) for v in row)
    disc = a1 * a1 - 4.0 * a2
    if disc < 0.0:
        alpha = -a1 / 2.0
        beta = np.sqrt(-disc) / 2.0
        c1 = b1 - b0 * a1
        c2 = (b2 - b0 * a2 + c1 * alpha) / beta
        return "coupled", (alpha, beta, c1, c2, b0)
    return "companion", row


def sos_state_matrices(sos) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-section companion transition ``A (ns,2,2)`` and input ``B (ns,2)``
    for the TDF2 realization, float32 CPU tensors (the JAX package's
    float32 arithmetic, so bit-equal to its arrays)."""
    sos = torch.as_tensor(np.asarray(sos, np.float32))
    b0, b1, b2 = sos[:, 0], sos[:, 1], sos[:, 2]
    a1, a2 = sos[:, 4], sos[:, 5]
    A = torch.stack(
        [
            torch.stack([-a1, torch.ones_like(a1)], dim=-1),
            torch.stack([-a2, torch.zeros_like(a2)], dim=-1),
        ],
        dim=-2,
    )  # (ns, 2, 2)
    B = torch.stack([b1 - a1 * b0, b2 - a2 * b0], dim=-1)  # (ns, 2)
    return A, B


def sos_plan(sos):
    """Host-side realization plan: ``(kinds tuple, params list)``.

    ``kinds[s]`` is "coupled" or "companion", as in the JAX package;
    ``params[s]`` is the section's float64 coefficients for
    :func:`apply_section`: ``(alpha, beta, c1, c2, b0)`` for the coupled
    form, the SOS row for the companion form (the JAX package keeps
    float32 copies; the port builds its float64 power tables from these).
    """
    sos_np = np.asarray(sos, dtype=np.float64)
    if sos_np.ndim != 2 or sos_np.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos_np.shape}")
    if not np.allclose(sos_np[:, 3], 1.0):
        raise ValueError("sos rows must be normalised to a0 == 1")
    kinds = []
    params = []
    for row in sos_np:
        kind, p = section_realization(row)
        kinds.append(kind)
        params.append(np.asarray(p, np.float64))
    return tuple(kinds), params


def _realization(kind: str, params):
    """``(P, u, c, b0)`` in float64 of a section's scan realization:
    ``s[n] = P·s[n−1] + u·x[n]``, ``y[n] = b0·x[n] + c·s[n−1]``."""
    if kind == "coupled":
        alpha, beta, c1, c2, b0 = (float(v) for v in params)
        P = np.array([[alpha, -beta], [beta, alpha]])
        return P, np.array([1.0, 0.0]), np.array([c1, c2]), b0
    if kind != "companion":
        raise ValueError(f"unknown section kind {kind!r}")
    b0, b1, b2, _, a1, a2 = (float(v) for v in params)
    P = np.array([[-a1, 1.0], [-a2, 0.0]])
    u = np.array([b1 - a1 * b0, b2 - a2 * b0])
    return P, u, np.array([1.0, 0.0]), b0


def _powers(P: np.ndarray, n: int) -> np.ndarray:
    """``P^0 … P^n`` in float64, ``(n + 1, 2, 2)``."""
    pk = np.empty((n + 1, 2, 2))
    pk[0] = np.eye(2)
    for k in range(1, n + 1):
        pk[k] = P @ pk[k - 1]
    return pk


def _f32(v) -> float:
    """A float64 coefficient rounded to float32, as a Python scalar (exact
    in either precision, so every device multiplies by the same value)."""
    return float(np.float32(v))


@functools.lru_cache(maxsize=64)
def _scan_tables_host(kind: str, params: Tuple[float, ...], L: int):
    """Float32 tables of one section for blocks of ``L``, from float64:
    the doubling steps' ``P^(2^i)``, the input vector ``u``, the output
    weights ``g[k] = cᵀP^k`` of the carry entering a block, and ``P^(k+1)``
    for the carry and ``zf`` on the host."""
    P, u, c, b0 = _realization(kind, params)
    pk = _powers(P, L)
    shifts = []
    s = 1
    while s < L:
        shifts.append(s)
        s *= 2
    return dict(
        shifts=tuple(shifts),
        steps=pk[list(shifts)].astype(np.float32).reshape(len(shifts), 2, 2),
        u=u.astype(np.float32),
        g=(c @ pk[:L]).astype(np.float32),  # (L, 2)
        carry=pk[1:].astype(np.float32),    # (L, 2, 2): P^(k+1)
        c=(_f32(c[0]), _f32(c[1])),
        b0=_f32(b0),
    )


@functools.lru_cache(maxsize=128)
def _scan_tables(kind: str, params: Tuple[float, ...], L: int, device: str):
    """:func:`_scan_tables_host` with the device-side tables on ``device``,
    copied there once."""
    host = _scan_tables_host(kind, params, L)
    dev = dict(host)
    for key in ("steps", "u", "g"):
        dev[key] = torch.from_numpy(host[key]).to(device)
    return dev


def _host_carry(ends: np.ndarray, s0: np.ndarray, carry: np.ndarray):
    """The sequential carry across blocks, float32 on the host.

    ``ends (B, nblk, 2)`` are the blocks' zero-state end states,
    ``s0 (B, 2)`` the state entering block 0.  Returns the state entering
    each block, ``(B, nblk, 2)``: ``s_j = z_j[L−1] + P^L·s_{j−1}``,
    evaluated as :func:`_state_at` evaluates every state."""
    b, nblk, _ = ends.shape
    s_in = np.empty((b, nblk, 2), np.float32)
    s = s0
    for j in range(nblk):
        s_in[:, j] = s
        s = _state_at(ends[:, j], s, carry[-1])
    return s_in


def _state_at(z: np.ndarray, s_prev: np.ndarray, pk1: np.ndarray):
    """``z + P^(k+1)·s_prev`` in float32, the state at in-block index k
    from its zero-state part ``z (B, 2)`` and the carry entering the
    block: the one expression for the carry and for ``zf``."""
    return z + (s_prev[:, :1] * pk1[:, 0] + s_prev[:, 1:] * pk1[:, 1])


def padded_len(t: int, block_size: int) -> int:
    """Scan length for a T-sample signal: the next multiple of
    ``block_size``.  (The JAX package also pads to at least two blocks,
    for XLA's fusion contexts; eager tensor code needs no such rule.)"""
    return t + ((-t) % block_size)


def apply_section(kind: str, params, cur: torch.Tensor,
                  s0_init: torch.Tensor, block_size: int,
                  zf_index: Optional[int] = None):
    """Run one biquad section over ``cur (B, T)`` with ``s0_init (B, 2)``.

    ``kind`` and ``params`` are one entry of :func:`sos_plan`.  Returns
    ``(y (B, T), zf (B, 2))``, float32 on ``cur``'s device, with ``zf`` the
    state after sample ``zf_index`` (default the last sample).  A
    ``cur`` whose length is not a multiple of ``block_size`` is padded with
    zeros; :func:`sosfilt` pads once for the whole cascade and passes the
    true last index as ``zf_index``.
    """
    y, zf = apply_section_host(kind, params, cur,
                               s0_init.to(torch.float32).cpu().numpy(),
                               block_size, zf_index)
    return y, torch.from_numpy(zf).to(cur.device)


def apply_section_host(kind: str, params, cur: torch.Tensor,
                       s0_init: np.ndarray, block_size: int,
                       zf_index: Optional[int] = None, op: str = "sosfilt"):
    """:func:`apply_section` with the states on the host, where the carry
    across blocks is computed: ``s0_init`` and the returned ``zf`` are
    ``(B, 2)`` float32 arrays (the sharded carry composition,
    ``parallel/sharded_ops.py``, composes them there).  Step 2 is the span
    ``llz/ops/sos_carry``; its two reads of scan states from the device
    count under ``op`` in ``counters()["state_reads"]``."""
    b, t = cur.shape
    L = int(block_size)
    if zf_index is None:
        zf_index = t - 1
    if not 0 <= zf_index < t:
        raise ValueError(f"zf_index {zf_index} outside [0, {t})")
    tp = padded_len(t, L)
    x = F.pad(cur, (0, tp - t)) if tp != t else cur
    x = x.to(torch.float32).reshape(b, tp // L, L)
    tab = _scan_tables(kind, tuple(float(v) for v in params), L,
                       str(x.device))
    # 1. zero-state scan of every block at once
    z = x[..., None] * tab["u"]  # (B, nblk, L, 2)
    for i, s in enumerate(tab["shifts"]):
        m = tab["steps"][i]
        step = z[..., :-s, 0:1] * m[:, 0]
        step.add_(z[..., :-s, 1:2] * m[:, 1])
        z[..., s:, :].add_(step)
    # 2. the carry across blocks, on the host
    j, k = divmod(zf_index, L)
    with span("ops", "sos_carry"):
        ends = z[:, :, L - 1, :].cpu().numpy()
        s_in = _host_carry(ends, s0_init, tab["carry"])
        zf = _state_at(z[:, j, k, :].cpu().numpy(), s_in[:, j],
                       tab["carry"][k])
        count_state_reads(op, 2)
        s_dev = torch.from_numpy(s_in).to(x.device)
    # 3. the output, with the carry entering each block folded in
    c1, c2 = tab["c"]
    g = tab["g"]
    y = x * tab["b0"]
    zc = z[..., :-1, 0] * c1
    zc.add_(z[..., :-1, 1] * c2)
    y[..., 1:].add_(zc)
    carry = s_dev[..., 0:1] * g[:, 0]
    carry.add_(s_dev[..., 1:2] * g[:, 1])
    y.add_(carry)
    return y.reshape(b, tp)[:, :t], np.ascontiguousarray(zf)


def section_transition(sos_row, length: int):
    """Host-side f64 affine map of one section over ``length`` samples in
    its scan realization: state_out = M·state_in + (zero-init tail).

    Returns ``M (2, 2) float32`` — the realization's transition matrix
    raised to the ``length``-th power, computed in float64.  Used by the
    cross-shard carry composition (parallel/carry_scan.py).
    """
    kind, p = section_realization(np.asarray(sos_row, np.float64))
    if kind == "coupled":
        alpha, beta = p[0], p[1]
        pw = (alpha + 1j * beta) ** length
        M = np.array([[pw.real, -pw.imag], [pw.imag, pw.real]])
    else:
        _, _, _, _, a1, a2 = np.asarray(sos_row, np.float64)
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        M = np.linalg.matrix_power(A, length)
    return M.astype(np.float32)


def tf2sos(b, a) -> np.ndarray:
    """Transfer-function (b, a) → second-order sections, float64 host-side.

    Roots are paired by the same conjugate-aware strategy as the design
    pipeline (:func:`_zpk2sos`); use for arbitrary (b, a) filters that
    didn't come from the zpk designers.
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    n = max(len(b), len(a))
    b = np.pad(b / a[0], (0, n - len(b)))
    a = np.pad(a / a[0], (0, n - len(a)))
    # As z-polynomials of degree n−1 (z^-k coeff ↔ z^(n−1−k)); leading
    # zeros of b just lower its degree — the missing zeros are "at
    # infinity" and the pole surplus already encodes the extra delay.
    nz = np.nonzero(b)[0]
    if len(nz) == 0:
        raise ValueError("numerator is zero")
    gain = b[nz[0]]
    z = np.roots(b)  # np trims leading zeros internally
    p = np.roots(a)
    return _zpk2sos(z, p, gain)



def lfilter(
    b,
    a,
    x: torch.Tensor,
    *,
    block_size: int = 4096,
    zi: Optional[torch.Tensor] = None,
    return_zf: bool = False,
):
    """General rational filtering ``H(z) = B(z)/A(z)`` along the last axis.

    FIR (``a == [1]``) dispatches to :func:`llzlab_tpu_torch.ops.fir.fir_filter`;
    IIR factors into second-order sections and runs the blockwise scan.
    ``zi`` uses the dispatched representation (FIR history or SOS states).
    """
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = np.atleast_1d(np.asarray(b, np.float64))
    if len(a) == 1:
        from llzlab_tpu_torch.ops import fir as _fir

        return _fir.fir_filter(
            x, b / a[0], zi=zi, return_zf=return_zf
        )
    sos = tf2sos(b, a)
    return sosfilt(
        sos, x, zi=zi, block_size=block_size, return_zf=return_zf
    )


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state DF2T initial conditions for a unit-amplitude step
    (scipy.signal.lfilter_zi semantics, host-side float64).

    Scale by the first signal sample to suppress the startup transient of
    scipy-style ``lfilter``.  Note our :func:`lfilter` dispatches IIR
    filters to the SOS scan engine whose ``zi`` lives in the scan
    realization — for streaming with that engine use
    :func:`sosfilt_zi_scan`; this function exists for scipy-parity
    analysis workflows.
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    while len(a) > 1 and a[0] == 0.0:
        a = a[1:]
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    # companion(a).T: first column −a[1:], superdiagonal ones
    comp_t = np.zeros((n - 1, n - 1))
    comp_t[:, 0] = -a[1:]
    comp_t[np.arange(n - 2), np.arange(1, n - 1)] = 1.0
    iminus_a = np.eye(n - 1) - comp_t
    bv = b[1:] - a[1:] * b[0]
    return np.linalg.solve(iminus_a, bv)


def sosfilt_zi(sos) -> np.ndarray:
    """Per-section steady-state DF2T initial conditions ``(ns, 2)``
    (scipy.signal.sosfilt_zi semantics, host-side float64).

    Sections are scaled cumulatively by the DC gain of everything before
    them, exactly like scipy.  For our scan engine's representation use
    :func:`sosfilt_zi_scan`.
    """
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos.shape}")
    zi = np.empty((sos.shape[0], 2))
    scale = 1.0
    for s, row in enumerate(sos):
        b, a = row[:3], row[3:]
        zi[s] = scale * lfilter_zi(b, a)
        scale *= np.sum(b) / np.sum(a)  # H(1)
    return zi


def sosfilt_zi_scan(sos) -> np.ndarray:
    """Steady-state initial conditions ``(ns, 2)`` in the scan engine's
    own realization (coupled / companion per :func:`section_realization`).

    ``sosfilt(sos, c * ones, zi=c * sosfilt_zi_scan(sos))`` starts with no
    transient: per section the fixed point of ``s = A s + B u`` is solved
    in float64 — coupled form ``w* = u/(1 − p)`` with the complex pole
    ``p``, companion form ``s* = (I − A)⁻¹ B u`` — and the section's
    steady output ``u·H(1)`` feeds the next section.
    """
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos.shape}")
    zi = np.empty((sos.shape[0], 2))
    u = 1.0
    for s, row in enumerate(sos):
        kind, p = section_realization(row)
        if kind == "coupled":
            alpha, beta = p[0], p[1]
            w = u / (1.0 - (alpha + 1j * beta))
            zi[s] = [w.real, w.imag]
        else:
            _, _, _, _, a1, a2 = row
            A = np.array([[-a1, 1.0], [-a2, 0.0]])
            B = np.array([row[1] - a1 * row[0], row[2] - a2 * row[0]])
            zi[s] = np.linalg.solve(np.eye(2) - A, B * u)
        u *= np.sum(row[:3]) / np.sum(row[3:])  # H(1)
    return zi



def _odd_extend(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """Odd reflection of ``padlen`` samples about each end (scipy's
    ``odd_ext``, the JAX package's expression)."""
    if padlen <= 0:
        return x
    head = 2 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    tail = 2 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    return torch.cat([head, x, tail], dim=-1)


def filtfilt(
    b,
    a,
    x: torch.Tensor,
    *,
    block_size: int = 4096,
    padlen: Optional[int] = None,
) -> torch.Tensor:
    """Zero-phase transfer-function filtering (scipy.filtfilt analog).

    Factors ``(b, a)`` into second-order sections and runs
    :func:`sosfiltfilt` (odd-reflection padding + steady-state start) —
    the SOS route is the numerically robust choice in float32.
    """
    a_np = np.atleast_1d(np.asarray(a, np.float64))
    b_np = np.atleast_1d(np.asarray(b, np.float64))
    if padlen is None:
        padlen = 3 * max(len(a_np), len(b_np))
    if len(a_np) == 1:
        from llzlab_tpu_torch.ops import fir as _fir

        t = x.shape[-1]
        padlen = min(padlen, t - 1)
        xe = _odd_extend(x, padlen)
        taps = b_np / a_np[0]
        y = _fir.fir_filter(xe, taps)
        y = _fir.fir_filter(y.flip(-1), taps).flip(-1)
        return y[..., max(padlen, 0) : max(padlen, 0) + t]
    sos = tf2sos(b_np, a_np)
    return sosfiltfilt(sos, x, block_size=block_size, padlen=padlen)


def sosfiltfilt(
    sos,
    x: torch.Tensor,
    *,
    block_size: int = 4096,
    padlen: Optional[int] = None,
) -> torch.Tensor:
    """Zero-phase filtering: forward → reverse → forward → reverse.

    Odd-reflection edge padding plus steady-state initial conditions
    scaled by the first padded sample (scipy.sosfiltfilt-style) suppress
    startup transients; the result has zero group delay and the squared
    magnitude response of ``sos``.
    """
    sos_np = np.asarray(sos, np.float64)
    t = x.shape[-1]
    if padlen is None:
        padlen = min(3 * 2 * sos_np.shape[0] * 8, t - 1)
    padlen = min(padlen, t - 1)
    xe = _odd_extend(x, padlen)
    zi1 = torch.from_numpy(sosfilt_zi_scan(sos_np).astype(np.float32)).to(
        x.device)
    bshape = tuple(x.shape[:-1]) + (1, 1)
    y = sosfilt(sos_np, xe, block_size=block_size,
                zi=xe[..., :1].reshape(bshape) * zi1)
    yr = y.flip(-1)
    y = sosfilt(sos_np, yr, block_size=block_size,
                zi=yr[..., :1].reshape(bshape) * zi1).flip(-1)
    if padlen > 0:
        y = y[..., padlen : padlen + t]
    return y


def _states_in(zi, nb: int, ns: int, device) -> torch.Tensor:
    """``zi`` (``(..., ns, 2)`` or None for zeros) as ``(nb, ns, 2)``
    float32 on ``device``."""
    if zi is None:
        return torch.zeros((nb, ns, 2), dtype=torch.float32, device=device)
    return torch.as_tensor(zi).to(device, torch.float32).reshape(nb, ns, 2)


def sosfilt(
    sos,
    x: torch.Tensor,
    *,
    zi: Optional[torch.Tensor] = None,
    block_size: int = 4096,
    return_zf: bool = False,
):
    """Cascaded biquad filtering along the last axis by the blockwise scan.

    Args:
      sos: ``(ns, 6)`` second-order sections ``[b0 b1 b2 1 a1 a2]``
        (``a0`` must be 1 — normalise at design time), a host array: the
        per-section scan realization (coupled vs companion, see
        :func:`section_realization`) is chosen from the pole discriminant.
      x: ``(..., T)`` tensor; the work runs on its device, in float32, and
        the output has its dtype.
      zi: optional ``(..., ns, 2)`` initial states in the section's scan
        realization — opaque; pass zeros or a ``zf`` from a previous call
        (of this engine, of ``sosfilt_matmul`` or of the JAX package).
      block_size: scan block length ``L``.  The signal is always processed
        in ``L``-sample blocks with the exact end-state carried
        sequentially, so splitting a stream at any multiple of ``L`` and
        carrying ``zf`` reproduces the unsplit output and state bits
        (BASELINE.json:9 "bit-matched state carry").
      return_zf: also return the final states ``(..., ns, 2)`` float32.

    On a CUDA tensor one launch of the scan kernel
    (:mod:`llzlab_tpu_torch.kernels.sos_scan`, any block size) does the
    work, with no read to the host; on
    the CPU the tensor code (:func:`apply_section`), bit for bit the same.
    """
    with span("ops", "sosfilt"):
        shape = tuple(x.shape)
        t = shape[-1]
        nb = math.prod(shape[:-1])
        xb = x.reshape(nb, t).to(torch.float32)
        if x.is_cuda and t > 0:
            tables = _sos_scan.scan_tables(sos, block_size, x.device)
            ns = tables.ns
            zi_b = (None if zi is None else
                    _states_in(zi, nb, ns, x.device).contiguous())
            y, zf = _sos_scan.sos_scan_cuda(xb.contiguous(), tables, zi_b,
                                            return_zf)
        else:
            kinds, params = sos_plan(sos)
            ns = len(kinds)
            zi_b = _states_in(zi, nb, ns, x.device)
            if t == 0:
                y, zf = xb.clone(), zi_b.clone()
            else:
                y, zf = _cascade(kinds, params, xb, zi_b, int(block_size))
        y = y.reshape(shape).to(x.dtype)
        if not return_zf:
            return y
        return y, zf.reshape(shape[:-1] + (ns, 2))


def _cascade(kinds, params, xb: torch.Tensor, zi_b: torch.Tensor,
             block_size: int):
    """The cascade as tensor code, a section at a time over every block
    (:func:`apply_section`), on ``xb``'s device: ``(nb, T)`` float32 from
    the states ``zi_b (nb, ns, 2)`` → ``y (nb, T)`` and ``zf (nb, ns,
    2)``.  :func:`sosfilt`'s path on the CPU, and the scan kernel's
    reference on the card."""
    t = xb.shape[1]
    # Pad once for the whole cascade, so every section sees whole blocks.
    cur = F.pad(xb, (0, padded_len(t, block_size) - t))
    zf_out = []
    for s, kind in enumerate(kinds):
        cur, zf = apply_section(kind, params[s], cur, zi_b[:, s, :],
                                block_size, zf_index=t - 1)
        zf_out.append(zf)
    return cur[:, :t], torch.stack(zf_out, dim=1)

"""Analysis utilities: frequency response, group delay, spectrogram, the
analytic signal and spectral density estimates (port of
``llzlab_tpu/ops/analysis.py``).

``freqz``, ``sosfreqz`` and ``group_delay`` are host-side float64 numpy
(design-time checks), the JAX package's code copied, so they are bit-equal.
The rest are tensor ops in float32 on the input's device:
:func:`spectrogram` over the port's ``stft``, :func:`hilbert` over
``torch.fft`` at ``n``, and :func:`periodogram`, :func:`welch`,
:func:`csd` and :func:`coherence` over ``ops.spectral.frame`` (an
``unfold`` view, so the hop ``nperseg − noverlap`` must divide ``nperseg``,
as in the JAX package) and ``torch.fft.rfft``.  A float64 input computes in
float32, as it does in the JAX package (float64 off there).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.ops import spectral as _sp
from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.ops.convolve import as_f32, f32_on_one_device
from llzlab_tpu_torch.ops.window import get_window

__all__ = ["freqz", "sosfreqz", "group_delay", "spectrogram", "hilbert",
           "periodogram", "welch", "csd", "coherence"]


def freqz(
    b, a=1.0, worN: Union[int, np.ndarray] = 512, fs: float = 2 * np.pi
) -> Tuple[np.ndarray, np.ndarray]:
    """Frequency response of a rational filter, float64 host-side.

    Returns (w, H) with w in the units of ``fs`` over [0, fs/2).
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if np.isscalar(worN) or np.ndim(worN) == 0:
        w = np.linspace(0.0, np.pi, int(worN), endpoint=False)
    else:
        w = np.asarray(worN, np.float64) * 2 * np.pi / fs
    z = np.exp(-1j * w)
    # H = Σ b[k] z^-k / Σ a[k] z^-k
    zk = np.power(z[:, None], np.arange(len(b))[None, :])
    H = zk @ b
    zk = np.power(z[:, None], np.arange(len(a))[None, :])
    H = H / (zk @ a)
    return w * fs / (2 * np.pi), H


def sosfreqz(
    sos, worN: Union[int, np.ndarray] = 512, fs: float = 2 * np.pi
) -> Tuple[np.ndarray, np.ndarray]:
    """Cascade frequency response (product of biquad responses)."""
    sos = np.asarray(sos, np.float64)
    w = None
    H = 1.0
    for row in sos:
        w, h = freqz(row[:3], row[3:], worN=worN, fs=fs)
        H = H * h
    return w, H


def group_delay(
    b, a=1.0, worN: int = 512, fs: float = 2 * np.pi
) -> Tuple[np.ndarray, np.ndarray]:
    """Group delay −dφ/dω in samples (numerical differentiation of the
    unwrapped phase)."""
    w, H = freqz(b, a, worN=worN, fs=fs)
    phase = np.unwrap(np.angle(H))
    w_rad = w * 2 * np.pi / fs
    gd = -np.gradient(phase, w_rad)
    return w, gd


def spectrogram(
    x: torch.Tensor,
    *,
    n_fft: int = 1024,
    hop: Optional[int] = None,
    window: str = "hann",
    power: float = 2.0,
    log: bool = False,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Magnitude / power spectrogram ``(..., frames, n_fft//2+1)``, float32;
    ``log=True`` returns dB."""
    spec = _sp.stft(as_f32(x), n_fft=n_fft, hop=hop, window=window)
    mag = spec.abs()
    out = mag if power == 1.0 else mag**power
    if log:
        out = 10.0 * torch.log10(torch.clamp(out, min=eps))
    return out


def _onesided(n: int) -> np.ndarray:
    """The analytic signal's spectral weights: 1 at DC (and Nyquist for
    an even ``n``), 2 on the positive bins, 0 on the negative."""
    h = np.zeros(n, np.float32)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1: n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1: (n + 1) // 2] = 2.0
    return h


def hilbert(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Analytic signal by the frequency-domain Hilbert transform
    (``scipy.signal.hilbert``): complex64 with ``real == x`` and imag =
    H{x}, on the full-size FFT zero-padded or cut to ``n``."""
    x = as_f32(x)
    n = n or x.shape[-1]
    h = torch.from_numpy(_onesided(n)).to(x.device)
    return _tf.ifft(_tf.fft(x, n) * h, n)


def _doubling(nfft: int) -> np.ndarray:
    """One-sided doubling: every bin but DC (and Nyquist for an even
    size) counts twice."""
    dbl = np.full(nfft // 2 + 1, 2.0, np.float32)
    dbl[0] = 1.0
    if nfft % 2 == 0:
        dbl[-1] = 1.0
    return dbl


def periodogram(
    x: torch.Tensor,
    fs: float = 1.0,
    *,
    window: str = "boxcar",
    nfft: Optional[int] = None,
    detrend: bool = True,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Single-segment power spectral density, scipy semantics.

    Returns ``(f, Pxx)`` with ``Pxx`` shaped ``(..., nfft//2+1)``,
    density-scaled (V²/Hz).  ``window="boxcar"`` and mean detrending are
    scipy's defaults.
    """
    x = as_f32(x)
    t = x.shape[-1]
    nfft = nfft or t
    if detrend:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    if window in ("boxcar", "rect", None):
        w = np.ones(t, np.float64)
    else:
        w = get_window(window, t, periodic=False)
    xw = x * torch.from_numpy(w.astype(np.float32)).to(x.device)
    spec = _tf.rfft(xw, nfft)
    scale = 1.0 / (fs * float(np.sum(w**2)))
    p = (spec.abs() ** 2) * scale
    f = np.fft.rfftfreq(nfft, 1.0 / fs)
    return f, p * torch.from_numpy(_doubling(nfft)).to(x.device)


def _welch_segments(x, fs, *, nperseg, noverlap, window, detrend):
    """Windowed per-segment rFFTs, with the density scale and the
    one-sided doubling vector."""
    noverlap = nperseg // 2 if noverlap is None else noverlap
    hop = nperseg - noverlap
    # scipy.get_window defaults to fftbins=True (periodic) inside welch
    w = get_window(window, nperseg, periodic=True)
    fr = _sp.frame(x, nperseg, hop)  # (..., nf, nperseg), a view
    if detrend:
        fr = fr - torch.mean(fr, dim=-1, keepdim=True)
    xw = fr * torch.from_numpy(w.astype(np.float32)).to(x.device)
    spec = _tf.rfft(xw, nperseg)
    scale = 1.0 / (fs * float(np.sum(w**2)))
    f = np.fft.rfftfreq(nperseg, 1.0 / fs)
    return f, spec, scale, torch.from_numpy(_doubling(nperseg)).to(x.device)


def welch(
    x: torch.Tensor,
    fs: float = 1.0,
    *,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window: str = "hann",
    detrend: bool = True,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Welch PSD estimate (averaged modified periodograms), scipy
    semantics; the hop ``nperseg − noverlap`` must divide ``nperseg``
    (scipy's default 50 % overlap does).  Returns ``(f, Pxx)``."""
    f, spec, scale, dbl = _welch_segments(
        as_f32(x), fs, nperseg=nperseg, noverlap=noverlap, window=window,
        detrend=detrend)
    p = (spec.abs() ** 2) * scale
    return f, torch.mean(p * dbl, dim=-2)


def _match_lengths(x, y):
    """Zero-pad the shorter of two signals to the longer one's length
    along the last axis (scipy.signal.csd / coherence)."""
    tx, ty = x.shape[-1], y.shape[-1]
    if tx < ty:
        x = F.pad(x, (0, ty - tx))
    elif ty < tx:
        y = F.pad(y, (0, tx - ty))
    return x, y


def csd(
    x: torch.Tensor,
    y: torch.Tensor,
    fs: float = 1.0,
    *,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window: str = "hann",
    detrend: bool = True,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Cross power spectral density ``P_xy`` (scipy.signal.csd semantics:
    Welch-averaged ``conj(X)·Y``, density-scaled, one-sided)."""
    x, y = _match_lengths(*f32_on_one_device(x, y))
    kw = dict(nperseg=nperseg, noverlap=noverlap, window=window,
              detrend=detrend)
    f, sx, scale, dbl = _welch_segments(x, fs, **kw)
    _, sy, _, _ = _welch_segments(y, fs, **kw)
    p = torch.conj(sx) * sy * scale
    return f, torch.mean(p * dbl, dim=-2)


def coherence(
    x: torch.Tensor,
    y: torch.Tensor,
    fs: float = 1.0,
    *,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window: str = "hann",
    detrend: bool = True,
) -> Tuple[np.ndarray, torch.Tensor]:
    """Magnitude-squared coherence ``|P_xy|² / (P_xx · P_yy)``
    (scipy.signal.coherence semantics).

    As in scipy, ``P_xx`` / ``P_yy`` are Welch estimates of each UNPADDED
    input; only the cross term zero-pads the shorter signal.
    """
    x, y = f32_on_one_device(x, y)
    kw = dict(nperseg=nperseg, noverlap=noverlap, window=window,
              detrend=detrend)
    f, sx0, _, _ = _welch_segments(x, fs, **kw)
    _, sy0, _, _ = _welch_segments(y, fs, **kw)
    pxx = torch.mean(sx0.abs() ** 2, dim=-2)
    pyy = torch.mean(sy0.abs() ** 2, dim=-2)
    xp, yp = _match_lengths(x, y)
    sx, sy = sx0, sy0
    if xp.shape[-1] != x.shape[-1]:
        _, sx, _, _ = _welch_segments(xp, fs, **kw)
    if yp.shape[-1] != y.shape[-1]:
        _, sy, _, _ = _welch_segments(yp, fs, **kw)
    pxy = torch.mean(torch.conj(sx) * sy, dim=-2)
    return f, pxy.abs() ** 2 / (pxx * pyy)

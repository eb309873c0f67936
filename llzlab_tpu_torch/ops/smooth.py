"""Smoothing and denoising: detrend, Savitzky-Golay, median, Wiener (port of
``llzlab_tpu/ops/smooth.py``).

Tensor ops in float32 on the input's device, batched over the leading
axes, a float64 input computed in float32 as in the JAX package:

* :func:`detrend` is the closed-form least-squares line on the centred
  index;
* :func:`savgol_filter` is one FFT convolution (``ops.convolve``) with the
  host float64 :func:`savgol_coeffs` (the JAX package's code, copied:
  bit-equal), its ``interp`` edges two small products;
* :func:`medfilt` sorts an ``unfold`` view of ``kernel_size`` windows: a
  selection, so it is bitwise the JAX package's median;
* :func:`wiener` sums ``mysize`` shifted slices in the JAX package's order.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.ops.convolve import as_f32, fftconvolve

__all__ = [
    "detrend",
    "savgol_coeffs",
    "savgol_filter",
    "medfilt",
    "wiener",
]


def detrend(x: torch.Tensor, *, type: str = "linear") -> torch.Tensor:
    """Remove a constant or least-squares linear trend along the last axis
    (``scipy.signal.detrend`` for ``type`` in {"constant", "linear"})."""
    x = as_f32(x)
    if type == "constant":
        return x - torch.mean(x, dim=-1, keepdim=True)
    if type != "linear":
        raise ValueError("type must be 'linear' or 'constant'")
    t = x.shape[-1]
    # Closed-form LSQ line fit on the centred index (well-conditioned).
    n = torch.arange(t, dtype=torch.float32, device=x.device) - (t - 1) / 2.0
    denom = torch.sum(n * n)
    mean = torch.mean(x, dim=-1, keepdim=True)
    slope = torch.sum(x * n, dim=-1, keepdim=True) / denom
    return x - mean - slope * n


def savgol_coeffs(
    window_length: int,
    polyorder: int,
    *,
    deriv: int = 0,
    delta: float = 1.0,
    pos: Optional[float] = None,
) -> np.ndarray:
    """Savitzky-Golay FIR coefficients (scipy semantics, host-side f64).

    The returned taps convolve (scipy convention: ``c[::-1]`` correlates)
    to evaluate the ``deriv``-th derivative of the local least-squares
    polynomial fit of order ``polyorder`` at position ``pos`` (window
    centre by default).
    """
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        if rem == 0:
            pos = halflen - 0.5
        else:
            pos = halflen
    if not (0 <= pos < window_length):
        raise ValueError("pos must be nonnegative and less than window_length")
    if deriv > polyorder:
        return np.zeros(window_length, np.float64)
    # Solve A c = e_deriv·deriv!/δ^deriv via lstsq on the Vandermonde system.
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    x = x[::-1]  # convolution (not correlation) orientation, as scipy
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x**order
    y = np.zeros(polyorder + 1, np.float64)
    y[deriv] = math.factorial(deriv) / (delta**deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


#: scipy's savgol modes other than "interp", as ``numpy.pad`` modes
_PAD_MODES = {"nearest": "edge", "mirror": "reflect", "wrap": "wrap"}


def _savgol_apply(x: torch.Tensor, taps: torch.Tensor, mode: str):
    t = x.shape[-1]
    half = taps.shape[-1] // 2
    if mode == "constant":
        xe = F.pad(x, (half, half))
    elif mode in _PAD_MODES:
        # the padded signal's sample indices, as jnp.pad (numpy's) takes
        # them: a selection, any pad length
        idx = np.pad(np.arange(t), half, mode=_PAD_MODES[mode])
        xe = x.index_select(-1, torch.from_numpy(idx).to(x.device))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return fftconvolve(xe, taps, mode="valid")[..., :t]


def savgol_filter(
    x: torch.Tensor,
    window_length: int,
    polyorder: int,
    *,
    deriv: int = 0,
    delta: float = 1.0,
    mode: str = "interp",
) -> torch.Tensor:
    """Savitzky-Golay smoothing along the last axis (scipy semantics).

    ``mode="interp"`` (the default, as scipy's) fits a polynomial to the
    first and last ``window_length`` samples for the edges; the other modes
    pad.  The interior is one FFT convolution.
    """
    x = as_f32(x)
    taps = savgol_coeffs(window_length, polyorder, deriv=deriv, delta=delta)
    tapst = torch.from_numpy(taps.astype(np.float32)).to(x.device)
    if mode != "interp":
        return _savgol_apply(x, tapst, mode)
    t = x.shape[-1]
    if window_length > t:
        raise ValueError("window_length exceeds signal length for interp")
    y = _savgol_apply(x, tapst, "constant")
    half = window_length // 2
    # Edge replacement: polynomial LSQ fit of the first/last window,
    # evaluated (with the deriv scaling) at the edge sample positions.
    n = np.arange(window_length, dtype=np.float64)
    order = np.arange(polyorder + 1)
    A = n[:, None] ** order[None, :]
    pinv = np.linalg.pinv(A)  # (polyorder+1, window)

    # Evaluation matrix for derivative `deriv` at positions 0..half-1.
    def eval_matrix(pos):
        e = np.zeros((len(pos), polyorder + 1), np.float64)
        for d_i, p in enumerate(order):
            if p >= deriv:
                coef = 1.0
                for q in range(deriv):
                    coef *= p - q
                e[:, d_i] = coef * pos ** (p - deriv)
        return e * (1.0 / delta**deriv)

    pos_head = np.arange(half, dtype=np.float64)
    pos_tail = np.arange(t - half, t, dtype=np.float64) - (t - window_length)
    Eh = torch.from_numpy((eval_matrix(pos_head) @ pinv).astype(
        np.float32)).to(x.device)
    Et = torch.from_numpy((eval_matrix(pos_tail) @ pinv).astype(
        np.float32)).to(x.device)
    head = torch.matmul(x[..., :window_length], Eh.T)
    tail = torch.matmul(x[..., -window_length:], Et.T)
    return torch.cat([head, y[..., half:t - half], tail], dim=-1)


def medfilt(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Sliding median along the last axis (``scipy.signal.medfilt``: odd
    ``kernel_size``, zero padding at the edges): the ``kernel_size``
    windows as an ``unfold`` view of the padded signal, sorted."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    half = kernel_size // 2
    x = as_f32(x)
    win = F.pad(x, (half, half)).unfold(-1, kernel_size, 1)  # (..., T, k)
    return torch.sort(win, dim=-1).values[..., half]


def wiener(
    x: torch.Tensor, mysize: int = 3, noise: Optional[float] = None
) -> torch.Tensor:
    """Local-statistics Wiener denoiser (``scipy.signal.wiener``, 1-D).

    ``noise=None`` estimates the noise power as the mean local variance
    (scipy's default).  The local moments are sums of ``mysize`` shifted
    slices.
    """
    x = as_f32(x)
    half = mysize // 2
    xe = F.pad(x, (half, half))
    t = x.shape[-1]

    def local_sum(v):
        acc = v[..., 0:t]
        for s in range(1, mysize):
            acc = acc + v[..., s:s + t]
        return acc

    lmean = local_sum(xe) / mysize
    lvar = local_sum(xe * xe) / mysize - lmean * lmean
    if noise is None:
        noise = torch.mean(lvar, dim=-1, keepdim=True)
    else:
        noise = torch.tensor(noise, dtype=torch.float32, device=x.device)
    res = x - lmean
    gain = torch.clamp(lvar - noise, min=0.0) / torch.maximum(lvar, noise)
    out = lmean + gain * res
    return torch.where(lvar < noise, lmean, out)

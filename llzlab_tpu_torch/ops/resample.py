"""Rational and Fourier resampling (port of ``llzlab_tpu/ops/resample.py``).

``resample`` is the FFT resampler (scipy.signal.resample), ``decimate`` the
integer polyphase downsampler; the rest of this docstring is the polyphase
engine under ``resample_poly``.

For output group ``s`` (outputs ``m = up·s + p``), every window lives in the
slab ``x[s·down − (K−1) .. s·down + down − 1]`` of ``down + K − 1`` samples.
Scattering each phase's K taps into a dense ``(up, down + K − 1)`` matrix W
(once, on host, in f64) turns a group into one product:

    y[s, :] = slab[s, :] @ W.T

The JAX package has no Pallas kernel here, and neither does the port: the
product is a plain ``torch.matmul`` in f32 (TF32 is off, see
``runtime/platform.py``).  Numerics equal ``scipy.signal.upfirdn(h, x, up,
down)`` truncated to ``ceil(T·up/down)`` outputs (causal, zero history).

Under a profiler ``resample_poly`` is the span ``llz/ops/resample_poly``,
and inside it the taps' normalisation, their ``tobytes`` key and the cached
dense W are ``llz/ops/resample_weights``, the history join, its zero pad
and the ``unfold`` ``llz/ops/resample_slab``.  Each call adds its input
samples and the bytes of those three intermediates (the joined stream, the
padded stream and the slab read as a dense ``(B·S, down + K − 1)`` f32
matrix) to ``runtime.profiler.counters()["resample"]``, from shapes.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.ops.fir import firwin
from llzlab_tpu_torch.ops.window import get_window
from llzlab_tpu_torch.runtime.profiler import count_resample, span

__all__ = [
    "resample_taps",
    "polyphase_weights",
    "resample_poly",
    "resample_output_len",
    "resample_halo",
    "decimate",
    "resample",
]


def resample(x: torch.Tensor, num: int, *, window=None) -> torch.Tensor:
    """Fourier-domain resampling to exactly ``num`` samples along the last
    axis (scipy.signal.resample semantics for real input).

    The rFFT spectrum is truncated / zero-extended to the new rate with
    scipy's Nyquist-bin split, optionally shaped by ``window`` (a
    :func:`llzlab_tpu_torch.ops.window.get_window` spec applied to the
    full spectrum in fftshift order).  Best for periodic signals; for
    streaming rational ratios use :func:`resample_poly`.  Compute is f32
    (``ops/transform.py``: cuFFT on a CUDA tensor); the output has x's
    dtype.
    """
    t = x.shape[-1]
    num = int(num)
    spec = _tf.rfft(x.to(torch.float32), t)
    if window is not None:
        w_full = np.fft.ifftshift(get_window(window, t, periodic=True))
        # fold negative-frequency window halves onto the rfft bins
        w_real = w_full.copy()
        w_real[1:] += w_full[-1:0:-1]
        w_real[1:] *= 0.5
        spec = spec * torch.from_numpy(
            w_real[: t // 2 + 1].astype(np.float32)).to(x.device)
    n = min(num, t)
    nyq = n // 2 + 1
    y = spec.new_zeros(x.shape[:-1] + (num // 2 + 1,))
    y[..., :nyq] = spec[..., :nyq]
    if n % 2 == 0:
        if num < t:
            # folding the (dropped) negative Nyquist partner back in
            y[..., n // 2] *= 2.0
        elif num > t:
            # the old Nyquist bin splits between ±N/2 of the longer signal
            y[..., n // 2] *= 0.5
    return (_tf.irfft(y, num) * (num / t)).to(x.dtype)


def decimate(x: torch.Tensor, q: int, *, taps_per_phase: int = 64,
             window=("kaiser", 8.0)) -> torch.Tensor:
    """Anti-aliased integer downsampling by ``q`` (FIR polyphase path):
    ``resample_poly(x, 1, q)`` with a stopband-at-Nyquist lowpass, the FIR
    analog of ``scipy.signal.decimate(ftype="fir")``."""
    return resample_poly(x, 1, q, taps_per_phase=taps_per_phase,
                         window=window)


def resample_halo(taps_per_phase: int) -> int:
    """Input history samples a shard needs from its left neighbour."""
    return taps_per_phase - 1


def resample_output_len(t: int, up: int, down: int) -> int:
    """Number of causal outputs for t inputs: ceil(t·up/down)."""
    return -(-t * up // down)


def resample_taps(
    up: int,
    down: int,
    taps_per_phase: int = 64,
    *,
    window=("kaiser", 8.0),
    stopband_at_nyquist: bool = True,
) -> np.ndarray:
    """Prototype lowpass for an up/down polyphase bank, float64.

    Length ``up·taps_per_phase``, passband gain ``up``.  With
    ``stopband_at_nyquist`` (the default) the −6 dB point is shifted below
    the tighter Nyquist by half the Kaiser transition width, so the full
    stopband attenuation is reached at the fold frequency.
    """
    n = up * taps_per_phase
    cutoff = 1.0 / max(up, down)
    if stopband_at_nyquist:
        if isinstance(window, tuple) and window[0].lower() == "kaiser":
            beta = float(window[1])
            atten = beta / 0.1102 + 8.7  # inverse of the Kaiser β formula
        else:
            atten = 60.0
        # Kaiser: N ≈ (A − 7.95)/(2.285·Δω); in Nyquist units Δf = Δω/π.
        trans = (atten - 7.95) / (2.285 * n) / np.pi
        cutoff = max(cutoff - trans / 2.0, cutoff * 0.5)
    h = firwin(n, cutoff, window=window)
    return h * up


@functools.lru_cache(maxsize=32)
def _phase_layout(up: int, down: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group phase table: r[p] = (p·down) % up, q[p] = (p·down) // up."""
    p = np.arange(up)
    return (p * down) % up, (p * down) // up


def polyphase_weights(h: np.ndarray, up: int, down: int) -> np.ndarray:
    """Dense ``(up, down + K − 1)`` group weight matrix from prototype taps:
    ``W[p, q_p + K−1−j] = h[up·j + r_p]``, float64."""
    h = np.asarray(h, dtype=np.float64)
    if len(h) % up != 0:
        h = np.pad(h, (0, up - len(h) % up))
    k = len(h) // up
    r, q = _phase_layout(up, down)
    w = np.zeros((up, down + k - 1), dtype=np.float64)
    j = np.arange(k)
    for p in range(up):
        w[p, q[p] + (k - 1) - j] = h[up * j + r[p]]
    return w


@functools.lru_cache(maxsize=16)
def _weights_cached(taps_bytes: bytes, up: int, down: int, device: str):
    w = polyphase_weights(np.frombuffer(taps_bytes, np.float64), up, down)
    return torch.from_numpy(w).to(torch.float32).to(device)


def _resample_impl(x, w, zi, *, up, down, k, return_zf):
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).to(torch.float32)
    b = xb.shape[0]
    halo = k - 1
    s_groups = -(-t // down)  # ceil: groups of `up` outputs
    k2 = down + k - 1
    with span("ops", "resample_slab"):
        if zi is None:
            hist = torch.zeros((b, halo), dtype=torch.float32,
                               device=x.device)
        else:
            hist = zi.reshape(b, halo).to(torch.float32)
        # slab[s, τ] = stream[s·down + τ], stream = history ++ signal ++ 0s
        stream = F.pad(torch.cat([hist, xb], dim=-1),
                       (0, (s_groups - 1) * down + k2 - halo - t))
        slab = stream.unfold(-1, k2, down)  # (B, S, k2)
    count_resample(b * t, 4 * b * (halo + t + stream.shape[-1]
                                   + s_groups * k2))
    y = slab @ w.T
    n_out = resample_output_len(t, up, down)
    y = y.reshape(b, s_groups * up)[:, :n_out]
    y = y.reshape(shape[:-1] + (n_out,)).to(x.dtype)
    if not return_zf:
        return y
    # Final history: last k−1 *input* samples (for T % down == 0 streaming).
    zf = stream[:, t : t + halo].reshape(shape[:-1] + (halo,))
    return y, zf


def resample_poly(
    x: torch.Tensor,
    up: int,
    down: int,
    *,
    taps=None,
    taps_per_phase: int = 64,
    window=("kaiser", 8.0),
    zi: Optional[torch.Tensor] = None,
    return_zf: bool = False,
):
    """Rational resampling along the last axis via a dense polyphase matmul.

    Args:
      x: ``(..., T)`` tensor.
      up, down: rational rate factors (reduced by their gcd internally).
      taps: optional prototype lowpass (length ``up·K`` after gcd
        reduction); designed via :func:`resample_taps` if omitted.
      taps_per_phase: K, taps per polyphase branch when auto-designing.
      zi: optional ``(..., K−1)`` input history; zeros if omitted.
      return_zf: also return the final input history.

    Streaming is exact when each fed block has ``T % down == 0``.
    """
    with span("ops", "resample_poly"):
        g = math.gcd(up, down)
        up, down = up // g, down // g
        if up == down == 1 and taps is None:
            return ((x, x.new_zeros(x.shape[:-1] + (0,))) if return_zf else x)
        with span("ops", "resample_weights"):
            if taps is None:
                taps = resample_taps(up, down, taps_per_phase,
                                     window=window)
            taps = np.asarray(taps, dtype=np.float64)
            if len(taps) % up != 0:
                taps = np.pad(taps, (0, up - len(taps) % up))
            k = len(taps) // up
            w = _weights_cached(taps.tobytes(), up, down, str(x.device))
        return _resample_impl(
            x, w, zi, up=up, down=down, k=k, return_zf=return_zf
        )

"""Chirp-Z transform, zoom FFT and Fourier-method resampling (port of
``llzlab_tpu/ops/chirpz.py``).

* The CZT is Bluestein's factorisation, ``X_k = w^{k²/2} · IFFT(FFT(x·A) ⊙
  FFT(chirp))``: two batched ``torch.fft`` transforms (cuFFT on a CUDA
  tensor) at a power of two, with the chirp tables built once on the host
  in float64 (the JAX package's code, copied: bit-equal complex64 tables),
  cached per device.
* :func:`resample_fourier` is the port's ``ops.resample.resample``.

scipy.signal.czt / zoom_fft / resample semantics.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.ops.resample import resample as _resample

__all__ = ["czt", "zoom_fft", "resample_fourier"]


@functools.lru_cache(maxsize=32)
def czt_tables(n: int, m: int, w: complex, a: complex, nfft: int):
    """Host f64 chirp tables rounded to complex64: (A_n · w^{n²/2},
    FFT(w^{-k²/2}), w^{k²/2})."""
    k = np.arange(max(n, m), dtype=np.float64)
    wexp = np.exp(np.log(complex(w)) * (k**2) / 2.0)  # w^{k²/2}
    an = np.power(complex(a), -k[:n]) * wexp[:n]
    # Bluestein kernel: v[j] = w^{-j²/2} for j in (-(n-1) … m-1), wrapped.
    j = np.arange(-(n - 1), m, dtype=np.float64)
    v = np.exp(-np.log(complex(w)) * (j**2) / 2.0)
    vpad = np.zeros(nfft, np.complex128)
    vpad[: 2 * max(n, m) - 1][: len(v)] = v
    # circular layout: index of j=0 is n-1; roll so output k sits at bin k
    vpad = np.roll(vpad, -(n - 1))
    V = np.fft.fft(vpad)
    return (an.astype(np.complex64), V.astype(np.complex64),
            wexp[:m].astype(np.complex64))


@functools.lru_cache(maxsize=32)
def _czt_tables_on(n: int, m: int, w: complex, a: complex, nfft: int,
                   device: str):
    return tuple(torch.from_numpy(t).to(device)
                 for t in czt_tables(n, m, w, a, nfft))


def czt(
    x: torch.Tensor,
    m: Optional[int] = None,
    w: Optional[complex] = None,
    a: complex = 1.0 + 0.0j,
) -> torch.Tensor:
    """Chirp-Z transform along the last axis (scipy.signal.czt semantics).

    Evaluates ``X_k = Σ_n x[n] · (a · w^{-k})^{-n}``, k = 0…m−1: the
    z-transform on a logarithmic spiral.  The defaults (m = len(x),
    w = exp(−2πi/m)) give the DFT.  Real or complex in, complex64 out.
    """
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(x.astype(
            np.complex64 if np.iscomplexobj(x) else np.float32))
    n = x.shape[-1]
    m = m or n
    if w is None:
        w = np.exp(-2j * np.pi / m)
    nfft = 1 << max(4, int(np.ceil(np.log2(n + m - 1))))
    an, V, wm = _czt_tables_on(n, m, complex(w), complex(a), nfft,
                               str(x.device))
    # a complex input keeps its imaginary part; a real one goes through
    # float32 first, as the JAX package (x64 off) holds a float64 input
    xa = x[..., :n]
    if not xa.is_complex():
        xa = xa.to(torch.float32)
    xa = xa.to(torch.complex64) * an
    y = _tf.ifft(_tf.fft(xa, nfft) * V, nfft)
    return y[..., :m] * wm


def zoom_fft(
    x: torch.Tensor,
    fn,
    m: Optional[int] = None,
    *,
    fs: float = 2.0,
    endpoint: bool = False,
) -> torch.Tensor:
    """Zoomed DFT over the band ``fn = [f1, f2]`` (scipy.signal.zoom_fft).

    Returns ``m`` spectral samples over [f1, f2] (without f2 unless
    ``endpoint``): fine resolution over a narrow band without a huge FFT.
    """
    n = x.shape[-1]
    m = m or n
    try:
        f1, f2 = (float(fn[0]), float(fn[1]))
    except TypeError:
        f1, f2 = 0.0, float(fn)
    if endpoint and m > 1:
        step = (f2 - f1) / (fs * (m - 1))
    else:
        step = (f2 - f1) / (fs * m)
    w = np.exp(-2j * np.pi * step)
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(x, m=m, w=w, a=a)


def resample_fourier(x: torch.Tensor, num: int) -> torch.Tensor:
    """:func:`llzlab_tpu_torch.ops.resample.resample` (FFT method, no
    spectral window), kept in the zoom-FFT / czt family's namespace."""
    if num == x.shape[-1]:
        return x
    return _resample(x, num)

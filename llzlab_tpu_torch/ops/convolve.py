"""FFT convolution and correlation along the last axis (port of
``llzlab_tpu/ops/convolve.py``).

Full, same and valid 1-D convolution of any pair of signals, broadcast over
the leading axes, through the port's FFT entry points (``ops/transform.py``:
cuFFT on a CUDA tensor) at the next power of two of the full length, at
least 16, as in the JAX package.  The work is float32 whatever the inputs'
type: the JAX package runs with float64 off, so a float64 input computes in
float32 there, and here too.
"""

from __future__ import annotations

import numpy as np
import torch

from llzlab_tpu_torch.ops import transform as _tf

__all__ = ["fftconvolve", "correlate"]

MODES = ("full", "same", "valid")


def _next_pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


def as_f32(v, device=None) -> torch.Tensor:
    """``v`` (a tensor or anything numpy takes) as a float32 tensor, on
    ``device`` if given, else on its own (a host array on the CPU).  The
    JAX package's ``jnp.asarray(v, jnp.float32)``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, np.float32))
    return v.to(device=device, dtype=torch.float32)


def f32_on_one_device(*vals):
    """Each of ``vals`` as float32 on the device of the first tensor among
    them (the CPU where none is a tensor)."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               None)
    return tuple(as_f32(v, dev) for v in vals)


def fftconvolve(a, b, mode: str = "full") -> torch.Tensor:
    """FFT convolution along the last axis (leading axes broadcast).

    ``numpy.convolve`` / ``scipy.signal.fftconvolve`` semantics for
    ``mode`` in {"full", "same", "valid"}; float32 out.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    a, b = f32_on_one_device(a, b)
    na, nb = a.shape[-1], b.shape[-1]
    nfull = na + nb - 1
    nfft = _next_pow2(nfull)
    y = _tf.irfft(_tf.rfft(a, nfft) * _tf.rfft(b, nfft), nfft)[..., :nfull]
    return cut_mode(y, na, nb, mode)


def cut_mode(y: torch.Tensor, na: int, nb: int, mode: str) -> torch.Tensor:
    """The ``mode`` part of a full convolution ``y`` of lengths ``na`` and
    ``nb``."""
    if mode == "full":
        return y
    if mode == "same":
        start = (min(na, nb) - 1) // 2
        return y[..., start:start + max(na, nb)]
    nv = max(na, nb) - min(na, nb) + 1
    start = min(na, nb) - 1
    return y[..., start:start + nv]


def correlate(a, b, mode: str = "full") -> torch.Tensor:
    """Cross-correlation ``Σ a[n+k]·b[n]`` by convolution with the reversed
    second argument."""
    a, b = f32_on_one_device(a, b)
    return fftconvolve(a, torch.flip(b, dims=(-1,)), mode=mode)

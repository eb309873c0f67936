"""FFT entry points (port of the public part of
``llzlab_tpu/ops/transform.py``).

``fft``, ``ifft``, ``rfft`` and ``irfft`` keep the JAX package's signature
(``n`` and ``method=``) and run ``torch.fft`` (cuFFT on a CUDA tensor,
pocketfft on a CPU tensor).  The JAX package's ``method="matmul"`` selects
matrix-product FFT engines shaped for the TPU's matrix unit; the port has
none of them, so every accepted ``method`` names the same ``torch.fft``
call and the values agree.

``precision_scope`` and ``matmul_precision_name`` are re-exported from
``runtime/platform.py``, where the port reads the precision name.

``rfft_pair`` returns the (re | im) pair layout ``(..., n+2)`` f32 that the
channelizer's ``spec_format="pair"`` emits; ``pair_to_complex`` packs it
into complex64.
"""

from __future__ import annotations

from typing import Optional

import torch

from llzlab_tpu_torch.runtime.platform import (  # noqa: F401
    matmul_precision_name,
    precision_scope,
)
from llzlab_tpu_torch.runtime.profiler import span

__all__ = ["fft", "ifft", "rfft", "irfft", "rfft_pair", "pair_to_complex",
           "precision_scope", "matmul_precision_name"]

METHODS = ("auto", "xla", "matmul")


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")


def fft(x: torch.Tensor, n: Optional[int] = None, *, method: str = "auto"):
    """Complex FFT along the last axis."""
    _check_method(method)
    return torch.fft.fft(x, n=n or x.shape[-1], dim=-1)


def ifft(x: torch.Tensor, n: Optional[int] = None, *, method: str = "auto"):
    _check_method(method)
    return torch.fft.ifft(x, n=n or x.shape[-1], dim=-1)


def rfft(x: torch.Tensor, n: Optional[int] = None, *, method: str = "auto"):
    _check_method(method)
    with span("ops", "rfft"):
        return torch.fft.rfft(x, n=n or x.shape[-1], dim=-1)


def irfft(x: torch.Tensor, n: Optional[int] = None, *, method: str = "auto"):
    _check_method(method)
    with span("ops", "irfft"):
        return torch.fft.irfft(x, n=n or 2 * (x.shape[-1] - 1), dim=-1)


def rfft_pair(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """rfft in the (re, im) pair layout: ``(..., n+2)`` f32 with
    ``out[..., :n//2+1]`` the real parts of bins 0..n/2 and
    ``out[..., n//2+1:]`` their imaginary parts (bin 0's is 0).

    ``n`` must be even: the layout has no room for an odd size's bins
    (the JAX package drops the top bin there without a word).
    """
    if n is None:
        n = x.shape[-1]
    if n % 2:
        raise ValueError(f"rfft_pair needs an even n, got {n}")
    with span("ops", "rfft_pair"):
        spec = torch.fft.rfft(x.to(torch.float32), n=n, dim=-1)
        return torch.cat([spec.real, spec.imag], dim=-1)


def pair_to_complex(spec: torch.Tensor) -> torch.Tensor:
    """Pair-layout spectrum ``(..., n+2)`` → complex64 ``(..., n/2+1)``."""
    half1 = spec.shape[-1] // 2
    return torch.complex(spec[..., :half1].contiguous(),
                         spec[..., half1:].contiguous())

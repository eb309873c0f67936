"""MDCT / IMDCT: the lapped transform with TDAC perfect reconstruction
(port of ``llzlab_tpu/ops/mdct.py``).

For codec-scale frames (N ≤ 4096) the MDCT is a dense ``(N, 2N)`` cosine
matrix applied to 50 %-overlapped windowed frames: one ``torch.matmul`` in
float32 (TF32 off, ``runtime/platform.py``) on the port's ``frame`` view.
The matrix and the window are built once on the host in float64 (the JAX
package's code, copied: bit-equal) and cached per device as float32.

    X[k] = Σ_{n=0}^{2N−1} w[n]·x[n]·cos(π/N·(n + ½ + N/2)·(k + ½))

IMDCT applies the transpose (scaled 2/N), windows again, and overlap-adds
with hop N (``ops.spectral.overlap_add``); the Princen–Bradley condition
(sine or KBD window) gives perfect reconstruction in the interior.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from llzlab_tpu_torch.ops import spectral as _sp
from llzlab_tpu_torch.ops.convolve import as_f32
from llzlab_tpu_torch.ops.window import get_window

__all__ = ["mdct", "imdct", "sine_window", "mdct_matrix"]


def sine_window(n2: int) -> np.ndarray:
    """Princen–Bradley sine window of length 2N (MP3/AAC style)."""
    k = np.arange(n2, dtype=np.float64)
    return np.sin(np.pi / n2 * (k + 0.5))


@functools.lru_cache(maxsize=16)
def mdct_matrix(n: int) -> np.ndarray:
    """The (N, 2N) float64 MDCT cosine matrix."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(2 * n, dtype=np.float64)[None, :]
    return np.cos(np.pi / n * (m + 0.5 + n / 2.0) * (k + 0.5))


def _resolve_window(window, n2: int) -> np.ndarray:
    if window is None or window == "sine":
        return sine_window(n2)
    return get_window(window, n2, periodic=True)


@functools.lru_cache(maxsize=16)
def _tables(n: int, window, device: str):
    """(window (2N,), M (N, 2N)) as float32 on ``device``."""
    w = _resolve_window(window, 2 * n).astype(np.float32)
    M = mdct_matrix(n).astype(np.float32)
    return torch.from_numpy(w).to(device), torch.from_numpy(M).to(device)


def mdct(x: torch.Tensor, n: int = 1024, *, window="sine") -> torch.Tensor:
    """MDCT along the last axis: ``(..., T)`` → ``(..., F, N)`` float32
    with 50 % overlap (hop = N).  ``F = T/N − 1`` frames; T must be a
    multiple of N."""
    x = as_f32(x)
    if x.shape[-1] % n:
        raise ValueError(f"T={x.shape[-1]} must be a multiple of N={n}")
    w, M = _tables(n, window, str(x.device))
    frames = _sp.frame(x, 2 * n, n) * w  # (..., F, 2N)
    return torch.matmul(frames, M.T)


def imdct(
    spec: torch.Tensor, *, window="sine", length: Optional[int] = None
) -> torch.Tensor:
    """Inverse MDCT with windowed TDAC overlap-add.

    ``imdct(mdct(x))`` reconstructs ``x`` exactly (time-domain alias
    cancellation) away from the first and last N samples.
    """
    spec = as_f32(spec)
    n = spec.shape[-1]
    w, M = _tables(n, window, str(spec.device))
    frames = (2.0 / n) * torch.matmul(spec, M)
    y = _sp.overlap_add(frames * w, n)
    if length is not None:
        y = y[..., :length]
    return y

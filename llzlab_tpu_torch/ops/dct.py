"""DCT / DST, types I to IV, along the last axis (port of
``llzlab_tpu/ops/dct.py``).

Each transform is a dense ``(N, N)`` matrix built once on the host in
float64 (the JAX package's code, copied, so the matrices are bit-equal) and
applied as one ``torch.matmul`` in float32 (cuBLAS on a CUDA tensor; TF32
is off, ``runtime/platform.py``, and the precision name selects nothing for
a plain product).  The JAX package does the same with one einsum and no
Pallas kernel, so a plain product is the port.  ``scipy.fft.dct`` / ``dst``
conventions: types 1 to 4, ``norm=None | "ortho"``.  The output is float32
for a float64 input (the JAX package runs with float64 off), else the
input's type.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dct", "idct", "dst", "idst", "dct_matrix", "dst_matrix"]

_INVERSE_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


@functools.lru_cache(maxsize=64)
def dct_matrix(n: int, dct_type: int = 2, norm=None) -> np.ndarray:
    """Dense float64 DCT matrix ``M`` with ``X = M @ x``."""
    k = np.arange(n, dtype=np.float64)[:, None]  # output index
    m = np.arange(n, dtype=np.float64)[None, :]  # input index
    if dct_type == 1:
        if n < 2:
            raise ValueError("DCT-I needs n ≥ 2")
        M = 2.0 * np.cos(np.pi * k * m / (n - 1))
        M[:, 0] = 1.0
        M[:, -1] = np.cos(np.pi * k[:, 0])
        if norm == "ortho":
            M[:, 0] *= np.sqrt(2.0)
            M[:, -1] *= np.sqrt(2.0)
            M[0, :] /= np.sqrt(2.0)
            M[-1, :] /= np.sqrt(2.0)
            M *= np.sqrt(1.0 / (2.0 * (n - 1)))
    elif dct_type == 2:
        M = 2.0 * np.cos(np.pi * k * (2.0 * m + 1.0) / (2.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[0, :] /= np.sqrt(2.0)
    elif dct_type == 3:
        M = 2.0 * np.cos(np.pi * (2.0 * k + 1.0) * m / (2.0 * n))
        M[:, 0] = 1.0
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[:, 0] *= np.sqrt(2.0)
    elif dct_type == 4:
        M = 2.0 * np.cos(np.pi * (2.0 * k + 1.0) * (2.0 * m + 1.0) / (4.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
    else:
        raise ValueError(f"unknown DCT type {dct_type}")
    return M


@functools.lru_cache(maxsize=64)
def dst_matrix(n: int, dst_type: int = 2, norm=None) -> np.ndarray:
    """Dense float64 DST matrix ``M`` with ``X = M @ x``."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    if dst_type == 1:
        M = 2.0 * np.sin(np.pi * (k + 1.0) * (m + 1.0) / (n + 1.0))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * (n + 1.0)))
    elif dst_type == 2:
        M = 2.0 * np.sin(np.pi * (k + 1.0) * (2.0 * m + 1.0) / (2.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[-1, :] /= np.sqrt(2.0)
    elif dst_type == 3:
        M = 2.0 * np.sin(np.pi * (2.0 * k + 1.0) * (m + 1.0) / (2.0 * n))
        M[:, -1] = np.sin(np.pi * (2.0 * k[:, 0] + 1.0) / 2.0)
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
            M[:, -1] *= np.sqrt(2.0)
    elif dst_type == 4:
        M = 2.0 * np.sin(np.pi * (2.0 * k + 1.0) * (2.0 * m + 1.0) / (4.0 * n))
        if norm == "ortho":
            M *= np.sqrt(1.0 / (2.0 * n))
    else:
        raise ValueError(f"unknown DST type {dst_type}")
    return M


@functools.lru_cache(maxsize=64)
def _matrix_t(kind: str, n: int, type_: int, norm, inverse: bool,
              device: str) -> torch.Tensor:
    """``Mᵀ`` as float32 on ``device``, where ``M`` is the float64 matrix of
    the transform (scaled for an inverse as the JAX package scales it)."""
    build = dct_matrix if kind == "dct" else dst_matrix
    if not inverse:
        M = build(n, type_, norm)
    else:
        M = build(n, _INVERSE_TYPE[type_], norm)
        if norm != "ortho":
            if kind == "dct":
                scale = {1: 2.0 * (n - 1) if n > 1 else 1.0, 2: 2.0 * n,
                         3: 2.0 * n, 4: 2.0 * n}[type_]
            else:
                scale = {1: 2.0 * (n + 1), 2: 2.0 * n, 3: 2.0 * n,
                         4: 2.0 * n}[type_]
            M = M / scale
    return torch.from_numpy(np.ascontiguousarray(
        M.astype(np.float32).T)).to(device)


def _apply(x, kind: str, type_: int, norm, inverse: bool) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    out_dtype = torch.float32 if x.dtype == torch.float64 else x.dtype
    mt = _matrix_t(kind, x.shape[-1], type_, norm, inverse, str(x.device))
    return torch.matmul(x.to(torch.float32), mt).to(out_dtype)


def dct(x: torch.Tensor, type: int = 2, norm=None) -> torch.Tensor:
    """Discrete cosine transform along the last axis (scipy.fft.dct)."""
    return _apply(x, "dct", type, norm, False)


def idct(x: torch.Tensor, type: int = 2, norm=None) -> torch.Tensor:
    """Inverse DCT (scipy.fft.idct): the inverse of :func:`dct` with the
    same ``type`` / ``norm`` arguments."""
    return _apply(x, "dct", type, norm, True)


def dst(x: torch.Tensor, type: int = 2, norm=None) -> torch.Tensor:
    """Discrete sine transform along the last axis (scipy.fft.dst)."""
    return _apply(x, "dst", type, norm, False)


def idst(x: torch.Tensor, type: int = 2, norm=None) -> torch.Tensor:
    """Inverse DST (scipy.fft.idst)."""
    return _apply(x, "dst", type, norm, True)

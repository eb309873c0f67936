"""Kernel B2: the block2 FIR, by hand for Hopper (``csrc/block2_fir.cu``).

Replaces the Pallas TPU kernel ``llzlab_tpu/kernels/block2_fir.py``
(``_kernel_high`` / ``_kernel_highest``, entry ``block2_fir_pallas``).
Contract (the same): ``xpad (B, block + T)`` f32 with one block of history
prepended → ``y (B, T)``, ``y[n] = Σ_k h[k]·xpad[block + n − k]``,
``block ≥ ntaps − 1``.  The envelope differs in rows: the JAX kernel needs
a multiple of 8, this one takes any count (:func:`cuda_supports`).

* :func:`block2_fir` is the entry: a CUDA tensor launches the kernel
  (:func:`block2_fir_cuda`, which counts its launches in ``.launches``),
  a CPU tensor runs the plain version.  Nothing falls back.
* :func:`block2_fir_plain` is the plain PyTorch version, the two-matmul
  Toeplitz form of ``llzlab_tpu/ops/fir.py:_block2_filter``:
  ``y_j = x_{j−1} @ B + x_j @ A`` with ``W = [[B], [A]]``.

Precision modes (as in the JAX package):

* ``"highest"``: f32 products and sums, on the CUDA cores
  (``csrc/fir_tile.cuh``); bound by their fp32 FMA rate.
* ``"high"``: explicit bf16x3: operands split into bf16 hi/lo, products
  ``S_hi·W_hi + S_lo·W_hi + S_hi·W_lo`` with f32 accumulation, on the
  tensor cores (``mma.sync`` through ``csrc/fir_mma.cuh``), at about a
  quarter of their bf16 rate (``csrc/block2_fir.cu`` says what was tried).
  A CUDA block keeps the taps' Toeplitz tile resident and walks passes of 4096
  outputs over all rows (:func:`mma_plan` mirrors the launch arithmetic).

Streaming contract on the card: a stream cut into calls, each with the
block before it as history, gives bitwise the one-shot output if every
cut lies at a multiple of 8 samples at ``"high"`` (the tensor-core sum
order depends on the output index mod 8 counted from output 0 of a call)
and anywhere at ``"highest"``.  Every caller that promises bit-exactness
cuts at multiples of ``block`` (a multiple of 128).

The bf16 tables are rounded from f64 through f32 with round-to-nearest-
even, as the JAX package rounds them, so they are bit-equal.  The kernel
reads the tap vector; the plain version reads the W matrix.  Every entry
of W is a tap or 0, so both carry the same numbers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.runtime.profiler import span

__all__ = ["supports", "cuda_supports", "row_chunks", "band_k", "bf16_hi_lo",
           "bf16_hi_mid_lo", "tap_tables", "plain_tables", "mma_rows",
           "toeplitz_tile", "mma_plan", "SMEM_MAX", "block2_fir",
           "block2_fir_cuda", "block2_fir_plain"]

MODES = ("high", "highest")


def supports(channels: int, ntaps: int, block: int) -> bool:
    """Shape envelope of the JAX package's kernel (channels a multiple of
    its matrix unit's 8-row tile), kept for the tests that pin it; the
    CUDA kernel's own is :func:`cuda_supports`."""
    return (
        channels >= 8
        and channels % 8 == 0
        and block % 128 == 0
        and ntaps - 1 <= block
        and block <= 2048
    )


#: rows of one "highest" launch: the grid's y extent (one block per
#: (run, row)); more rows go out in launches of at most this many
MAX_ROWS = 65535


def cuda_supports(rows: int, ntaps: int, block: int, t: int) -> bool:
    """Shape envelope of kernel B2: any row count, ``block`` a multiple of
    128 with ``ntaps − 1 ≤ block ≤ 2048``, and some outputs.  (The JAX
    kernel's ``rows % 8`` is its matrix unit's row tile; at "high" this
    kernel walks (row, pass) units, and at "highest" its grid is one block
    per (run, row), launched over :func:`row_chunks` of at most
    ``MAX_ROWS`` rows, so no row count needs padding or a limit.)"""
    return (rows >= 1 and block % 128 == 0
            and ntaps - 1 <= block <= 2048 and t > 0)


def row_chunks(rows: int, mode: str):
    """``[(first, end), …]``: the rows of each launch of kernel B2.  At
    "high" one launch takes every row (its grid walks (row, pass) units);
    at "highest" the grid's y extent is the row, so launches of
    ``MAX_ROWS`` rows at most.  Each row's outputs do not depend on the
    launch it is in."""
    step = rows if mode == "high" else MAX_ROWS
    return [(r, min(r + step, rows)) for r in range(0, rows, max(step, 1))]


def _w_matrix(taps: np.ndarray, block: int) -> np.ndarray:
    """(2·block, block) f64 combined Toeplitz halves W = [[B], [A]]."""
    ntaps = len(taps)
    w = np.zeros((2 * block, block), np.float64)
    i = np.arange(block)
    for m in range(block):
        k = i - m  # current block taps (A, bottom half)
        sel = (k >= 0) & (k < ntaps)
        w[block + m, i[sel]] = taps[k[sel]]
        k2 = block + i - m  # previous block taps (B, top half)
        sel2 = (k2 >= 0) & (k2 < ntaps)
        w[m, i[sel2]] = taps[k2[sel2]]
    return w


def band_k(ntaps: int, block: int) -> int:
    """Rows of W that one 128-column output tile touches, aligned to 128
    (the JAX kernel's contraction band; 1152 at 1024 taps / 1024 block)."""
    return block + 128 - 128 * ((block - ntaps + 1) // 128)


def mma_rows(ntaps: int, n: int = 8) -> int:
    """Rows ``kt`` of the tensor-core FIR's Toeplitz tile
    (``fir_mma_kt`` in csrc/fir_mma.cuh): ``ntaps + n − 1`` rounded up to
    the 16-row chunk of one ``mma.sync``."""
    return -(-(ntaps + n - 1) // 16) * 16


def toeplitz_tile(taps: np.ndarray, n: int = 8) -> np.ndarray:
    """``(kt, n)`` Toeplitz of the taps, ``W[k, c] = taps[c − k + kt − n]``
    (0 outside the taps): ``_w_matrix`` at width ``n`` instead of
    ``block``, with the zero rows cut to ``kt = mma_rows(ntaps, n)``.  The
    tensor-core FIR builds the same tile in shared memory from the tap
    tables (``fir_mma_stage_w`` in csrc/fir_mma.cuh); with
    ``X[m, k] = xw[n·m + k]``, ``(X @ W)[m, c]`` is the FIR output at
    window index ``n·m + c`` and ``xw[i]`` the sample ``kt − n`` before
    it."""
    taps = np.asarray(taps)
    kt = mma_rows(len(taps), n)
    j = np.arange(n)[None, :] - np.arange(kt)[:, None] + kt - n
    sel = (j >= 0) & (j < len(taps))
    w = np.zeros((kt, n), taps.dtype)
    w[sel] = taps[j[sel]]
    return w


#: shared memory a block may use on sm_90 (227 KB)
SMEM_MAX = 232448
#: outputs of one pass of the "high" kernel: 8 warps × 4 m-tiles × 128
MMA_PASS = 4096


def mma_smem_bytes(ntaps: int, run: int = MMA_PASS) -> int:
    """Shared memory of a block that runs the tensor-core FIR in runs of
    ``run`` outputs (``fir_mma_smem_bytes`` in csrc/fir_mma.cuh): W hi and
    lo, ``(8, kt + 8)`` bf16 each, and the x window hi and lo,
    ``run + kt − 8`` bf16 each."""
    kt = mma_rows(ntaps)
    return 2 * (2 * 8 * (kt + 8) + 2 * (run + kt - 8))


def mma_plan(ntaps: int, t: int, batch: int = 1,
             resident: Optional[int] = None) -> dict:
    """The launch arithmetic of kernel B2 at "high"
    (``block2_fir_launch`` in csrc/block2_fir.cu): ``kt`` rows of W, the
    x window and shared memory of a block, ``passes`` of ``run`` outputs a
    row, ``units = batch · passes`` (row, pass) pairs, and the grid: one
    block per unit up to the ``resident`` blocks the card holds at once
    (``None``: unbounded); block ``i`` walks units ``i, i + grid, …``."""
    kt = mma_rows(ntaps)
    passes = -(-t // MMA_PASS)
    units = batch * passes
    grid = units if resident is None else min(units, resident)
    return dict(kt=kt, run=MMA_PASS, window=MMA_PASS + kt - 8,
                smem_bytes=mma_smem_bytes(ntaps), passes=passes,
                units=units, grid=grid)


def mma_units(plan: dict, block_index: int):
    """``(row, first output)`` of the units that CUDA block ``block_index``
    of ``plan`` walks, in order."""
    return [(q // plan["passes"], (q % plan["passes"]) * plan["run"])
            for q in range(block_index, plan["units"], plan["grid"])]


def bf16_hi_lo(w64: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 hi/lo parts of f64 values: ``hi = bf16(f32(w))``,
    ``lo = bf16(f32(w − hi))`` (CPU tensors)."""
    w = torch.from_numpy(np.ascontiguousarray(w64, np.float64))
    hi = w.to(torch.float32).to(torch.bfloat16)
    lo = (w - hi.to(torch.float64)).to(torch.float32).to(torch.bfloat16)
    return hi, lo


def _mode_tables(w64: np.ndarray, mode: str, device, dtype=torch.float32):
    """Tables of the f64 values ``w64`` for ``mode``: ``(w,)`` for
    "highest", the bf16 ``(hi, lo)`` parts for "high"; each cast to
    ``dtype`` (bf16 parts are exact in f32 and f64)."""
    if mode == "highest":
        return (torch.from_numpy(w64).to(dtype).to(device),)
    if mode != "high":
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return tuple(p.to(dtype).to(device) for p in bf16_hi_lo(w64))


@functools.lru_cache(maxsize=16)
def _tap_tables_cached(taps_bytes: bytes, mode: str, device: str):
    taps = np.frombuffer(taps_bytes, np.float64).copy()
    dtype = torch.float32 if mode == "highest" else torch.bfloat16
    return _mode_tables(taps, mode, device, dtype)


def tap_tables(taps, mode: str, device="cpu"):
    """What the kernel reads: ``(taps f32,)`` or ``(taps_hi, taps_lo)`` bf16."""
    taps = np.asarray(taps, np.float64)
    return _tap_tables_cached(taps.tobytes(), mode, str(device))


@functools.lru_cache(maxsize=16)
def _plain_tables_cached(taps_bytes: bytes, block: int, mode: str,
                         device: str, dtype: torch.dtype):
    taps = np.frombuffer(taps_bytes, np.float64)
    return _mode_tables(_w_matrix(taps, block), mode, device, dtype)


def plain_tables(taps, block: int, mode: str, device="cpu",
                 dtype=torch.float32):
    """What the plain version reads: ``(W,)`` or ``(W_hi, W_lo)``, each
    ``(2·block, block)`` in ``dtype``."""
    taps = np.asarray(taps, np.float64)
    return _plain_tables_cached(taps.tobytes(), block, mode, str(device),
                                dtype)


def _bf16_split(s: torch.Tensor):
    """hi/lo bf16 parts of ``s``, returned in s's dtype (exact values)."""
    hi = s.to(torch.float32).to(torch.bfloat16).to(s.dtype)
    lo = (s - hi).to(torch.float32).to(torch.bfloat16).to(s.dtype)
    return hi, lo


def bf16_hi_mid_lo(s: torch.Tensor):
    """Three bf16 parts of ``s`` in float32, each returned in s's dtype
    (exact values), as the six-pass "highest" tensor-core FIR splits its
    operands (``fir_wg_split3`` in csrc/fir_wgmma.cuh): ``hi`` is the float32
    value with its low 16 bits cleared, ``mid`` the same of the remainder,
    ``lo`` what is left.  ``hi + mid + lo`` is the float32 value exactly
    from 2^-103 (below, ``lo`` can fall under float32's normal range and
    lose bits) up to the largest finite float, where a ``hi`` rounded to
    nearest would be infinite."""
    v = s.to(torch.float32)

    def top(u):  # u with its low 16 bits cleared: a bf16 value
        return (u.view(torch.int32) & -65536).view(torch.float32)

    hi = top(v)
    r = v - hi
    mid = top(r)
    lo = top(r - mid)
    return hi.to(s.dtype), mid.to(s.dtype), lo.to(s.dtype)


def block2_fir_plain(xpad: torch.Tensor, taps, block: int,
                     mode: str = "high") -> torch.Tensor:
    """Plain PyTorch version of kernel B2 in xpad's dtype (f32, or f64 for a
    reference): ``(B, block + T)`` → ``(B, T)``."""
    b, tp = xpad.shape
    t = tp - block
    nblk = -(-t // block)
    xp = F.pad(xpad, (0, (nblk + 1) * block - tp))
    cur = xp[:, block:].reshape(b, nblk, block)
    prev = xp[:, : nblk * block].reshape(b, nblk, block)
    tabs = plain_tables(taps, block, mode, xpad.device, xpad.dtype)
    if mode == "highest":
        (w,) = tabs
        y = prev @ w[:block] + cur @ w[block:]
    else:
        w_hi, w_lo = tabs
        p_hi, p_lo = _bf16_split(prev)
        c_hi, c_lo = _bf16_split(cur)
        y = (p_hi @ w_hi[:block] + p_lo @ w_hi[:block] + p_hi @ w_lo[:block]
             + c_hi @ w_hi[block:] + c_lo @ w_hi[block:]
             + c_hi @ w_lo[block:])
    return y.reshape(b, nblk * block)[:, :t]


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.block2_fir_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.block2_fir_launch.restype = i
    lib.block2_fir_blocks_per_sm.argtypes = [i]
    lib.block2_fir_blocks_per_sm.restype = i


def blocks_per_sm(ntaps: int) -> int:
    """Blocks of the "high" kernel that one SM of the current card holds
    (read from the CUDA occupancy API)."""
    per_sm = _build.load("block2_fir", _declare).block2_fir_blocks_per_sm(
        ntaps)
    _build.check(-min(per_sm, 0), "block2_fir_blocks_per_sm")
    return per_sm


def block2_fir_cuda(xpad: torch.Tensor, taps, block: int,
                    mode: str = "high") -> torch.Tensor:
    """Launch kernel B2 on ``torch.cuda.current_stream()``, once per
    :func:`row_chunks` chunk (``.launches`` counts each).  Streamed calls
    equal one shot bitwise for cuts at multiples of 8 samples ("high") or
    anywhere ("highest"); see the module docstring."""
    with span("kernels", "B2"):
        taps = np.asarray(taps, np.float64)
        ntaps = len(taps)
        if not xpad.is_cuda:
            raise ValueError("block2_fir_cuda needs a CUDA tensor")
        if xpad.dtype != torch.float32 or xpad.dim() != 2:
            raise ValueError(f"xpad must be 2-D float32, got {xpad.dtype} "
                             f"{tuple(xpad.shape)}")
        if not xpad.is_contiguous():
            raise ValueError("xpad must be contiguous")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        b, tp = xpad.shape
        t = tp - block
        if not cuda_supports(b, ntaps, block, t):
            raise ValueError(
                f"block2 kernel envelope: rows ≥ 1, block % 128 == 0, "
                f"ntaps − 1 ≤ block ≤ 2048, T > 0 (got rows={b}, "
                f"ntaps={ntaps}, block={block}, T={t}); above 2049 taps "
                f"fir_filter(method='block2') runs tensor code, and 'ols' "
                f"is faster")
        lib = _build.load("block2_fir", _declare)
        with torch.cuda.device(xpad.device):
            tabs = tap_tables(taps, mode, xpad.device)
            y = torch.empty((b, t), dtype=torch.float32, device=xpad.device)
            for r0, r1 in row_chunks(b, mode):
                rc = lib.block2_fir_launch(
                    xpad[r0:r1].data_ptr(), tabs[0].data_ptr(),
                    tabs[1].data_ptr() if mode == "high" else None,
                    y[r0:r1].data_ptr(), r1 - r0, t, block, ntaps,
                    int(mode == "high"),
                    torch.cuda.current_stream().cuda_stream)
                _build.check(rc, "block2_fir")
                block2_fir_cuda.launches += 1
        return y


block2_fir_cuda.launches = 0


def block2_fir(xpad: torch.Tensor, taps, block: int, *,
               mode: str = "high") -> torch.Tensor:
    """Block2 FIR on ``(B, block + T)`` pre-padded input → ``(B, T)``:
    kernel B2 for a CUDA tensor, the plain version for a CPU tensor.  On
    the card, streamed calls equal one shot bitwise for cuts at multiples
    of 8 samples at "high" (so at every multiple of ``block``), anywhere at
    "highest"."""
    if xpad.is_cuda:
        return block2_fir_cuda(xpad, taps, block, mode)
    if xpad.device.type != "cpu":
        raise ValueError(f"unsupported device {xpad.device}")
    return block2_fir_plain(xpad, taps, block, mode)

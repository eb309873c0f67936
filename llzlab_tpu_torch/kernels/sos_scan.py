"""Kernel sos_scan: the blockwise scan of a biquad cascade, by hand for
Hopper (``csrc/sos_scan.cu``).

Replaces no TPU kernel: the JAX package scans the cascade with
``lax.associative_scan`` inside blocks and ``lax.scan`` across them, and
:func:`llzlab_tpu_torch.ops.iir.sosfilt` runs the same doubling as tensor
code on the CPU (per section a doubling over every block at once, the
carry across blocks on the host, an output pass).  On a CUDA tensor
``sosfilt`` launches this kernel instead: one launch a call runs every
section of every block, and the carry stays on the card.

Contract: bit for bit the tensor code (``ops/iir.py``:
``apply_section_host`` steps 1 to 3, ``_host_carry``, ``_state_at``), for
``x (rows, t)`` float32 from the states ``zi (rows, ns, 2)`` (zeros when
omitted) to ``y (rows, t)`` and ``zf (rows, ns, 2)``.  The kernel walks
the blocks of a row in order and runs every section of a block before the
next block (block-major); the tensor code runs a section over every block
before the next section.  A section's block j depends only on its input
block and on the state entering it, so both orders give the same bits.
Blocks above :data:`MAX_BLOCK` samples, and cascades whose tables overflow
shared memory (:attr:`ScanTables.wide`), run the kernel's wide variant:
the same operations, the block in global scratch.

* :func:`scan_tables` packs the float32 tables of ``_scan_tables_host``
  into one buffer a ``(sos, block_size, device)``, cached.
* :func:`sos_scan_cuda` launches the kernel (``.launches`` counts each).
* :func:`sos_scan_plain` is the plain PyTorch version in the kernel's
  order, reading the same packed tables: the kernel's arithmetic, held to
  the tensor code on the CPU by the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.runtime.profiler import span

__all__ = ["MAX_BLOCK", "HEAD", "SMEM_MAX", "ScanTables", "table_stride",
           "packed_tables", "scan_tables", "sos_scan_cuda", "sos_scan_plain"]

#: the longest scan block the kernel holds in registers and shared memory:
#: 1024 threads of 8 elements (two float2 buffers of a block, 128 KiB);
#: longer blocks take the wide variant
MAX_BLOCK = 8192
#: shared memory a CTA may ask for on sm_90 (227 KiB)
SMEM_MAX = 232448
#: floats of a section's table before its doubling steps: u0 u1 c1 c2 b0
#: and three zeros
HEAD = 8


class ScanTables(NamedTuple):
    """The packed tables of one cascade at one block size."""

    #: ``(ns, stride)`` float32, a row a section (layout in
    #: ``csrc/sos_scan.cu``)
    buf: torch.Tensor
    ns: int
    #: doubling steps a block: shifts 1, 2, 4, ... below ``block_size``
    nsh: int
    block_size: int
    #: whether the kernel's wide variant runs these tables: blocks above
    #: ``MAX_BLOCK``, or the doubling's buffers, two sets of states and
    #: the sections' heads and steps above ``SMEM_MAX`` (``csrc/sos_scan.cu``
    #: ``sos_scan_is_wide``)
    wide: bool


def table_stride(block_size: int, nsh: int) -> int:
    """Floats of one section's packed table: the head, the doubling
    steps' 2×2 matrices, the output weights ``g`` (pairs) and
    ``P^(k+1)`` (2×2) for every index of a block."""
    return HEAD + 4 * nsh + 6 * block_size


def packed_tables(sos, block_size: int) -> np.ndarray:
    """``(ns, stride)`` float32: each section's ``_scan_tables_host``
    entries, as the kernel reads them."""
    from llzlab_tpu_torch.ops import iir

    kinds, params = iir.sos_plan(sos)
    L = int(block_size)
    rows = []
    for kind, p in zip(kinds, params):
        tab = iir._scan_tables_host(kind, tuple(float(v) for v in p), L)
        nsh = len(tab["shifts"])
        head = np.zeros(HEAD, np.float32)
        head[:5] = (*tab["u"], *tab["c"], tab["b0"])
        rows.append(np.concatenate([head, tab["steps"].reshape(-1),
                                    tab["g"].reshape(-1),
                                    tab["carry"].reshape(-1)]))
    return np.stack(rows).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _scan_tables(sos_bytes: bytes, ns: int, block_size: int,
                 device: str) -> ScanTables:
    sos = np.frombuffer(sos_bytes, np.float64).reshape(ns, -1)
    buf = torch.from_numpy(packed_tables(sos, block_size)).to(device)
    # the shifts 1, 2, 4, ... below block_size
    nsh = (block_size - 1).bit_length()
    smem = 8 * (2 * block_size + 2 * ns) + 4 * ns * (HEAD + 4 * nsh)
    return ScanTables(buf, ns, nsh, block_size,
                      block_size > MAX_BLOCK or smem > SMEM_MAX)


def scan_tables(sos, block_size: int, device="cpu") -> ScanTables:
    """The packed tables of ``sos`` for blocks of ``block_size`` on
    ``device``, built and copied there once (cached by the coefficients'
    bytes, the block size and the device)."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or block_size < 1:
        raise ValueError(f"sos must be (ns, 6) and block_size ≥ 1, got "
                         f"{sos.shape} and {block_size}")
    return _scan_tables(sos.tobytes(), sos.shape[0], int(block_size),
                        str(torch.device(device)))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sos_scan_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p, i, p]
    lib.sos_scan_launch.restype = i


def _check(x: torch.Tensor, tables: ScanTables,
           zi: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take: the type and shape first,
    then the device."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (rows, t) float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    want = (x.shape[0], tables.ns, 2)
    if zi is not None and (zi.dtype != torch.float32
                           or tuple(zi.shape) != want
                           or not zi.is_contiguous()):
        raise ValueError(f"zi must be a contiguous {want} float32 tensor, "
                         f"got {zi.dtype} {tuple(zi.shape)}")
    if not x.is_cuda:
        raise ValueError("sos_scan_cuda needs a CUDA tensor")
    if tables.buf.device != x.device or (zi is not None
                                         and zi.device != x.device):
        raise ValueError(f"x on {x.device}, tables on {tables.buf.device}"
                         f"{'' if zi is None else f', zi on {zi.device}'}")


def sos_scan_cuda(x: torch.Tensor, tables: ScanTables,
                  zi: Optional[torch.Tensor] = None,
                  return_zf: bool = False):
    """Launch the kernel on ``torch.cuda.current_stream()``: ``x (rows, t)``
    from ``zi (rows, ns, 2)`` (zeros when None) → ``(y, zf)``, ``zf`` None
    unless ``return_zf``.  One launch a call with rows and samples; bitwise
    the tensor code (module docstring).  The wide variant takes ``2 ·
    block_size`` float2 of scratch for each of its CTAs, two an SM at
    most."""
    with span("kernels", "sos_scan"):
        _check(x, tables, zi)
        rows, t = x.shape
        y = torch.empty((rows, t), dtype=torch.float32, device=x.device)
        zf = (torch.empty((rows, tables.ns, 2), dtype=torch.float32,
                          device=x.device) if return_zf else None)
        if rows == 0 or t == 0:
            if zf is not None:
                zf.copy_(zi if zi is not None else torch.zeros_like(zf))
            return y, zf
        lib = _build.load("sos_scan", _declare)
        scratch, ctas = None, 0
        if tables.wide:
            ctas = min(rows, 2 * torch.cuda.get_device_properties(
                x.device).multi_processor_count)
            scratch = torch.empty(ctas * 4 * tables.block_size,
                                  dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            rc = lib.sos_scan_launch(
                x.data_ptr(), tables.buf.data_ptr(),
                None if zi is None else zi.data_ptr(), y.data_ptr(),
                None if zf is None else zf.data_ptr(), rows, t,
                tables.block_size, tables.ns, tables.nsh,
                None if scratch is None else scratch.data_ptr(), ctas,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "sos_scan")
        sos_scan_cuda.launches += 1
        return y, zf


sos_scan_cuda.launches = 0


def _state_at(z0, z1, s0, s1, p):
    """``z + (s0·P[:, 0] + s1·P[:, 1])``, ``P`` the row-major 2×2 ``p``:
    ``ops/iir.py``'s ``_state_at``, a component at a time."""
    return (z0 + (s0 * p[0] + s1 * p[1]), z1 + (s0 * p[2] + s1 * p[3]))


def sos_scan_plain(x: torch.Tensor, tables: ScanTables,
                   zi: Optional[torch.Tensor] = None,
                   return_zf: bool = False):
    """The kernel's arithmetic in plain PyTorch, float32, in its order:
    block, then section, then the doubling, from the packed tables (on
    any device; the rows at once).  Same arguments and results as
    :func:`sos_scan_cuda`."""
    rows, t = x.shape
    L, ns, nsh = tables.block_size, tables.ns, tables.nsh
    tab = tables.buf.to(x.device)
    st = (torch.zeros((rows, ns, 2), dtype=torch.float32, device=x.device)
          if zi is None else zi.to(torch.float32).clone())
    zf = st.clone()
    nblk = -(-t // L)
    xb = F.pad(x.to(torch.float32), (0, nblk * L - t)).reshape(rows, nblk, L)
    y = torch.empty_like(xb)
    g_at, pk_at = HEAD + 4 * nsh, HEAD + 4 * nsh + 2 * L
    for j in range(nblk):
        v = xb[:, j]
        for s in range(ns):
            sec = tab[s]
            u0, u1, c1, c2, b0 = sec[:5]
            s0, s1 = st[:, s, 0:1], st[:, s, 1:2]
            z0, z1 = v * u0, v * u1
            for i in range(nsh):
                sh = 1 << i
                m00, m01, m10, m11 = sec[HEAD + 4 * i:HEAD + 4 * i + 4]
                a0, a1 = z0[:, :-sh], z1[:, :-sh]
                n0 = z0[:, sh:] + (a0 * m00 + a1 * m01)
                n1 = z1[:, sh:] + (a0 * m10 + a1 * m11)
                z0 = torch.cat([z0[:, :sh], n0], 1)
                z1 = torch.cat([z1[:, :sh], n1], 1)
            out = v * b0
            out[:, 1:] = out[:, 1:] + (z0[:, :-1] * c1 + z1[:, :-1] * c2)
            g = sec[g_at:pk_at].reshape(L, 2)
            v = out + (s0 * g[:, 0] + s1 * g[:, 1])
            pk = sec[pk_at:].reshape(L, 4)
            if j == nblk - 1:
                k = (t - 1) % L
                zf[:, s, 0], zf[:, s, 1] = _state_at(
                    z0[:, k], z1[:, k], s0[:, 0], s1[:, 0], pk[k])
            st[:, s, 0], st[:, s, 1] = _state_at(
                z0[:, L - 1], z1[:, L - 1], s0[:, 0], s1[:, 0], pk[L - 1])
        y[:, j] = v
    return y.reshape(rows, nblk * L)[:, :t], (zf if return_zf else None)

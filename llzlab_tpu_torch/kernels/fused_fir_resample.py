"""Kernel B1: the fused FIR → polyphase resample step, by hand for Hopper
(``csrc/fused_fir_resample.cu``).

Replaces the Pallas TPU kernel ``llzlab_tpu/kernels/fused_fir_resample.py``
(``_kernel``, the v3 dataflow; entry ``fused_fir_resample_pallas``).  It is
numerically equal (sums reassociated) to

    resample_poly(fir_filter(x, fir_taps, method="block2"), up, down, rtaps)

with one streaming state: the last ``2·block`` input samples, enough to
recompute both the FIR history and the resampler's ``K−1``-sample lookback.

* :func:`fused_fir_resample` is the entry (port of
  ``fused_fir_resample_pallas``): a CUDA tensor launches the kernel
  (:func:`fused_fir_resample_cuda`, which counts its launches in
  ``.launches``), a CPU tensor runs :func:`fused_fir_resample_plain`.
* The plain version is block2 FIR of ``[hist | x]`` then the dense slab
  product ``slab (B, S, down+K−1) @ Rᵀ``, with the bf16 hi/lo split
  emulated for ``"high"``.

Where the shape allows it (:func:`wgmma_fits`: ``down`` a multiple of 16
and the working set in shared memory, as at 1024 taps and 147/160), both
precisions run a persistent, warp-specialised kernel whose stage 1 is on
the tensor cores' ``wgmma`` (``csrc/fir_wgmma.cuh``) and whose units of
8192 outputs start at multiples of 64 of the stream index: "high" in three
bf16 passes with stage 2 on ``wgmma`` too, "highest" in six exact bf16
passes over three-way splits of the fp32 operands (:func:`bf16_hi_mid_lo
<llzlab_tpu_torch.kernels.block2_fir.bf16_hi_mid_lo>`) with stage 2 on
fp32 FMA.  Elsewhere "high" is ``mma.sync`` (``csrc/fir_mma.cuh``) and
"highest" fp32 FMA (``csrc/fir_tile.cuh``), from blocks whose windows start
at multiples of 8 (:func:`_window_origin`).  Either way calls which cut the
stream differently give the same bits.  ``fused_fir_resample_cuda
.wgmma_launches`` counts the launches of the wgmma path at either
precision, ``.wgmma_highest_launches`` those at "highest".

Shape envelope, program length and state length are the JAX package's
(``fused_supports``, ``fused_program_in``, ``fused_state_len``), so a port
chain streams on the same block grid with same-shaped state.  The TPU's
VMEM knobs (``gb``, ``rs_batch``, ``p_mult``, ``cb``) and its experiments
(``impl="v4"``, ``wide``, ``nw``) have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.kernels.block2_fir import (MODES, _bf16_split,
                                                 _mode_tables, bf16_hi_lo,
                                                 bf16_hi_mid_lo,
                                                 block2_fir_plain, mma_rows,
                                                 tap_tables)
from llzlab_tpu_torch.ops.fir import block2_block
from llzlab_tpu_torch.ops.resample import (_phase_layout, polyphase_weights,
                                           resample_output_len)
from llzlab_tpu_torch.runtime.profiler import span

__all__ = [
    "fused_fir_resample",
    "fused_fir_resample_cuda",
    "fused_fir_resample_plain",
    "fused_supports",
    "fused_static_ok",
    "fused_program_in",
    "fused_state_len",
    "bank_tables",
    "mma_bank_tables",
    "kernel_tables",
    "kernel_fits",
    "wgmma_fits",
    "wgmma_tap_tables",
]

#: FIR outputs per stage-1 pass of a CUDA block ("high": 8 warps × 4
#: m-tiles × 128; "highest": two rounds of 512 threads × 4)
_STEP = 4096
#: a block's y window starts at a multiple of this many samples of the
#: absolute stream index (the tensor-core tile width, csrc/fir_mma.cuh)
_ALIGN = 8
#: dynamic shared memory one block may use on sm_90 (227 KB)
_SMEM_MAX = 232448
#: the wgmma path: phases of its product, which is also its windows'
#: alignment, and outputs of a unit (csrc/fir_wgmma.cuh)
_WG_PH = 64
_WG_LY = 8192


def fused_program_in(ntaps: int, up: int, down: int) -> int:
    """Input samples per program of the JAX kernel, kept as the stream
    granularity: the smallest P with ``P % (2·block) == 0``,
    ``P % down == 0`` and ``(P/down)·up % 128 == 0``."""
    block = block2_block(ntaps)
    g0 = 128 // math.gcd(up, 128)
    return (g0 * down * 2 * block) // math.gcd(g0 * down, 2 * block)


def fused_state_len(ntaps: int) -> int:
    """Streaming history length (input samples): ``2·block``."""
    return 2 * block2_block(ntaps)


def fused_static_ok(ntaps: int, up: int, down: int, k: int) -> bool:
    """Channel/length-independent part of the shape envelope."""
    block = block2_block(ntaps)
    if not (ntaps - 1 <= block <= 2048):
        return False
    if k - 1 > block or k - 1 > down + block:  # halo must fit one y-block
        return False
    p = fused_program_in(ntaps, up, down)
    return p <= 65536


def fused_supports(channels: int, ntaps: int, up: int, down: int,
                   k: int, t: int) -> bool:
    """Shape envelope of the fused op (the JAX package's, unchanged)."""
    if not (channels >= 8 and channels % 8 == 0):
        return False
    if not fused_static_ok(ntaps, up, down, k):
        return False
    p = fused_program_in(ntaps, up, down)
    return t % p == 0 and t > 0


def _run_groups(down: int, k: int) -> int:
    """Output groups per CUDA block: as many as fill one stage-1 pass
    (``groups·down + K − 1 + 7 ≤ _STEP``, the 7 for a window origin rounded
    down to a multiple of 8; 25 at the headline), or the fewest whole
    passes that hold one group."""
    passes = 1
    while (passes * _STEP - (_ALIGN - 1) - (k - 1)) // down < 1:
        passes += 1
    return (passes * _STEP - (_ALIGN - 1) - (k - 1)) // down


def _window_origin(s0: int, down: int, k: int, align: int = _ALIGN) -> int:
    """Stream index of the first y sample of the block whose first output
    group is ``s0``: ``s0·down − (K−1)`` rounded down to a multiple of
    ``align``, 8 on the ``mma.sync`` path and ``_WG_PH`` on the wgmma path
    (mirrors ``window_origin`` and ``wg_window_origin`` in the .cu)."""
    return (s0 * down - (k - 1)) // align * align


def _geometry(ntaps: int, down: int, k: int, mode: str):
    """``(rows of taps, x window, y window)`` of one CUDA block in samples
    (mirrors ``geometry`` in the .cu)."""
    ly = _run_groups(down, k) * down + k - 1 + (_ALIGN - 1)
    lyp = -(-ly // _STEP) * _STEP
    if mode == "high":
        kt = mma_rows(ntaps)
        return kt, lyp + kt - _ALIGN, lyp
    ntp = -(-ntaps // 32) * 32
    return ntp, lyp + ntp, lyp


def _smem_bytes(ntaps: int, down: int, k: int, mode: str) -> int:
    """Shared memory of one CUDA block (mirrors ``geometry`` in the .cu).
    "highest": the taps, the x window and the y window in f32.  "high", in
    bf16 hi and lo each: the taps' (8, kt + 8) Toeplitz tiles and the x
    window, or where that is more the 32 rows of ``down + K − 1`` (rounded
    up to 16, and 8 of padding) of stage 2's slab that take their place;
    then the y window."""
    rows, lx, lyp = _geometry(ntaps, down, k, mode)
    if mode == "high":
        k2 = -(-(down + k - 1) // 16) * 16
        scratch = max(2 * _ALIGN * (rows + 8) + 2 * lx, 2 * 32 * (k2 + 8))
        return 2 * (scratch + 2 * lyp)
    return 4 * (rows + lx + lyp)


def kernel_fits(ntaps: int, down: int, k: int) -> bool:
    """Whether one CUDA block's working set fits the 227 KB of shared
    memory in both modes (69 KB in "high" at the headline, three blocks on
    an SM; a ``down`` of
    many thousand samples makes the y window too long)."""
    return max(_smem_bytes(ntaps, down, k, m) for m in MODES) <= _SMEM_MAX


def _wgmma_groups(down: int, k: int) -> int:
    """Output groups of a unit of the wgmma path: as many as fit its 8192
    outputs with ``K − 1`` of left halo and 63 of alignment (50 at the
    headline); under 1 where one group does not fit."""
    return (_WG_LY - (_WG_PH - 1) - (k - 1)) // down


def _wgmma_kt(ntaps: int) -> int:
    """Rows of the wgmma path's product: ``ntaps + 63`` rounded up to 16
    (``fir_wg_kt`` in csrc/fir_wgmma.cuh)."""
    return mma_rows(ntaps, _WG_PH)


def _wgmma_chunks(nt: int, up: int, down: int, k: int):
    """First and last 16-tau chunk of the dense bank that n-tile ``nt``
    (phases ``8·nt`` … ``8·nt + 7``) reaches (``wg_ks_lo`` / ``wg_ks_hi``
    in the .cu)."""
    p = min(8 * nt + 7, up - 1)
    return (8 * nt * down // up) // 16, (p * down // up + k - 1) // 16


def _wgmma_band(up: int, down: int, k: int) -> int:
    """Taus of the widest n-tile's band at "highest" (``ks`` in the .cu):
    ``q`` of its last phase less ``q`` of its first, plus K, ``q_p =
    p·down // up`` (72 at 147/160, K = 64)."""
    return max(min(8 * t + 7, up - 1) * down // up - 8 * t * down // up + k
               for t in range(-(-up // 8)))


def _wgmma_geometry(ntaps: int, up: int, down: int, k: int):
    """``(kt, core matrices of a tap table, x window, rows of an x plane,
    n-tiles, bank chunks kept, y planes, rows of a y plane)`` of the wgmma
    path (mirrors ``wg_geometry`` in the .cu)."""
    kt = _wgmma_kt(ntaps)
    lx = -(-(_WG_LY + kt - _WG_PH) // 64) * 64
    ntiles = -(-up // 8)
    nv = sum(hi - lo + 1 for lo, hi in
             (_wgmma_chunks(nt, up, down, k) for nt in range(ntiles)))
    npl = down // 8
    nks = -(-(down + k - 1) // 16)
    reach = 64 * -(-_wgmma_groups(down, k) // 64) - 1 + (8 + 2 * nks) // npl
    la = (max(1029 // npl, reach) + 1) | 1
    return kt, kt // 8 + 7, lx, (lx // 64) | 1, ntiles, nv, npl, la


def _wgmma_smem_bytes(ntaps: int, up: int, down: int, k: int,
                      mode: str = "high") -> int:
    """Shared memory of a wgmma block: 128 bytes of barriers, the tap
    tables, the ring of two half windows in f32, then for each of two
    consumers its x planes.  "high": tables and planes hi and lo, the
    offsets and the chunks of stage 2's bank that the n-tiles reach before
    the consumers, and the y planes (hi, lo: down / 8 planes of 16-byte
    rows) in the place of the x planes.  "highest": tables and planes hi,
    mid and lo, a ring of two quarter windows, stage 2's bank in f32 as
    each n-tile's band (:func:`_wgmma_band` taus of 8 phases, and 4 floats
    of padding), and y in f32 (8192 outputs) in the place of the
    planes."""
    kt, nd, lx, las, ntiles, nv, npl, la = _wgmma_geometry(ntaps, up, down, k)
    if mode == "highest":
        return (128 + 3 * 128 * nd + 2 * lx
                + 4 * ntiles * (8 * _wgmma_band(up, down, k) + 4)
                + 2 * max(3 * 128 * las, 4 * (_WG_LY + _WG_LY // 32)))
    cw = max(2 * 128 * las, 2 * 16 * npl * la)
    return (128 + 2 * 128 * nd + 4 * lx + -(-4 * ntiles // 16) * 16
            + 512 * nv + 2 * cw)


def wgmma_fits(ntaps: int, up: int, down: int, k: int,
               mode: str = "high") -> bool:
    """Whether ``mode`` runs on the wgmma path: ``down`` a multiple of 16
    (the "high" stage 2 reads the slab's rows, ``down`` apart, as rows of
    the tensor cores' 8-row tiles; both modes share the units), a unit
    holds a group, and the block's working set fits the 227 KB of shared
    memory (at 1024 taps, 147/160, K = 64: 204 KB at "high", 223.5 KB at
    "highest"; not at 2000 taps there, nor above 1089 at "highest")."""
    return (down % 16 == 0 and _wgmma_groups(down, k) >= 1
            and _wgmma_smem_bytes(ntaps, up, down, k, mode) <= _SMEM_MAX)


@functools.lru_cache(maxsize=16)
def _wgmma_taps_cached(taps_bytes: bytes, device: str, mode: str):
    taps = np.frombuffer(taps_bytes, np.float64).copy()
    kt = _wgmma_kt(len(taps))
    d, r, c = np.ogrid[:kt // 8 + 7, :8, :8]
    idx = kt - 1 - 8 * d - r - c
    ok = torch.from_numpy((idx >= 0) & (idx < len(taps)))
    idx = torch.from_numpy(np.clip(idx, 0, len(taps) - 1))
    zero = torch.zeros((), dtype=torch.bfloat16)
    parts = (bf16_hi_mid_lo(torch.from_numpy(taps).to(torch.float32))
             if mode == "highest" else bf16_hi_lo(taps))
    return torch.stack([torch.where(ok, part.to(torch.bfloat16)[idx], zero)
                        for part in parts]).contiguous().to(device)


def wgmma_tap_tables(fir_taps, device="cpu", mode: str = "high"):
    """The taps' Toeplitz as the wgmma path reads it
    (``csrc/fir_wgmma.cuh``): ``(parts, kt/8 + 7, 8, 8)`` bf16, the bf16 hi
    then lo parts of the taps at "high" (:func:`bf16_hi_lo
    <llzlab_tpu_torch.kernels.block2_fir.bf16_hi_lo>`), hi, mid then lo of
    their float32 values at "highest" (:func:`bf16_hi_mid_lo
    <llzlab_tpu_torch.kernels.block2_fir.bf16_hi_mid_lo>`);
    ``D[d, r, c] = taps[kt − 1 − 8d − r − c]`` (zero outside the taps),
    ``kt = ntaps + 63`` rounded up to 16: core matrix ``(n'/8, k/8)`` of
    ``A[n', k] = taps[kt − 1 − n' − k]`` is ``D[n'/8 + k/8]``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return _wgmma_taps_cached(np.asarray(fir_taps, np.float64).tobytes(),
                              str(device), mode)


@functools.lru_cache(maxsize=16)
def _bank_cached(r_bytes: bytes, up: int, down: int, mode: str, device: str,
                 dtype: torch.dtype, dense: bool):
    w = polyphase_weights(np.frombuffer(r_bytes, np.float64), up, down)
    if dense:  # the plain version's (down+K−1, up) product operand
        return _mode_tables(np.ascontiguousarray(w.T), mode, device, dtype)
    # the kernel's (K, up) bank: bank[j, p] = W[p, q_p + K−1−j], the K
    # nonzero entries of row p
    k = w.shape[1] - down + 1
    _, q = _phase_layout(up, down)
    cols = q[None, :] + (k - 1) - np.arange(k)[:, None]
    return _mode_tables(np.ascontiguousarray(w[np.arange(up)[None, :], cols]),
                        mode, device, dtype)


def bank_tables(rtaps, up: int, down: int, mode: str = "high", device="cpu",
                dtype=torch.float32, dense: bool = False):
    """Resample bank: ``(f32,)`` for "highest" or ``(hi, lo)`` for "high",
    in ``dtype``.  ``dense``: the ``(down+K−1, up)`` transposed polyphase
    matrix (plain version); else the ``(K, up)`` nonzero bank (the kernel
    at "highest"; at "high" it reads :func:`mma_bank_tables`)."""
    return _bank_cached(np.asarray(rtaps, np.float64).tobytes(), up, down,
                        mode, str(device), dtype, dense)


def _mma_fragments(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``(N, K)`` bf16 hi and lo (``N % 8 == 0``, ``K % 16 == 0``) in the
    order ``mma.sync.m16n8k16`` holds its B operand: ``(N/8, K/16, 32, 4,
    2)``, where lane ``l`` of n-tile ``nt`` and chunk ``ks`` has row
    ``n = 8·nt + l // 4`` at columns ``k = 16·ks + 2·(l % 4) + {0, 1}`` of
    hi, the same + 8 of hi, then both of lo."""
    def frag(w):  # (nt, n, ks, half, kq, pair) → (nt, ks, n, kq, half, pair)
        n, k = w.shape
        return (w.reshape(n // 8, 8, k // 16, 2, 4, 2)
                .permute(0, 2, 1, 4, 3, 5).reshape(n // 8, k // 16, 32, 2, 2))
    return torch.cat([frag(hi), frag(lo)], dim=3).contiguous()


@functools.lru_cache(maxsize=16)
def _mma_bank_cached(r_bytes: bytes, up: int, down: int, device: str):
    w = polyphase_weights(np.frombuffer(r_bytes, np.float64), up, down)
    pad = np.zeros((-(-up // 8) * 8, -(-w.shape[1] // 16) * 16), np.float64)
    pad[:up, :w.shape[1]] = w
    return _mma_fragments(*bf16_hi_lo(pad)).to(device)


def mma_bank_tables(rtaps, up: int, down: int, device="cpu"):
    """The dense polyphase matrix ``R (up, down+K−1)`` as the tensor-core
    stage 2 of kernel B1 reads it: the bf16 hi and lo parts of
    ``bank_tables(dense=True)``, zero-padded to ``(up rounded up to 8,
    down+K−1 rounded up to 16)``, in fragment order
    (:func:`_mma_fragments`), one tensor."""
    return _mma_bank_cached(np.asarray(rtaps, np.float64).tobytes(), up,
                            down, str(device))


def kernel_tables(fir_taps, rtaps, up: int, down: int, mode: str,
                  device="cpu"):
    """What kernel B1 reads: FIR taps then the bank.  "highest":
    ``(taps f32, bank (K, up) f32)``.  "high": ``(taps_hi, taps_lo,
    bank)``, bf16, the bank dense (:func:`mma_bank_tables`)."""
    if mode == "highest":
        return (tap_tables(fir_taps, mode, device)
                + bank_tables(rtaps, up, down, mode, device))
    return (tap_tables(fir_taps, mode, device)
            + (mma_bank_tables(rtaps, up, down, device),))


def fused_fir_resample_plain(x: torch.Tensor, hist: torch.Tensor, fir_taps,
                             up: int, down: int, rtaps,
                             mode: str = "high") -> torch.Tensor:
    """Plain PyTorch version of kernel B1 in x's dtype (f32, or f64 for a
    reference).  ``x (B, T)`` with ``T % down == 0``, ``hist (B, 2·block)``
    → ``(B, T·up/down)``."""
    fir = np.asarray(fir_taps, np.float64)
    block = block2_block(len(fir))
    k = len(rtaps) // up
    b, t = x.shape
    # y for stream indices [−block, T): block2 over [hist | x], whose first
    # block is its history
    y = block2_fir_plain(torch.cat([hist.to(x.dtype), x], dim=-1), fir,
                         block, mode)
    # slab[s, τ] = y[s·down − (K−1) + τ]
    y = y[:, block - (k - 1):]
    tabs = bank_tables(rtaps, up, down, mode, x.device, x.dtype, dense=True)
    if mode == "highest":
        z = y.unfold(-1, down + k - 1, down) @ tabs[0]
    else:
        r_hi, r_lo = tabs
        y_hi, y_lo = (v.unfold(-1, down + k - 1, down)
                      for v in _bf16_split(y))
        z = y_hi @ r_hi + y_lo @ r_hi + y_hi @ r_lo
    return z.reshape(b, (t // down) * up)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_fir_resample_launch.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.fused_fir_resample_launch.restype = i


def fused_fir_resample_cuda(x: torch.Tensor, hist: torch.Tensor, fir_taps,
                            up: int, down: int, rtaps,
                            mode: str = "high") -> torch.Tensor:
    """Launch kernel B1 on ``torch.cuda.current_stream()``."""
    with span("kernels", "B1"):
        fir = np.asarray(fir_taps, np.float64)
        ntaps = len(fir)
        k = len(rtaps) // up
        if not (x.is_cuda and hist.is_cuda and x.device == hist.device):
            raise ValueError("fused_fir_resample_cuda needs x and hist on one "
                             "CUDA device")
        if x.dtype != torch.float32 or hist.dtype != torch.float32:
            raise ValueError("x and hist must be float32")
        if x.dim() != 2 or not x.is_contiguous() or not hist.is_contiguous():
            raise ValueError("x and hist must be contiguous 2-D tensors")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        b, t = x.shape
        hl = fused_state_len(ntaps)
        if tuple(hist.shape) != (b, hl):
            raise ValueError(f"hist must be {(b, hl)}, got "
                             f"{tuple(hist.shape)}")
        if not fused_supports(b, ntaps, up, down, k, t):
            raise ValueError(
                f"fused kernel envelope: channels % 8 == 0, ntaps − 1 ≤ "
                f"block ≤ 2048, K − 1 ≤ block, T a multiple of "
                f"{fused_program_in(ntaps, up, down)} (got channels={b}, "
                f"ntaps={ntaps}, K={k}, T={t})")
        if not kernel_fits(ntaps, down, k):
            raise ValueError(
                f"fused kernel: "
                f"{max(_smem_bytes(ntaps, down, k, m) for m in MODES)} B of "
                f"shared memory per block exceeds {_SMEM_MAX} (down={down})")
        lib = _build.load("fused_fir_resample", _declare)
        with torch.cuda.device(x.device):
            tabs = kernel_tables(fir, rtaps, up, down, mode, x.device)
            z = torch.empty((b, (t // down) * up), dtype=torch.float32,
                            device=x.device)
            high = mode == "high"
            wg = wgmma_fits(ntaps, up, down, k, mode)
            rc = lib.fused_fir_resample_launch(
                x.data_ptr(), hist.data_ptr(), tabs[0].data_ptr(),
                tabs[1].data_ptr() if high else None,
                tabs[2 if high else 1].data_ptr(),
                wgmma_tap_tables(fir, x.device, mode).data_ptr() if wg
                else None,
                z.data_ptr(), b, t, hl, ntaps, up, down, k,
                _wgmma_groups(down, k) if wg else _run_groups(down, k),
                int(high), torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "fused_fir_resample")
        fused_fir_resample_cuda.launches += 1
        fused_fir_resample_cuda.wgmma_launches += int(wg)
        fused_fir_resample_cuda.wgmma_highest_launches += int(wg and not high)
        return z


fused_fir_resample_cuda.launches = 0
fused_fir_resample_cuda.wgmma_launches = 0
fused_fir_resample_cuda.wgmma_highest_launches = 0


def fused_fir_resample(x: torch.Tensor, fir_taps, up: int, down: int, rtaps,
                       *, zi=None, return_zf: bool = False,
                       mode: str = "high"):
    """Fused FIR→resample on ``(..., T)`` → ``(..., T·up/down)``.

    ``zi``: ``(..., 2·block)`` input history (zeros if omitted);
    ``return_zf`` also returns the final history, which is the last
    ``2·block`` samples of ``x`` (``T ≥ 2·block`` inside the envelope).
    Raises outside :func:`fused_supports`, on either device.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    fir = np.asarray(fir_taps, np.float64)
    r_np = np.asarray(rtaps, np.float64)
    if len(r_np) % up:
        r_np = np.pad(r_np, (0, up - len(r_np) % up))
    k = len(r_np) // up
    ntaps = len(fir)
    block = block2_block(ntaps)
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).to(torch.float32).contiguous()
    b = xb.shape[0]
    if not fused_supports(b, ntaps, up, down, k, t):
        raise ValueError(
            f"fused FIR→resample envelope: channels % 8 == 0 and T a "
            f"multiple of {fused_program_in(ntaps, up, down)} (got "
            f"channels={b}, T={t}, ntaps={ntaps}, K={k})")
    if zi is None:
        hist = torch.zeros((b, 2 * block), dtype=torch.float32,
                           device=x.device)
    else:
        hist = zi.reshape(b, 2 * block).to(torch.float32).contiguous()
    if xb.is_cuda:
        z = fused_fir_resample_cuda(xb, hist, fir, up, down, r_np, mode)
    elif xb.device.type == "cpu":
        z = fused_fir_resample_plain(xb, hist, fir, up, down, r_np, mode)
    else:
        raise ValueError(f"unsupported device {x.device}")
    n_out = resample_output_len(t, up, down)
    z = z[:, :n_out].reshape(shape[:-1] + (n_out,)).to(x.dtype)
    if not return_zf:
        return z
    zf = xb[:, -2 * block:].to(x.dtype).reshape(shape[:-1] + (2 * block,))
    return z, zf

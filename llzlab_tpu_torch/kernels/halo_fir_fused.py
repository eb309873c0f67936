"""Kernel B4: the halo exchange fused into the block2 FIR, by hand for
Hopper (``csrc/halo_fir_fused.cu``).

Replaces the Pallas TPU kernel ``llzlab_tpu/kernels/halo_fir_fused.py``
(``_kernel``, entry ``block2_fir_halo_fused``).  Contract (the same): on a
1-D time mesh each rank holds ``x_local (C, T_loc)`` and gets its part
``(C, T_loc)`` of the causal FIR of the whole stream, so that the ranks'
outputs, concatenated, equal ``fir_filter(method="block2")`` on the
unsharded stream; rank 0 starts from ``first_shard_value`` (a carried
history of ``ntaps − 1 … block`` samples) or zeros.  One kernel launch per
rank sends the rank's tail to its right neighbour, computes every output
that needs no halo meanwhile, and computes y-block 0 once the halo has
landed.

* :func:`block2_fir_halo_fused` is the entry: a CUDA mesh launches the
  kernel, once per rank of this process in rank order on the rank's stream
  (:func:`block2_fir_halo_fused_cuda`, which counts its launches in
  ``.launches``); a CPU mesh runs the plain version.  Nothing falls back.
  The mesh's ranks may live in several processes (None in the list of
  parts for the ranks of other processes): an edge between two processes
  of one host runs B3's protocol through CUDA IPC, with the receiver's
  acknowledgement; an edge between two hosts (``NET``) takes the tail
  through NCCL, queued by the host before the launch, and the waiters
  wait for its flag as on any other edge, while the rest of the output is
  computed (``kernels/halo_ring.py``).
* :func:`block2_fir_halo_fused_plain` is the plain PyTorch version:
  ``left_halo``, then ``block2_fir_plain`` on ``[zeros | halo | x_local]``.

The kernel's sums are kernel B2's: ``csrc/fir_tile.cuh`` on the CUDA cores
at ``"highest"``, the block run of ``csrc/fir_mma.cuh`` on the tensor cores
at ``"high"``, every tile starting at a multiple of 8 of the stream index
(shards start at multiples of the block).  So on the card the concatenated
outputs are bitwise equal to ``block2_fir_cuda`` on the unsharded stream.
What bounds it is what bounds B2: the fp32 FMA rate, or at ``"high"``
the ``mma.sync`` tile, at about a quarter of the tensor cores' bf16 rate.
:func:`tile_plan` mirrors the kernel's tile plan: which blocks compute the
tiles that need no halo (wide runs, the taps' Toeplitz tile resident) and
which wait for the halo and compute y-block 0 (narrow runs, at most
``MAX_WAIT[mode]`` blocks, so that waiters never fill the card and keep a
sender off it).  The exchange state is B3's (``HaloExchange``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.kernels import halo_ring as _hr
from llzlab_tpu_torch.kernels.block2_fir import (MMA_PASS, MODES,
                                                 block2_fir_plain,
                                                 mma_smem_bytes, tap_tables)
from llzlab_tpu_torch.ops.fir import block2_block
from llzlab_tpu_torch.parallel.halo import left_halo
from llzlab_tpu_torch.parallel.mesh import DspMesh, local_block, note_traffic
from llzlab_tpu_torch.runtime.profiler import span

__all__ = ["block2_fir_halo_fused", "block2_fir_halo_fused_cuda",
           "block2_fir_halo_fused_plain", "halo_fused_supports",
           "tile_plan", "plan_tiles"]

#: constants of csrc/halo_fir_fused.cu
WRUN, MAX_SEND, MAX_CARD_RANKS = 1024, 8, 16
#: blocks of a launch that wait for the halo, at most
MAX_WAIT = {"highest": 32, "high": 16}


def halo_fused_supports(channels: int, ntaps: int, t_local: int) -> bool:
    """Shape envelope (the JAX package's, unchanged): at least two whole
    blocks per shard, a block that is a multiple of 128, and at most 256
    channels (the TPU kernel's single channel tile)."""
    block = block2_block(ntaps)
    if not (ntaps - 1 <= block and block % 128 == 0):
        return False
    if channels < 1 or channels > 256:
        return False
    nblk = t_local // block
    return nblk >= 2 and t_local == nblk * block


def tile_plan(c: int, t: int, block: int, ntaps: int, mode: str,
              resident: Optional[int] = None) -> dict:
    """The kernel's tile plan (``tile_plan`` in csrc/halo_fir_fused.cu) for
    a ``(c, t)`` shard.  Waiter tiles are ``WRUN`` outputs wide: the first
    ``nwt`` of a row, ``head`` outputs, walked by ``nwait`` blocks after
    the halo has landed.  Interior tiles, ``irun`` wide from ``head`` on,
    are walked by ``n_int_blocks`` blocks: one each at "highest"; at "high"
    at most the ``resident`` blocks the card holds at once less the waiters
    (``None``: unbounded).  ``smem_bytes``: a block's shared memory."""
    high = mode == "high"
    irun = MMA_PASS if high else WRUN
    nwt = min(-(-block // WRUN), -(-t // WRUN))
    head = nwt * WRUN
    tiles_in = -(-(t - head) // irun) if t > head else 0
    n_interior = c * tiles_in
    nwait = min(c * nwt, MAX_WAIT[mode])
    n_int_blocks = n_interior
    if high and resident is not None:
        n_int_blocks = min(n_interior, resident - nwait)
    grid = n_int_blocks + nwait
    ntp = -(-ntaps // 32) * 32
    return dict(irun=irun, nwt=nwt, head=head, tiles_in=tiles_in,
                n_interior=n_interior, n_int_blocks=n_int_blocks,
                nwait=nwait, grid=grid, nsend=min(grid, MAX_SEND),
                smem_bytes=(mma_smem_bytes(ntaps) if high
                            else 4 * (ntp + WRUN + ntp)))


def plan_tiles(plan: dict, c: int, block_index: int):
    """``(row, first output, width, waits)`` of the tiles that CUDA block
    ``block_index`` of ``plan`` computes, in order."""
    nib = plan["n_int_blocks"]
    if block_index < nib:
        return [(q // plan["tiles_in"],
                 plan["head"] + (q % plan["tiles_in"]) * plan["irun"],
                 plan["irun"], False)
                for q in range(block_index, plan["n_interior"], nib)]
    return [(q // plan["nwt"], (q % plan["nwt"]) * WRUN, WRUN, True)
            for q in range(block_index - nib, c * plan["nwt"],
                           plan["nwait"])]


def _check(parts, taps, mesh, first_shard_value, mode):
    """Shared argument checks; returns ``(taps f64, block, h)``."""
    _hr.check_time_mesh(mesh, parts)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    taps = np.asarray(taps, np.float64)
    ntaps = len(taps)
    block = block2_block(ntaps)
    ref = local_block(parts)
    if ref.dim() != 2 or any(p is not None and p.shape != ref.shape
                             for p in parts):
        raise ValueError("shards must be equal-shaped 2-D (C, T_loc) tensors")
    b, t = ref.shape
    # history width: ntaps−1 at least; callers may carry a full block (the
    # block2 streaming state)
    h = (ntaps - 1 if first_shard_value is None
         else int(first_shard_value.shape[-1]))
    if not ntaps - 1 <= h <= block:
        raise ValueError(f"history width {h} outside [{ntaps - 1}, {block}]")
    if not halo_fused_supports(b, ntaps, t):
        raise ValueError(
            f"unsupported shape for halo-fused FIR: C={b} ntaps={ntaps} "
            f"T_loc={t} (need >=2 whole {block}-blocks)")
    if (first_shard_value is not None
            and tuple(first_shard_value.shape) != (b, h)):
        raise ValueError(f"first_shard_value must be {(b, h)}, got "
                         f"{tuple(first_shard_value.shape)}")
    return taps, block, h


def block2_fir_halo_fused_plain(parts: Sequence[Optional[torch.Tensor]],
                                taps, mesh: DspMesh, *,
                                first_shard_value: Optional[torch.Tensor]
                                = None, mode: str = "high"
                                ) -> List[Optional[torch.Tensor]]:
    """Plain PyTorch version of kernel B4: the halo by ``left_halo``, then
    the plain block2 FIR of ``[zeros(block − h) | halo | x_local]`` (None
    for the ranks of other processes)."""
    taps, block, h = _check(parts, taps, mesh, first_shard_value, mode)
    halos = left_halo(parts, h, mesh, first_shard_value=first_shard_value)
    return mesh.map(lambda part, halo: block2_fir_plain(
        torch.cat([F.pad(halo, (block - h, 0)), part], dim=-1), taps, block,
        mode), parts, halos)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.halo_fir_fused_launch.argtypes = (
        [p, p, p, p] + [i] * 6 + [p] * 9 + [i, ll, p])
    lib.halo_fir_fused_launch.restype = i
    lib.halo_fir_fused_blocks_per_sm.argtypes = [i, i]
    lib.halo_fir_fused_blocks_per_sm.restype = i


def library() -> ctypes.CDLL:
    """The kernel's library, built from ``csrc/`` on first use."""
    return _build.load("halo_fir_fused", _declare)


def blocks_per_sm(ntaps: int, mode: str) -> int:
    """Blocks of the kernel that one SM of the current card holds (read
    from the CUDA occupancy API)."""
    per_sm = library().halo_fir_fused_blocks_per_sm(ntaps,
                                                    int(mode == "high"))
    _build.check(-min(per_sm, 0), "halo_fir_fused_blocks_per_sm")
    return per_sm


def block2_fir_halo_fused_cuda(parts: Sequence[Optional[torch.Tensor]],
                               taps, mesh: DspMesh, *,
                               first_shard_value: Optional[torch.Tensor]
                               = None, mode: str = "high",
                               _net: bool = False
                               ) -> List[Optional[torch.Tensor]]:
    """Launch kernel B4 once per rank of this process, in rank order, each
    on its rank's stream.  ``parts[r]``: contiguous ``(C, T_loc)`` f32 on
    rank ``r``'s device, None for a rank of another process (whose output
    is None here).  ``.launches`` counts the launches,
    ``.cross_card_launches`` those with a neighbour on another card of this
    process, ``.cross_process_launches`` in another process,
    ``.cross_host_launches`` on another host.  ``_net`` (for the check of
    the ``NET`` branch on one card, not an entry point): on a mesh of one
    process every edge is a ``NET`` edge whose transport is a device copy
    (``HaloExchange(net=True)``)."""
    with span("kernels", "B4"):
        taps, block, h = _check(parts, taps, mesh, first_shard_value, mode)
        b, t = local_block(parts).shape
        local = [r for r in range(len(parts)) if mesh.local(r)]
        for r in local:
            part = parts[r]
            if not part.is_cuda or part.device != mesh.ranks[r].device:
                raise ValueError(f"shard {r} must lie on "
                                 f"{mesh.ranks[r].device}, got "
                                 f"{part.device}")
            if part.dtype != torch.float32 or not part.is_contiguous():
                raise ValueError(f"shards must be contiguous float32, got "
                                 f"{part.dtype} strides {part.stride()} "
                                 f"at rank {r}")
        lib = library()
        ex = _hr.HaloExchange.of(mesh, b, h, _net)
        kinds = ex.kinds
        epoch = ex.begin(parts)
        high = mode == "high"
        none = _hr.Edge(None, None, None)
        out: List[Optional[torch.Tensor]] = [None] * len(parts)
        for r in local:
            with mesh.on(r) as rank:
                nbr, mine = ex.launch_args(r)
                nbr, mine = nbr or none, mine or none
                tabs = tap_tables(taps, mode, rank.device)
                y = torch.empty((b, t), dtype=torch.float32,
                                device=rank.device)
                left = mine.buf
                if r == 0 and first_shard_value is not None:
                    carry = first_shard_value.to(
                        device=rank.device, dtype=torch.float32).contiguous()
                    left = carry.data_ptr()
                rc = lib.halo_fir_fused_launch(
                    parts[r].data_ptr(), tabs[0].data_ptr(),
                    tabs[1].data_ptr() if high else None, y.data_ptr(), b, t,
                    block, len(taps), int(high), h, nbr.buf, nbr.flag, left,
                    mine.flag, nbr.counter, nbr.ack, mine.ack, mine.rcount,
                    ex.err_ptr(r), epoch, int(_hr.WAIT_LIMIT_S * 1e9),
                    rank.stream.cuda_stream)
                _build.check(rc, "halo_fir_fused")
                ex.launched(r)
            _hr.count_launch(block2_fir_halo_fused_cuda, mesh,
                             [_hr.PROTOCOL if k == _hr.DIRECT else k
                              for k in kinds],
                             [q for q in (r, r + 1) if 0 < q < len(parts)])
            out[r] = y
        note_traffic("collective-permute", 4 * b * h, len(parts) - 1)
        return out


block2_fir_halo_fused_cuda.launches = 0
block2_fir_halo_fused_cuda.cross_card_launches = 0
block2_fir_halo_fused_cuda.cross_process_launches = 0
block2_fir_halo_fused_cuda.cross_host_launches = 0


def block2_fir_halo_fused(parts: Sequence[Optional[torch.Tensor]], taps,
                          mesh: DspMesh, *,
                          first_shard_value: Optional[torch.Tensor] = None,
                          mode: str = "high"
                          ) -> List[Optional[torch.Tensor]]:
    """Halo exchange + block2 FIR on a 1-D time mesh (its ranks in one
    process or several, of one host or of several): kernel B4 on a CUDA
    mesh, the plain version on a CPU mesh.  Orders rank against rank; the
    caller orders the mesh against its own stream (``mesh.fork`` /
    ``mesh.join``)."""
    _hr.check_time_mesh(mesh, parts)
    if mesh.is_cuda:
        return block2_fir_halo_fused_cuda(
            parts, taps, mesh, first_shard_value=first_shard_value, mode=mode)
    return block2_fir_halo_fused_plain(
        parts, taps, mesh, first_shard_value=first_shard_value, mode=mode)

"""Tensor-parallel FIR: the filter's taps split over ranks (port of
``llzlab_tpu/parallel/tap_tp.py``).

For very long filters the taps themselves are sharded: rank ``k`` owns tap
segment ``[k·P, (k+1)·P)``, convolves the (replicated) signal delayed by
``k·P`` with its segment, and the partial outputs are summed.  Here the
sum is taken in rank order on the first rank of the tap axis and copied
back to every rank (the JAX package's ``psum``).  Each segment's FIR is a
direct ``conv1d`` in float32 with TF32 off, as the JAX package's is a
``lax.conv_general_dilated`` outside Pallas.  Worthwhile only where the
taps' products outweigh the signal's broadcast; the channel / time
sharding (``sharded_ops.py``) is the production path for audio filters.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh, note_traffic

__all__ = ["fir_filter_tap_parallel"]


def _segment_fir(x: torch.Tensor, seg: torch.Tensor, delay: int):
    """Causal direct FIR of ``x (B, T)`` delayed by ``delay`` samples with
    the taps ``seg``."""
    t = x.shape[-1]
    xd = F.pad(x, (delay + len(seg) - 1, 0))[:, :t + len(seg) - 1]
    return F.conv1d(xd[:, None, :], seg.flip(0)[None, None, :])[:, 0, :]


def fir_filter_tap_parallel(
    x: torch.Tensor,
    taps,
    mesh: DspMesh,
    *,
    axis_name: str = TIME_AXIS,
    method: str = "ols",
) -> List[torch.Tensor]:
    """Causal FIR of ``x (..., T)`` with the taps sharded over
    ``axis_name``; returns the output replicated, one tensor per rank.

    ``y = Σ_k delay(x, k·P) * seg_k``, summed in rank order; matches
    ``ops.fir_filter`` to about 140 dB (the partial sums are taken in
    another order).  ``method`` is kept for the JAX signature, which
    ignores it too.  Each channel row of a ``(channel, time)`` mesh (or
    each position of the other axes) computes the same replica.
    """
    if mesh.is_distributed:
        raise ValueError("fir_filter_tap_parallel needs a mesh of this "
                         "process's ranks")
    taps = np.asarray(taps, np.float64)
    n_shards = mesh.shape[axis_name]
    ntaps = len(taps)
    seg = -(-ntaps // n_shards)
    segs = np.pad(taps, (0, seg * n_shards - ntaps)).reshape(n_shards, seg)
    axis = mesh.axis_names.index(axis_name)
    dims = tuple(mesh.shape[a] for a in mesh.axis_names)
    shape = x.shape
    xb = x.reshape(-1, shape[-1]).to(torch.float32)
    groups = {}  # ranks sharing every coordinate but the tap axis
    for r in range(len(mesh)):
        co = list(np.unravel_index(r, dims))
        k = int(co[axis])
        co[axis] = 0
        groups.setdefault(tuple(co), [None] * n_shards)[k] = r
    out: List[torch.Tensor] = [None] * len(mesh)
    mesh.fork()
    for ranks in groups.values():
        parts = []
        for k, r in enumerate(ranks):
            with mesh.on(r) as rank:
                seg_k = torch.from_numpy(segs[k].astype(np.float32)).to(
                    rank.device)
                parts.append(_segment_fir(xb.to(rank.device), seg_k,
                                          k * seg))
        root = ranks[0]
        mesh.after(root, *ranks)
        with mesh.on(root) as rank:
            acc = parts[0].clone()
            for p in parts[1:]:
                acc += p.to(rank.device)
        for k, r in enumerate(ranks):
            mesh.after(r, root)
            with mesh.on(r) as rank:
                out[r] = acc.to(rank.device, copy=True).reshape(shape).to(
                    x.dtype)
            if acc.is_cuda and r != root:
                acc.record_stream(mesh.ranks[r].stream)
        for k, (r, p) in enumerate(zip(ranks, parts)):
            if p.is_cuda and r != root:
                p.record_stream(mesh.ranks[root].stream)
    # the JAX package's all-reduce count: payload × participants, per group
    note_traffic("all-reduce", 4 * xb.numel(), len(mesh))
    mesh.join()
    return out

"""Tensor-parallel FIR: the filter's taps split over ranks (port of
``llzlab_tpu/parallel/tap_tp.py``).

For very long filters the taps themselves are sharded: rank ``k`` owns tap
segment ``[k·P, (k+1)·P)``, convolves the (replicated) signal delayed by
``k·P`` with its segment, and the partial outputs are summed.  Here the
sum is taken in rank order on the first rank of the tap axis and copied
back to every rank (the JAX package's ``psum``), through ``DspMesh.fetch``
/ ``move``, so that the ranks may live in several processes
(``runtime.distributed.global_dsp_mesh``).  Each segment's FIR is a
direct ``conv1d`` in float32 with TF32 off, as the JAX package's is a
``lax.conv_general_dilated`` outside Pallas.  Worthwhile only where the
taps' products outweigh the signal's broadcast; the channel / time
sharding (``sharded_ops.py``) is the production path for audio filters.
"""

from __future__ import annotations

from typing import List, Optional

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
) -> List[Optional[torch.Tensor]]:
    """Causal FIR of ``x (..., T)`` with the taps sharded over
    ``axis_name``; returns the output replicated, one tensor per rank
    (None for the ranks of other processes, each of which passes the same
    ``x``).

    ``y = Σ_k delay(x, k·P) * seg_k``, summed in rank order; matches
    ``ops.fir_filter`` to about 140 dB (the partial sums are taken in
    another order).  ``method`` is kept for the JAX signature, which
    ignores it too.  Each channel row of a ``(channel, time)`` mesh (or
    each position of the other axes) computes the same replica.
    """
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
    out: List[Optional[torch.Tensor]] = [None] * len(mesh)
    mesh.fork()
    for ranks in groups.values():
        parts = [mesh.run(r, lambda k, rank: _segment_fir(
            xb.to(rank.device), torch.from_numpy(
                segs[k].astype(np.float32)).to(rank.device), k * seg),
            k, mesh.ranks[r]) for k, r in enumerate(ranks)]
        root = ranks[0]
        # each partial sum to the root (after its work), added there in
        # rank order
        got = [mesh.fetch(r, root, p, xb.shape, torch.float32)
               for r, p in zip(ranks, parts)]
        acc = None
        if mesh.local(root):
            with mesh.on(root) as rank:
                acc = got[0].clone()
                for p in got[1:]:
                    acc += p.to(rank.device)
        for r in ranks:  # the sum back to every rank of the group
            v = (mesh.run(r, lambda: acc.clone()) if r == root
                 else mesh.move(root, r, acc, xb.shape, torch.float32))
            if r != root and acc is not None and acc.is_cuda and \
                    mesh.local(r):
                acc.record_stream(mesh.ranks[r].stream)
            out[r] = mesh.run(r, lambda v: v.reshape(shape).to(x.dtype), v)
    # the JAX package's all-reduce count: payload × participants, per group
    note_traffic("all-reduce", 4 * xb.numel(), len(mesh))
    mesh.join()
    return out

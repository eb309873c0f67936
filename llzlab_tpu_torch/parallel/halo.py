"""Halo exchange between time shards (port of
``llzlab_tpu/parallel/halo.py``).

Each time shard needs the last ``h`` samples of its left neighbour: the
FIR history, and the resampler's input history.  Here the exchange is a
plain copy from rank ``r − 1`` to rank ``r``, ordered by a stream event
(``DspMesh.move``; a ``torch.distributed`` send where the neighbour lives
in another process).  It is the route
``Channelizer.sharded_step(halo="ppermute")`` names, and the plain version
of kernel B3 (``kernels/halo_ring.py``).

The functions take and return one tensor per rank (None for a rank of
another process).  On a ``(channel, time)`` mesh each channel row is a
non-circular time ring of its own, as ``lax.ppermute`` over ``TIME_AXIS``
is inside the JAX body.  They order rank against rank; ordering against
the caller's own stream is the caller's (``DspMesh.fork`` before,
``DspMesh.join`` after).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from llzlab_tpu_torch.parallel.mesh import (DspMesh, local_block,
                                            note_traffic)

__all__ = ["left_halo", "right_halo", "broadcast_from_last",
           "axis_size_static", "row_values"]


def axis_size_static(mesh: DspMesh, axis_name: str) -> int:
    return mesh.shape[axis_name]


def _like(parts, h: int):
    """Shape and dtype of a width-``h`` slice of a block."""
    ref = local_block(parts)
    return tuple(ref.shape[:-1]) + (h,), ref.dtype


def _bytes(parts, h: int) -> int:
    ref = local_block(parts)
    rows = 1
    for d in ref.shape[:-1]:
        rows *= d
    return rows * h * ref.element_size()


def row_values(value: Optional[torch.Tensor], mesh: DspMesh
               ) -> List[Optional[torch.Tensor]]:
    """A ``(C, …)`` value (a carried stream state) split into the rows of
    each channel row of the mesh, each on the device of the row's first
    rank (None where that rank lives in another process, or for a None
    value).  A copy between cards runs on the stream of this process's
    first rank, where the value lives (``DspMesh.copy_to``): call it after
    ``mesh.fork``."""
    rows = mesh.rows()
    if value is None:
        return [None] * len(rows)
    if value.shape[0] % len(rows):
        raise ValueError(f"state of {value.shape[0]} channels on "
                         f"{len(rows)} channel rows")
    cl = value.shape[0] // len(rows)
    return [mesh.run(row[0], lambda c, rank: mesh.copy_to(
        mesh.home, value[c * cl:(c + 1) * cl], rank.device), c,
        mesh.ranks[row[0]]) for c, row in enumerate(rows)]


def _start(x: torch.Tensor, h: int, first: Optional[torch.Tensor]):
    """The first rank's halo: ``first`` (the carried history) or zeros."""
    halo = torch.zeros(x.shape[:-1] + (h,), dtype=x.dtype, device=x.device)
    if first is not None:
        halo.copy_(first)
    return halo


def left_halo(parts: Sequence[Optional[torch.Tensor]], h: int,
              mesh: DspMesh, *,
              first_shard_value: Union[None, torch.Tensor,
                                       Sequence[Optional[torch.Tensor]]]
              = None) -> List[Optional[torch.Tensor]]:
    """For each rank, the last ``h`` samples (last axis) of its left
    neighbour's tensor, on the rank's own device.

    The first rank of each row receives ``first_shard_value`` (the carried
    stream history: one tensor on a mesh of one row, or one per row as
    :func:`row_values` gives them) or zeros.  Non-circular: the last
    rank's tail goes nowhere.
    """
    rows = mesh.rows()
    if first_shard_value is None or isinstance(first_shard_value,
                                               torch.Tensor):
        if first_shard_value is not None and len(rows) != 1:
            raise ValueError("a mesh of several channel rows takes one "
                             "first_shard_value per row (row_values)")
        first_shard_value = [first_shard_value] * len(rows)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for row, first in zip(rows, first_shard_value):
        out[row[0]] = mesh.run(row[0], _start, parts[row[0]], h, first)
        for left, r in zip(row, row[1:]):
            tail = mesh.run(left, lambda x: x[..., x.shape[-1] - h:],
                            parts[left])
            out[r] = mesh.move(left, r, tail, *_like(parts, h))
    note_traffic("collective-permute", _bytes(parts, h),
                 sum(len(row) - 1 for row in rows))
    return out


def right_halo(parts: Sequence[Optional[torch.Tensor]], h: int,
               mesh: DspMesh) -> List[Optional[torch.Tensor]]:
    """For each rank, the first ``h`` samples (last axis) of its right
    neighbour's tensor; the last rank of each row receives zeros (the
    spectral chain's analysis lookahead, ``parallel/spectral_sp.py``)."""
    rows = mesh.rows()
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for row in rows:
        out[row[-1]] = mesh.run(row[-1], _start, parts[row[-1]], h, None)
        for r, right in zip(row, row[1:]):
            head = mesh.run(right, lambda x: x[..., :h], parts[right])
            out[r] = mesh.move(right, r, head, *_like(parts, h))
    note_traffic("collective-permute", _bytes(parts, h),
                 sum(len(row) - 1 for row in rows))
    return out


def broadcast_from_last(parts: Sequence[Optional[torch.Tensor]],
                        mesh: DspMesh) -> List[Optional[torch.Tensor]]:
    """The last rank's tensor of each row on every rank's device of the row
    (the global stream tail, surfaced as the replicated streaming
    state)."""
    rows = mesh.rows()
    width = local_block(parts).shape[-1]
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for row in rows:
        last = row[-1]
        for r in row:
            out[r] = mesh.move(last, r, parts[last], *_like(parts, width))
    note_traffic("collective-permute", _bytes(parts, width),
                 sum(len(row) - 1 for row in rows))
    return out

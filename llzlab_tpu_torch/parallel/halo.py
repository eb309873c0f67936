"""Halo exchange between time shards (port of
``llzlab_tpu/parallel/halo.py``).

Each time shard needs the last ``h`` samples of its left neighbour: the
FIR history, and the resampler's input history.  Here the exchange is a
plain copy from rank ``r − 1`` to rank ``r``, ordered by a stream event.
It is the route ``Channelizer.sharded_step(halo="ppermute")`` names, and
the plain version of kernel B3 (``kernels/halo_ring.py``).

The functions take and return one tensor per rank of a 1-D time mesh.
They order rank against rank; ordering against the caller's own stream is
the caller's (``DspMesh.fork`` before, ``DspMesh.join`` after).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from llzlab_tpu_torch.parallel.mesh import DspMesh

__all__ = ["left_halo", "broadcast_from_last"]


def left_halo(parts: Sequence[torch.Tensor], h: int, mesh: DspMesh, *,
              first_shard_value: Optional[torch.Tensor] = None
              ) -> List[torch.Tensor]:
    """For each rank, the last ``h`` samples (last axis) of its left
    neighbour's tensor, on the rank's own device.

    Rank 0 receives ``first_shard_value`` (the carried stream history) or
    zeros.  Non-circular: the last rank's tail goes nowhere.
    """
    out = []
    for r, part in enumerate(parts):
        if r:
            mesh.after(r, r - 1)
        with mesh.on(r) as rank:
            halo = torch.zeros(part.shape[:-1] + (h,), dtype=part.dtype,
                               device=rank.device)
            if r:
                left = parts[r - 1]
                halo.copy_(left[..., left.shape[-1] - h:])
            elif first_shard_value is not None:
                halo.copy_(first_shard_value)
            out.append(halo)
    return out


def broadcast_from_last(parts: Sequence[torch.Tensor], mesh: DspMesh
                        ) -> List[torch.Tensor]:
    """The last rank's tensor on every rank's device (the global stream
    tail, surfaced as the replicated streaming state)."""
    last = len(parts) - 1
    out = []
    for r in range(len(parts)):
        mesh.after(r, last)
        with mesh.on(r) as rank:
            out.append(torch.empty_like(parts[last], device=rank.device,
                                        memory_format=torch.contiguous_format)
                       .copy_(parts[last]))
    return out

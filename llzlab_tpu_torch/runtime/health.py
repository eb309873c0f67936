"""Failure detection: a light heartbeat over the mesh (port of
``llzlab_tpu/runtime/health.py``).

Meshes are static: there is no elastic recovery; the mechanism is detect
fast and restart from a checkpoint (``scripts/multihost_fir_demo_torch.py``
shows the whole kill / restart loop).  The heartbeat is the detection
half: one synchronous reduction over every rank of the mesh (and, on a
mesh that spans processes, an ``all_reduce`` over every process) every N
blocks.  A hung or dead peer turns it into a wait that surfaces as a
timeout in the caller rather than silent corruption; a NaN or Inf payload
surfaces numerical poisoning of any rank.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import torch

from llzlab_tpu_torch.parallel.mesh import DspMesh, note_traffic

__all__ = ["heartbeat", "Heartbeat"]


def _blocks(payload, mesh: DspMesh):
    """One block per rank: the payload's own list, or the flat payload
    split into equal runs (as the JAX package shards it over the mesh);
    zeros without one."""
    n = len(mesh)
    if payload is None:
        return mesh.map(lambda rank: torch.zeros(1, device=rank.device),
                        mesh.ranks)
    if isinstance(payload, (list, tuple)):
        if len(payload) != n:
            raise ValueError(f"{len(payload)} payload blocks for {n} ranks")
        return list(payload)
    flat = payload.reshape(-1)
    if flat.numel() % n:
        raise ValueError(f"payload of {flat.numel()} values does not split "
                         f"over {n} ranks")
    step = flat.numel() // n
    return mesh.map(lambda r, rank: flat[r * step:(r + 1) * step].to(
        rank.device), range(n), mesh.ranks)


def heartbeat(mesh: DspMesh,
              payload: Union[None, torch.Tensor,
                             Sequence[Optional[torch.Tensor]]] = None
              ) -> dict:
    """One synchronous heartbeat over every rank of the mesh.

    Returns ``{"ok": bool, "rtt_s": float, "devices": int}``.
    ``payload`` (a tensor split over the ranks, or one block per rank) is
    checked for finiteness through the same reduction, so a rank that
    produced NaN or Inf is reported.
    """
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh.fork()
    blocks = _blocks(payload, mesh)
    sums = mesh.map(lambda v: v.to(torch.float64).sum(), blocks)
    mesh.join()
    dev = mesh.ranks[mesh.home].device
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for s in sums:  # rank order, this process's ranks
        if s is not None:
            total += s.to(dev)
    if mesh.spans_processes:
        dist.all_reduce(total)
    note_traffic("all-reduce", 8, len(mesh))
    ok = bool(torch.isfinite(total).item())
    return {"ok": ok, "rtt_s": time.perf_counter() - t0,
            "devices": len(mesh)}


class Heartbeat:
    """Every-N-blocks heartbeat helper for streaming loops."""

    def __init__(self, mesh: DspMesh, every: int = 16):
        self.mesh = mesh
        self.every = max(int(every), 1)
        self._count = 0
        self.last: Optional[dict] = None

    def tick(self, payload=None) -> Optional[dict]:
        self._count += 1
        if self._count % self.every:
            return None
        self.last = heartbeat(self.mesh, payload)
        if not self.last["ok"]:
            raise FloatingPointError(
                "heartbeat detected non-finite values on some shard"
            )
        return self.last

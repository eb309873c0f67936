"""Stage pipelining: chain stages on their own ranks (port of
``llzlab_tpu/parallel/stage_pp.py``).

GPipe-style schedule over a 1-D ``stage`` mesh: micro-blocks of the stream
flow through S stages; at step ``t`` rank ``s`` runs stage ``s`` on
micro-block ``t − s`` on its own stream and hands its output to rank
``s + 1`` with a copy ordered by a stream event; the last rank writes the
output.  Micro-batch = time block, bubble = S − 1 steps.  On one card the
stages of different micro-blocks may so run at once on their ranks'
streams.

Constraint: stages must be shape-preserving ``(B, L) → (B, L)`` maps and
stateless across blocks (cascaded filter or gain stages, each block on its
own).  Rate-changing stages belong in the time-sharded layout with the a2a
reshard (``parallel/reshard.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from llzlab_tpu_torch.parallel.mesh import DspMesh, deal_devices, note_traffic
from llzlab_tpu_torch.runtime.platform import require_cuda

__all__ = ["stage_pipeline", "make_stage_mesh", "STAGE_AXIS"]

STAGE_AXIS = "stage"


def make_stage_mesh(n_stages: int, devices=None) -> DspMesh:
    """A 1-D ``stage`` mesh of ``n_stages`` ranks: on ``devices`` (a
    prefix), else on the visible CUDA cards, dealt out by
    ``parallel.mesh.deal_devices`` (every rank on ``cuda:0`` with one
    card); raises without a card."""
    if devices is None:
        require_cuda()
        devices = deal_devices(n_stages, torch.cuda.device_count())
    devs = list(devices)
    if len(devs) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devs)}")
    return DspMesh(devs[:n_stages], (STAGE_AXIS,))


def stage_pipeline(
    stage_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    mesh: DspMesh,
    x: torch.Tensor,
    *,
    micro_block: int,
) -> torch.Tensor:
    """Run ``stage_fns[0]``, then ``stage_fns[1]``, … pipelined over the
    mesh; returns ``(B, T)`` on the last rank's device.

    ``x (B, T)`` with ``T % micro_block == 0``.  Each stage function must
    be shape-preserving on ``(B, micro_block)`` blocks and stateless
    across blocks.  The output equals the serial blockwise composition
    bit for bit (the same calls on the same blocks; the hand-offs are
    copies).
    """
    s_count = len(stage_fns)
    if mesh.axis_names != (STAGE_AXIS,) or len(mesh) != s_count:
        raise ValueError("mesh stage axis must equal number of stages")
    b, t = x.shape
    if t % micro_block:
        raise ValueError(f"T={t} not a multiple of micro_block={micro_block}")
    n_micro = t // micro_block
    last = mesh.ranks[s_count - 1]
    out = torch.empty((b, t), dtype=x.dtype, device=last.device)
    mesh.fork()
    held = [None] * s_count  # held[s]: the block rank s takes next
    for step in range(n_micro + s_count - 1):
        # last stage first, so that a hand-off never lands on a block its
        # rank has still to take at this step
        for s in range(s_count - 1, -1, -1):
            m = step - s
            if not 0 <= m < n_micro:
                continue
            with mesh.on(s) as rank:
                if s == 0:
                    blk = x[:, m * micro_block:(m + 1) * micro_block].to(
                        rank.device)
                else:
                    blk = held[s]
                y = stage_fns[s](blk)
                if s == s_count - 1:
                    out[:, m * micro_block:(m + 1) * micro_block].copy_(y)
                    continue
            held[s + 1] = mesh.move(s, s + 1, y, y.shape, y.dtype)
            if y.is_cuda:  # y is freed before the pipeline joins
                y.record_stream(mesh.ranks[s + 1].stream)
    note_traffic("collective-permute", x.element_size() * b * micro_block,
                 n_micro * (s_count - 1))
    mesh.join()
    return out

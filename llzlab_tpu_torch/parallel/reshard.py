"""All-to-all reshard between time-major and channel-major layouts (port
of ``llzlab_tpu/parallel/reshard.py``).

The Ulysses analog: the FIR and resample stages want full channels ×
sharded time (halo locality), while a frame transform that straddles
shard boundaries wants full time × sharded channels.  The reshard swaps
the sharded dimension with one all-to-all over each channel row: every
rank ends up with the full time range for a subset of its row's channels.

The JAX package lets XLA emit the all-to-all (``with_sharding_constraint``)
or calls ``lax.all_to_all`` inside ``shard_map``.  Here it is ``n_time``
slice copies into each rank, ordered by stream events (copies on the
card between ranks of one card; ``torch.distributed`` sends where a rank
lives in another process).  The functions take and return one tensor per
rank.  The layouts are the JAX package's specs, by name
(``parallel.mesh.TIME_MAJOR`` = ``P(channel, time)``,
``parallel.mesh.CHANNEL_MAJOR`` = ``P((channel, time), None)``); a round
trip is the identity, bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from llzlab_tpu_torch.parallel.mesh import (CHANNEL_MAJOR, TIME_MAJOR,
                                            DspMesh, local_block,
                                            note_traffic)

__all__ = ["reshard", "to_channel_major", "to_time_major",
           "all_to_all_shard_map"]


def _shapes(parts, mesh: DspMesh, to_channel: bool):
    ref = local_block(parts)
    if ref.dim() < 2:
        raise ValueError(f"blocks must be (C, ..., T), got {tuple(ref.shape)}")
    nt = mesh.n_time
    c, t = ref.shape[0], ref.shape[-1]
    if to_channel:
        if c % nt:
            raise ValueError(f"C_loc={c} not divisible by n_time={nt}")
        return c // nt, t, t * nt
    if t % nt:
        raise ValueError(f"T={t} not divisible by n_time={nt}")
    return c, t // nt, t


def _check(parts, mesh: DspMesh):
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} blocks for {len(mesh)} ranks")
    if len({tuple(p.shape) for p in parts if p is not None}) > 1:
        raise ValueError("blocks must be equal-shaped")


def _all_to_all(parts: Sequence[Optional[torch.Tensor]], mesh: DspMesh,
                to_channel: bool) -> List[Optional[torch.Tensor]]:
    """Rank ``(c, t)`` takes slice ``t`` of every rank of its row: channel
    slice ``t`` of their time blocks joined along time (to channel-major),
    or time slice ``t`` of their channel blocks joined along the channels
    (to time-major)."""
    _check(parts, mesh)
    cs, ts, _ = _shapes(parts, mesh, to_channel)
    ref = local_block(parts)
    shape = (cs,) + tuple(ref.shape[1:-1]) + (ts,)

    def piece(v, i):
        # to channel-major: dst's channels of src's time block; to
        # time-major: dst's time block of src's channels
        return v[i * cs:(i + 1) * cs] if to_channel else \
            v[..., i * ts:(i + 1) * ts]

    def join(rank, row, *pieces):
        return torch.cat([mesh.copy_to(src, p, rank.device)
                          for src, p in zip(row, pieces)],
                         dim=-1 if to_channel else 0)

    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for row in mesh.rows():
        for i, dst in enumerate(row):
            pieces = [mesh.fetch(src, dst,
                                 mesh.run(src, piece, parts[src], i),
                                 shape, ref.dtype) for src in row]
            out[dst] = mesh.run(dst, join, mesh.ranks[dst], row, *pieces)
    # the JAX package's count: per-device payload × participants, over
    # the groups (one group per channel row)
    note_traffic("all-to-all", ref.numel() * ref.element_size(), len(parts))
    return out


def reshard(parts: Sequence[Optional[torch.Tensor]], mesh: DspMesh, spec
            ) -> List[Optional[torch.Tensor]]:
    """Move blocks held in one of the two layouts into the other,
    ``spec``: :data:`~llzlab_tpu_torch.parallel.mesh.CHANNEL_MAJOR` takes
    time-major blocks, :data:`~llzlab_tpu_torch.parallel.mesh.TIME_MAJOR`
    channel-major ones.  Any other spec raises."""
    if spec == CHANNEL_MAJOR:
        return _all_to_all(parts, mesh, True)
    if spec == TIME_MAJOR:
        return _all_to_all(parts, mesh, False)
    raise ValueError(f"reshard moves between {TIME_MAJOR} (time-major) and "
                     f"{CHANNEL_MAJOR} (channel-major), got {spec!r}")


def to_channel_major(parts, mesh: DspMesh):
    """``(C_loc, T_loc)`` blocks of ``P(channel, time)`` → ``(C_loc /
    n_time, T)`` blocks of ``P((channel, time), None)``: every rank holds
    full time for a channel subset."""
    return reshard(parts, mesh, CHANNEL_MAJOR)


def to_time_major(parts, mesh: DspMesh):
    """Inverse of :func:`to_channel_major`."""
    return reshard(parts, mesh, TIME_MAJOR)


def all_to_all_shard_map(parts, mesh: DspMesh):
    """Time-sharded → channel-sharded over the ``time`` axis, the JAX
    package's explicit ``lax.all_to_all`` form: the local view goes from
    ``(C_loc, T_loc)`` to ``(C_loc / n_time, T)``; requires ``C_loc %
    n_time == 0``.  The same copies as :func:`to_channel_major`."""
    return reshard(parts, mesh, CHANNEL_MAJOR)

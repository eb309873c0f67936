"""DSP device mesh: named axes ('channel', 'time') (port of
``llzlab_tpu/parallel/mesh.py``).

A mesh is an array of ranks.  A rank is a ``torch.device`` plus, on CUDA,
a stream of its own.  One process drives every rank, as one controller
drives ``shard_map`` in the JAX package: sharded code loops over the ranks
and runs each rank's share under :meth:`DspMesh.on`.  Ranks may share a
card (every rank on ``cuda:0`` is the default on a machine with one card)
or sit on several; work of different ranks is ordered by stream events
(:meth:`DspMesh.after`), never by the host.

``DspMesh(devices, axis_names)`` mirrors ``jax.sharding.Mesh``;
``DspMesh(["cpu"] * 4, (TIME_AXIS,))`` is the 1-D time mesh the tests run.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from llzlab_tpu_torch.runtime.platform import require_cuda

__all__ = [
    "CHANNEL_AXIS",
    "TIME_AXIS",
    "Rank",
    "DspMesh",
    "make_dsp_mesh",
    "shard_time",
    "gather_time",
]

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


class Rank:
    """One mesh position: its device and, on CUDA, its stream and one
    event that :meth:`mark` records anew each time (creating an event per
    call costs the host more than recording one)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        on_cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if on_cuda else None
        self._event = torch.cuda.Event() if on_cuda else None

    def mark(self):
        """The rank's event, recorded behind what its stream has been
        given so far.  Wait for it at once: the next ``mark`` moves it
        (a wait already queued keeps the point it was given)."""
        self._event.record(self.stream)
        return self._event


class DspMesh:
    """Ranks laid out over named axes.

    ``devices``: as many device specs as the mesh has positions, in
    row-major order of ``shape`` (default: one axis holding them all).
    ``cache`` holds per-mesh state of the code that runs on the mesh (the
    halo kernels' receive buffers and flags).
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        dims = tuple(shape) if shape is not None else (len(devices),)
        if len(dims) != len(self.axis_names):
            raise ValueError(f"{len(dims)}-D mesh needs {len(dims)} axis "
                             f"names, got {self.axis_names}")
        if int(np.prod(dims)) != len(devices):
            raise ValueError(f"mesh {dims} needs {int(np.prod(dims))} "
                             f"devices, got {len(devices)}")
        self.ranks: List[Rank] = [Rank(d) for d in devices]
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))
        self.cache: dict = {}
        # per CUDA device: its ranks, and the event fork() records
        self._cards: Dict[torch.device, List[Rank]] = {}
        for rank in self.ranks:
            if rank.stream is not None:
                self._cards.setdefault(rank.device, []).append(rank)
        self._fork_events = {dev: torch.cuda.Event() for dev in self._cards}

    def __len__(self) -> int:
        return len(self.ranks)

    @property
    def is_cuda(self) -> bool:
        kinds = {r.device.type for r in self.ranks}
        if len(kinds) != 1:
            raise ValueError(f"mesh mixes device types {sorted(kinds)}")
        return kinds == {"cuda"}

    @contextlib.contextmanager
    def on(self, r: int):
        """Run the enclosed work as rank ``r``: on its device and stream."""
        rank = self.ranks[r]
        if rank.stream is None:
            yield rank
            return
        with torch.cuda.device(rank.device), torch.cuda.stream(rank.stream):
            yield rank

    def after(self, r: int, *others: int) -> None:
        """Order rank ``r``'s later work after what ranks ``others`` have
        been given so far (a stream event each; nothing on a CPU mesh)."""
        rank = self.ranks[r]
        if rank.stream is None:
            return
        for o in others:
            if o != r:
                rank.stream.wait_event(self.ranks[o].mark())

    def fork(self) -> None:
        """Order every rank's later work after the caller's current
        stream on that rank's device."""
        for dev, ranks in self._cards.items():
            event = self._fork_events[dev]
            event.record(torch.cuda.current_stream(dev))
            for rank in ranks:
                rank.stream.wait_event(event)

    def join(self) -> None:
        """Order the caller's current stream (on each rank's device) after
        what every rank has been given so far."""
        for dev, ranks in self._cards.items():
            current = torch.cuda.current_stream(dev)
            for rank in ranks:
                current.wait_event(rank.mark())

    def synchronize(self) -> None:
        """Block the host until every rank's stream has drained."""
        for rank in self.ranks:
            if rank.stream is not None:
                rank.stream.synchronize()


def _largest_pow2_factor(n: int) -> int:
    f = 1
    while n % (2 * f) == 0:
        f *= 2
    return f


def make_dsp_mesh(
    n_channel: Optional[int] = None,
    n_time: Optional[int] = None,
    *,
    devices: Optional[Sequence] = None,
) -> DspMesh:
    """Build a ``(channel, time)`` mesh of ``n_channel · n_time`` ranks.

    ``devices``: one device spec per rank; an explicit smaller shape uses a
    prefix.  Default: the visible CUDA cards, the ranks dealt out in
    equal contiguous runs, so that time neighbours share a card where
    they can (every rank on ``cuda:0`` with one card); raises without a
    card.  With only a device list, the split favours the time axis, as
    in the JAX package.
    """
    if devices is None:
        require_cuda()
        if n_channel is None or n_time is None:
            raise ValueError("without a device list, give both n_channel "
                             "and n_time")
        count = torch.cuda.device_count()
        n = n_channel * n_time
        devices = [torch.device("cuda", i * count // n) for i in range(n)]
    devs = list(devices)
    n = len(devs)
    if n_channel is None and n_time is None:
        n_time = _largest_pow2_factor(n)
        n_channel = n // n_time
    elif n_channel is None:
        n_channel = n // n_time
    elif n_time is None:
        n_time = n // n_channel
    if n_channel * n_time > n:
        raise ValueError(
            f"mesh {n_channel}x{n_time} needs more than {n} devices")
    return DspMesh(devs[: n_channel * n_time], (CHANNEL_AXIS, TIME_AXIS),
                   (n_channel, n_time))


def shard_time(x: torch.Tensor, mesh: DspMesh) -> List[torch.Tensor]:
    """Split ``(C, T)`` into one contiguous ``(C, T / n_time)`` shard per
    rank of a 1-D time mesh, each on its rank's device."""
    if mesh.axis_names != (TIME_AXIS,):
        raise ValueError(f"shard_time needs a 1-D ({TIME_AXIS!r},) mesh, got "
                         f"{mesh.axis_names}")
    n = len(mesh)
    t = x.shape[-1]
    if t % n:
        raise ValueError(f"T={t} not divisible by n_time={n}")
    t_loc = t // n
    mesh.fork()
    parts = []
    for r in range(n):
        with mesh.on(r) as rank:
            parts.append(x[..., r * t_loc:(r + 1) * t_loc]
                         .to(rank.device).contiguous())
    mesh.join()
    return parts


def gather_time(parts: Sequence[torch.Tensor], mesh: DspMesh,
                dim: int = -1) -> torch.Tensor:
    """Concatenate per-rank shards along ``dim`` on rank 0's device (the
    inverse of :func:`shard_time`; ``dim=1`` joins spectral frames)."""
    dev = mesh.ranks[0].device
    mesh.join()
    return torch.cat([p.to(dev) for p in parts], dim=dim)

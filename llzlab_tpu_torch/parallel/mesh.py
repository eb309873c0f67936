"""DSP device mesh: named axes ('channel', 'time') (port of
``llzlab_tpu/parallel/mesh.py``).

A mesh is an array of ranks.  A rank is a ``torch.device`` plus, on CUDA,
a stream of its own.  One process drives every rank it holds, as one
controller drives ``shard_map`` in the JAX package: sharded code loops over
the ranks and runs each rank's share under :meth:`DspMesh.on`.  Ranks may
share a card (every rank on ``cuda:0`` is the default on a machine with
one card) or sit on several (:func:`deal_devices` deals them out, one
rank a card where there are enough); work of different ranks is ordered
by stream events (:meth:`DspMesh.after`), never by the host.  A copy
between two cards (:meth:`DspMesh.copy_to`) runs on the source rank's
stream, fenced by events on both sides, and the receiving rank's stream
waits for it: PyTorch runs such a copy on the source card's current
stream, and there it would queue behind the source rank's kernels for the
card's SMs.

``DspMesh(devices, axis_names)`` mirrors ``jax.sharding.Mesh``;
``DspMesh(["cpu"] * 4, (TIME_AXIS,))`` is the 1-D time mesh the tests run,
``make_dsp_mesh(2, 2, devices=["cpu"] * 4)`` a ``(channel, time)`` mesh.

Layouts.  A ``(C, T)`` signal block is held as one tensor per rank, in one
of two layouts named as the JAX package names its ``PartitionSpec``:

* :data:`TIME_MAJOR` (``channel_time_spec()``, ``P(channel, time)``):
  rank ``(c, t)`` holds ``(C / n_channel, T / n_time)``, channel block
  ``c`` and time block ``t`` (:func:`shard`, :func:`gather`);
* :data:`CHANNEL_MAJOR` (``P((channel, time), None)``): rank ``i`` of the
  row-major order holds channels ``i·C/n … (i+1)·C/n − 1`` over the whole
  time range (``parallel/reshard.py`` moves between the two).

Each channel row of a ``(channel, time)`` mesh is a non-circular time ring
of its own (:meth:`DspMesh.rows`, :meth:`DspMesh.row`), as
``lax.ppermute`` over ``TIME_AXIS`` is inside a JAX body: the halo
exchange runs per row.

Ranks of other processes.  A mesh built by
``runtime.distributed.global_dsp_mesh`` also holds ranks that live in
another process (``Rank.remote``): they have no stream, and their tensors
are ``None`` in a list of parts.  The mesh keeps that out of the ops:
:meth:`DspMesh.map` and :meth:`DspMesh.run` run work on this process's
ranks only, and the exchange points (:meth:`DspMesh.move` and
:meth:`DspMesh.fetch`, used by ``parallel/halo.py``,
``parallel/reshard.py``, the IIR carry of ``parallel/sharded_ops.py``, and
``runtime/health.py``) reach the other ranks through ``torch.distributed``
point-to-point sends.  Every process walks the same exchanges in the same
order, so the sends and receives pair up.

Traffic.  Each exchange between ranks notes its bytes
(:func:`note_traffic`), in the JAX package's kinds: always into the running
totals of ``runtime.profiler.counters``, and inside :func:`record_traffic`
(``utils.profiling.collective_traffic``) as notes of their own.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from llzlab_tpu_torch.runtime.platform import require_cuda
from llzlab_tpu_torch.runtime.profiler import count_traffic

__all__ = [
    "CHANNEL_AXIS",
    "TIME_AXIS",
    "TIME_MAJOR",
    "CHANNEL_MAJOR",
    "Rank",
    "DspMesh",
    "make_dsp_mesh",
    "deal_devices",
    "channel_time_spec",
    "local_block",
    "shard",
    "gather",
    "shard_time",
    "gather_time",
    "note_traffic",
    "record_traffic",
]

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"
#: ``P(channel, time)``: rank (c, t) holds channel block c, time block t
TIME_MAJOR = (CHANNEL_AXIS, TIME_AXIS)
#: ``P((channel, time), None)``: rank i holds channel block i, all of time
CHANNEL_MAJOR = ((CHANNEL_AXIS, TIME_AXIS), None)

#: the notes of the innermost :func:`record_traffic`, per thread and task
_TRAFFIC: contextvars.ContextVar = contextvars.ContextVar(
    "llz_traffic", default=None)


def note_traffic(op: str, bytes_per_device: int, sends: int) -> None:
    """Note one exchange: ``sends`` transfers of ``bytes_per_device`` each
    (a ``collective-permute`` counts its pairs; the other kinds their
    participants, summed over the groups, as the JAX package's
    ``collective_traffic`` counts them)."""
    if sends <= 0:
        return
    nbytes = int(bytes_per_device * sends)
    count_traffic(op, nbytes)
    notes = _TRAFFIC.get()
    if notes is not None:
        notes.append({"op": op, "bytes": nbytes,
                      "bytes_per_device": int(bytes_per_device)})


@contextlib.contextmanager
def record_traffic():
    """Keep the notes of the enclosed exchanges; yields their list (an
    enclosing recorder gets them too)."""
    outer = _TRAFFIC.get()
    notes: list = []
    token = _TRAFFIC.set(notes)
    try:
        yield notes
    finally:
        _TRAFFIC.reset(token)
        if outer is not None:
            outer.extend(notes)


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class Rank:
    """One mesh position: its device and, on CUDA, its stream and one
    event that :meth:`mark` records anew each time (creating an event per
    call costs the host more than recording one).

    ``process``: the process that holds the rank (None: this one).  A rank
    of another process is ``remote``: it has no stream, and this process
    never runs its work."""

    def __init__(self, device, process: Optional[int] = None):
        self.device = torch.device(device)
        self.process = process
        self.remote = process is not None and process != _process_index()
        on_cuda = self.device.type == "cuda" and not self.remote
        if on_cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
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
    row-major order of ``shape`` (default: one axis holding them all); a
    :class:`Rank` is taken as it is (a view shares its parent's ranks).
    ``processes``: the process of each position, for a mesh that spans
    processes (``runtime.distributed.global_dsp_mesh``).  ``cache`` holds
    per-mesh state of the code that runs on the mesh (the halo kernels'
    receive buffers and flags, the sharded ops' plans).
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None,
                 processes: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        dims = tuple(shape) if shape is not None else (len(devices),)
        if len(dims) != len(self.axis_names):
            raise ValueError(f"{len(dims)}-D mesh needs {len(dims)} axis "
                             f"names, got {self.axis_names}")
        if int(np.prod(dims)) != len(devices):
            raise ValueError(f"mesh {dims} needs {int(np.prod(dims))} "
                             f"devices, got {len(devices)}")
        if processes is not None and len(processes) != len(devices):
            raise ValueError(f"{len(processes)} processes for "
                             f"{len(devices)} ranks")
        self.ranks: List[Rank] = [
            d if isinstance(d, Rank) else
            Rank(d, None if processes is None else processes[i])
            for i, d in enumerate(devices)]
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))
        self.cache: dict = {}
        self._views: Dict[int, "DspMesh"] = {}
        # per local CUDA device: its ranks, and the event fork() records
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

    @property
    def is_distributed(self) -> bool:
        """Whether some rank lives in another process."""
        return any(rank.remote for rank in self.ranks)

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh was dealt over a process group
        (``runtime.distributed.global_dsp_mesh``), a group of one too."""
        return any(rank.process is not None for rank in self.ranks)

    @property
    def n_channel(self) -> int:
        return self.shape.get(CHANNEL_AXIS, 1)

    @property
    def n_time(self) -> int:
        return self.shape.get(TIME_AXIS, 1)

    def local(self, r: int) -> bool:
        return not self.ranks[r].remote

    @property
    def home(self) -> int:
        """This process's first rank (where a value of the whole mesh,
        such as a streaming state, lives)."""
        return next(r for r in range(len(self)) if self.local(r))

    def run(self, r: int, fn, *args):
        """``fn(*args)`` as rank ``r`` (under :meth:`on`); None, without a
        call, where ``r`` lives in another process."""
        if self.ranks[r].remote:
            return None
        with self.on(r):
            return fn(*args)

    def map(self, fn, *lists) -> list:
        """``fn`` on every rank of this process, each under :meth:`on`,
        with the rank's entry of each list (one entry per rank); None for
        the ranks of other processes."""
        return [self.run(r, fn, *(v[r] for v in lists))
                for r in range(len(self))]

    def coords(self, r: int) -> tuple:
        """Rank ``r``'s coordinates, one per axis (``(c, t)`` on a
        ``(channel, time)`` mesh)."""
        return tuple(int(v) for v in np.unravel_index(
            r, tuple(self.shape[a] for a in self.axis_names)))

    def rows(self) -> List[List[int]]:
        """The ranks of each channel row, in time order: the time rings
        (one row holding every rank on a mesh without a channel axis)."""
        if CHANNEL_AXIS not in self.axis_names:
            return [list(range(len(self)))]
        nt = self.n_time
        return [list(range(c * nt, (c + 1) * nt))
                for c in range(self.n_channel)]

    def row(self, c: int) -> "DspMesh":
        """Channel row ``c`` as a 1-D ``(time,)`` mesh sharing this mesh's
        ranks (and streams); made once, so its cache persists."""
        if c not in self._views:
            idx = self.rows()[c]
            if len(idx) == len(self) and self.axis_names == (TIME_AXIS,):
                return self
            view = DspMesh([self.ranks[r] for r in idx], (TIME_AXIS,))
            self._views[c] = view
        return self._views[c]

    @contextlib.contextmanager
    def on(self, r: int):
        """Run the enclosed work as rank ``r``: on its device and stream."""
        rank = self.ranks[r]
        if rank.remote:
            raise ValueError(f"rank {r} lives in process {rank.process}")
        if rank.stream is None:
            yield rank
            return
        with torch.cuda.device(rank.device), torch.cuda.stream(rank.stream):
            yield rank

    def after(self, r: int, *others: int) -> None:
        """Order rank ``r``'s later work after what ranks ``others`` have
        been given so far (a stream event each; nothing on a CPU mesh or
        for ranks of other processes)."""
        rank = self.ranks[r]
        if rank.stream is None:
            return
        for o in others:
            if o != r and self.ranks[o].stream is not None:
                rank.stream.wait_event(self.ranks[o].mark())

    def fork(self) -> None:
        """Order every rank's later work after what the caller's current
        stream of every card the mesh touches has been given so far (a
        rank of card ``b`` may read what the caller wrote on card
        ``a``)."""
        events = []
        for dev in self._cards:
            event = self._fork_events[dev]
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
        for ranks in self._cards.values():
            for rank in ranks:
                for event in events:
                    rank.stream.wait_event(event)

    def join(self) -> None:
        """Order the caller's current stream of every card the mesh
        touches after what every rank, of every card, has been given so
        far."""
        marks = [rank.mark() for ranks in self._cards.values()
                 for rank in ranks]
        for dev in self._cards:
            current = torch.cuda.current_stream(dev)
            for event in marks:
                current.wait_event(event)

    def synchronize(self) -> None:
        """Block the host until every rank's stream, and the caller's
        current stream of every card the mesh touches, has drained."""
        for rank in self.ranks:
            if rank.stream is not None:
                rank.stream.synchronize()
        for dev in self._cards:
            torch.cuda.current_stream(dev).synchronize()

    @property
    def homes(self) -> List[int]:
        """Each process's first rank, in process order: where that
        process keeps a value of the whole mesh (``[0]`` on a mesh of one
        process)."""
        firsts: Dict[Optional[int], int] = {}
        for r, rank in enumerate(self.ranks):
            firsts.setdefault(rank.process, r)
        return [firsts[p] for p in sorted(firsts, key=lambda p: p or 0)]

    def fetch(self, src: int, dst: int, value: Optional[torch.Tensor],
              shape, dtype) -> Optional[torch.Tensor]:
        """Rank ``src``'s ``value`` (``shape``, ``dtype``) for reading on
        rank ``dst``, ordered after ``src``'s work: between ranks of this
        process the tensor itself (its memory kept from reuse until
        ``dst``'s stream is done with it), a tensor received on ``dst``'s
        device where ``src`` lives in another process.  A ``dst`` of
        another process is sent ``value`` and gets None here.  The
        send and the receive run on the rank's stream, so NCCL orders them
        there; gloo waits on the host."""
        s_rank, d_rank = self.ranks[src], self.ranks[dst]
        if s_rank.remote and d_rank.remote:
            return None
        import torch.distributed as dist

        if d_rank.remote:
            with self.on(src):
                dist.send(value.contiguous(), d_rank.process)
            return None
        self.after(dst, src)
        if s_rank.remote:
            with self.on(dst) as rank:
                out = torch.empty(tuple(shape), dtype=dtype,
                                  device=rank.device)
                dist.recv(out, s_rank.process)
            return out
        if value.is_cuda and src != dst and d_rank.stream is not None:
            value.record_stream(d_rank.stream)
        return value

    def copy_to(self, src: int, value: torch.Tensor, device) -> torch.Tensor:
        """Rank ``src``'s ``value`` on ``device``: itself where it lies
        there, else a copy that runs on ``src``'s stream (call it under
        :meth:`on` of the receiving rank, whose stream then waits for the
        copy).  PyTorch copies between cards on the source card's current
        stream, fenced by events against the destination card's current
        stream; on the caller's stream of the source card, a copy queued
        while the source rank's kernel fills the card would wait for SMs
        until that kernel ends, and the receiving rank with it (the
        ranks' steps on several cards then run one after the other)."""
        device = torch.device(device)
        rank = self.ranks[src]
        if value.device == device or rank.stream is None or \
                value.device != rank.device:
            return value.to(device)
        with torch.cuda.stream(rank.stream):
            return value.to(device)

    def move(self, src: int, dst: int, value: Optional[torch.Tensor],
             shape, dtype) -> Optional[torch.Tensor]:
        """Rank ``src``'s ``value`` as a new tensor on rank ``dst``'s
        device: :meth:`fetch` where a rank lives in another process, else
        a copy on ``dst``'s stream (on ``src``'s between cards,
        :meth:`copy_to`), ordered after ``src``'s work.  The
        copy reads ``value`` later than the call returns: its memory must
        not go back to ``src``'s stream before ``dst``'s work is joined
        (a step's ``fork`` / ``join`` keeps it; a caller that frees it
        sooner records ``dst``'s stream on it).  Not recorded here: a
        large block freed behind another stream's queue waits for that
        queue before its memory is used again."""
        if self.ranks[src].remote or self.ranks[dst].remote:
            return self.fetch(src, dst, value, shape, dtype)
        self.after(dst, src)
        with self.on(dst) as rank:
            if value.device != rank.device:
                return self.copy_to(src, value.to(dtype), rank.device)
            return torch.empty(tuple(shape), dtype=dtype,
                               device=rank.device).copy_(value)


def _largest_pow2_factor(n: int) -> int:
    f = 1
    while n % (2 * f) == 0:
        f *= 2
    return f


def deal_devices(n: int, count: int) -> List[torch.device]:
    """``n`` ranks dealt onto ``count`` CUDA cards: rank ``i`` on card
    ``i · min(n, count) // n``.  One rank a card where there are enough
    cards (the first ``n``), else equal runs of consecutive ranks, so that
    time neighbours share a card where they can and the ranks of a card
    are consecutive, as the halo kernels need (``kernels.halo_ring
    .ranks_by_card``).  The one way the port deals ranks onto cards."""
    if n < 1 or count < 1:
        raise ValueError(f"cannot deal {n} ranks onto {count} cards")
    used = min(n, count)
    return [torch.device("cuda", i * used // n) for i in range(n)]


def make_dsp_mesh(
    n_channel: Optional[int] = None,
    n_time: Optional[int] = None,
    *,
    devices: Optional[Sequence] = None,
) -> DspMesh:
    """Build a ``(channel, time)`` mesh of ``n_channel · n_time`` ranks.

    ``devices``: one device spec per rank; an explicit smaller shape uses a
    prefix.  Default: the visible CUDA cards, the ranks dealt out by
    :func:`deal_devices` (one a card where there are enough, every rank
    on ``cuda:0`` with one card); raises without a card.  With only a
    device list, the split favours the time axis, as in the JAX package.
    """
    if devices is None:
        require_cuda()
        if n_channel is None or n_time is None:
            raise ValueError("without a device list, give both n_channel "
                             "and n_time")
        devices = deal_devices(n_channel * n_time,
                               torch.cuda.device_count())
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


def channel_time_spec():
    """The layout of a ``(channels, time)`` signal block on the mesh:
    :data:`TIME_MAJOR`, what :func:`shard` makes."""
    return TIME_MAJOR


def _row_major(mesh: DspMesh, c: int, t: int, spec):
    """Per rank, the ``(channel, time)`` slices of a ``(c, t)`` signal in
    layout ``spec``."""
    n = len(mesh)
    if spec == TIME_MAJOR:
        nc, nt = mesh.n_channel, mesh.n_time
        if c % nc:
            raise ValueError(f"C={c} not divisible by n_channel={nc}")
        if t % nt:
            raise ValueError(f"T={t} not divisible by n_time={nt}")
        cl, tl = c // nc, t // nt
        return [(slice((r // nt) * cl, (r // nt + 1) * cl),
                 slice((r % nt) * tl, (r % nt + 1) * tl)) for r in range(n)]
    if spec == CHANNEL_MAJOR:
        if c % n:
            raise ValueError(f"C={c} not divisible by the rank count {n}")
        cl = c // n
        return [(slice(r * cl, (r + 1) * cl), slice(0, t)) for r in range(n)]
    raise ValueError(f"unknown layout {spec!r}; one of {TIME_MAJOR} "
                     f"(time-major) or {CHANNEL_MAJOR} (channel-major)")


def local_block(parts: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """One block of this process (the blocks of a list are equal-shaped;
    those of other processes' ranks are None here)."""
    return next(p for p in parts if p is not None)


def shard(x: torch.Tensor, mesh: DspMesh, spec=TIME_MAJOR
          ) -> List[Optional[torch.Tensor]]:
    """Split ``(C, T)`` into one contiguous block per rank, each on its
    rank's device, in layout ``spec`` (:data:`TIME_MAJOR`: ``(C /
    n_channel, T / n_time)`` on rank ``(c, t)`` in row-major order;
    :data:`CHANNEL_MAJOR`: ``(C / n, T)``).  A rank of another process
    gets None."""
    slices = _row_major(mesh, x.shape[0], x.shape[-1], spec)
    mesh.fork()
    parts = mesh.map(lambda sl, rank: x[sl].to(rank.device).contiguous(),
                     slices, mesh.ranks)
    mesh.join()
    return parts


def gather(parts: Sequence[torch.Tensor], mesh: DspMesh, dim: int = -1,
           spec=TIME_MAJOR) -> torch.Tensor:
    """The inverse of :func:`shard`, on rank 0's device: per channel row
    the blocks joined along ``dim`` (``dim=1`` joins spectral frames),
    then the rows along the channels; channel-major blocks joined along
    the channels."""
    if any(p is None for p in parts):
        raise ValueError("gather needs every rank's block in this process")
    dev = mesh.ranks[0].device
    mesh.join()
    if spec == CHANNEL_MAJOR:
        return torch.cat([p.to(dev) for p in parts], dim=0)
    if spec != TIME_MAJOR:
        _row_major(mesh, 0, 0, spec)  # raises on an unknown layout
    return torch.cat([torch.cat([parts[r].to(dev) for r in row], dim=dim)
                      for row in mesh.rows()], dim=0)


def shard_time(x: torch.Tensor, mesh: DspMesh) -> List[torch.Tensor]:
    """Split ``(C, T)`` into one contiguous ``(C, T / n_time)`` shard per
    rank of a 1-D time mesh, each on its rank's device."""
    if mesh.axis_names != (TIME_AXIS,):
        raise ValueError(f"shard_time needs a 1-D ({TIME_AXIS!r},) mesh, got "
                         f"{mesh.axis_names}")
    return shard(x, mesh)


def gather_time(parts: Sequence[torch.Tensor], mesh: DspMesh,
                dim: int = -1) -> torch.Tensor:
    """Concatenate per-rank shards along ``dim`` on rank 0's device (the
    inverse of :func:`shard_time`; ``dim=1`` joins spectral frames)."""
    dev = mesh.ranks[0].device
    mesh.join()
    return torch.cat([p.to(dev) for p in parts], dim=dim)

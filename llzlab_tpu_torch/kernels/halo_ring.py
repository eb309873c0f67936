"""Kernel B3: the left-halo exchange between time shards, by hand for Hopper
(``csrc/halo_ring.cu``).

Replaces the Pallas TPU kernel ``llzlab_tpu/kernels/halo_ring.py``
(``_ring_send_kernel``, entry ``left_halo_ring``).  Contract (the same as
``parallel/halo.left_halo``): rank ``r`` of a 1-D time mesh receives the
last ``h`` samples of rank ``r − 1``'s ``(C, T)`` tensor; rank 0 receives
``first_shard_value`` (the stream carry) or zeros.

* :func:`left_halo_ring` is the entry: a CUDA mesh launches the kernel,
  once per card (:func:`left_halo_ring_cuda`, which counts its launches in
  ``.launches``); a CPU mesh runs the plain version.  Nothing falls back.
* :func:`left_halo_ring_plain` is the plain PyTorch version:
  ``parallel.halo.left_halo``, copies ordered by stream events.

One exchange is host-bound (the copy is microseconds of device time), so
the wrapper does as little as it can per call: it groups the mesh's ranks
by card (:func:`ranks_by_card`) and launches once per card, on the stream
of the card's first rank, with one ``torch.empty`` for the card's halos.
Between ranks of one card the kernel copies the left neighbour's row tails
straight into the halo: no receive buffer, no flag, no wait; stream events
alone order it.  Between cards it runs the protocol of
``csrc/halo_exchange.cuh``: the kernel of the left card writes its last
rank's tails into the right card's receive buffer and publishes a rising
epoch in its flag; the kernel of the right card waits for the epoch and
copies the buffer out.  :class:`HaloExchange` owns that state, one per
``(mesh, C, h)``, kept in ``mesh.cache`` and shared with kernel B4 (which
runs the protocol on every edge): receive buffers and flags, made when an
edge first needs them, and a stream event that keeps the send of call
``e + 1`` behind the receiver's launch of call ``e``, so that it never
lands on a halo that is still being read.  A receiver whose sender never
comes gives up after ``WAIT_LIMIT_S`` and sets an error word in pinned host
memory; :meth:`HaloExchange.check` raises on it.

Between cards the kernels store into the neighbour card's memory over
NVLink: :func:`enable_peer_access` enables that explicitly, in both
directions, when an edge is first made, and a pair of cards without peer
access raises (nothing is staged through the host).  The cross-card branch
of B3, and B4 with its neighbours on other cards, ran on four H100s of one
host joined by NVLink: 1-D meshes laid out ``[0, 0, 1, 1]``, ``[0, 1, 2,
3]``, ``[0, 0, 0, 0, 1, 1, 1, 1]`` and the channelizer on 2 and 4 cards,
each bitwise the same ranks on one card (``tests/test_torch_multicard.py``,
``chip_smoke.py`` phase 11).  ``left_halo_ring_cuda(..., _per_rank=True)``
launches each rank alone on its own stream, so that every edge runs the
protocol, also between ranks of one card: phase 11 checks the protocol so
on a machine with one card.  The ranks of another process have no pointer
here: a mesh across processes raises (it would need CUDA IPC).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import torch

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.parallel.halo import left_halo
from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh, note_traffic

__all__ = ["left_halo_ring", "left_halo_ring_cuda", "left_halo_ring_plain",
           "HaloExchange", "check_exchanges", "ranks_by_card",
           "same_card_edges", "enable_peer_access", "WAIT_LIMIT_S"]

#: how long a receiving kernel waits for its sender before it gives up
WAIT_LIMIT_S = 4.0
#: the most ranks one card may hold: one launch of kernel B3 serves them all
#: (MAX_RANKS in csrc/halo_ring.cu)
HALO_MAX_RANKS = 16

left_halo_ring_plain = left_halo


def ranks_by_card(devices: Sequence[torch.device]) -> List[List[int]]:
    """Group the ranks of a 1-D time mesh by card: one list of consecutive
    rank indices per device, in rank order; kernel B3 launches once per
    group.  A device that comes back after another one raises: time
    neighbours must share a card in one run, as ``make_dsp_mesh`` deals them
    out.  So does a card with more than ``HALO_MAX_RANKS`` ranks."""
    groups: List[List[int]] = []
    seen = []
    for r, dev in enumerate(devices):
        dev = torch.device(dev)
        if groups and dev == seen[-1]:
            groups[-1].append(r)
        elif dev in seen:
            raise ValueError(
                f"rank {r} is on {dev}, which an earlier run of ranks "
                f"already left: the ranks of one card must be consecutive "
                f"(got {[str(d) for d in devices]})")
        else:
            seen.append(dev)
            groups.append([r])
    for dev, group in zip(seen, groups):
        if len(group) > HALO_MAX_RANKS:
            raise ValueError(f"{len(group)} ranks on {dev}: one launch of "
                             f"the halo kernel serves at most "
                             f"{HALO_MAX_RANKS} ranks of a card")
    return groups


def same_card_edges(devices: Sequence[torch.device]) -> List[bool]:
    """For each edge ``r − 1 → r`` (``r = 1 … n − 1``), whether both ranks
    share a card: kernel B3 copies directly there, and runs the send / wait
    protocol on the other edges."""
    devs = [torch.device(d) for d in devices]
    return [devs[r - 1] == devs[r] for r in range(1, len(devs))]


class HaloExchange:
    """Receive buffers, flags, counters and error words of one halo
    exchange pattern ``(C, h)`` on a CUDA time mesh."""

    def __init__(self, mesh: DspMesh, c: int, h: int):
        n = len(mesh)
        self.mesh, self.c, self.h = mesh, c, h
        self.epoch = 0
        self.bufs: List[Optional[torch.Tensor]] = [None] * n
        self.flags: List[Optional[torch.Tensor]] = [None] * n
        self.counters: List[Optional[torch.Tensor]] = [None] * n
        # one word per rank, written by a kernel that gave up waiting
        self.err = torch.zeros(n, dtype=torch.int32).pin_memory()
        self._err_np = self.err.numpy()  # the same memory, cheaper to read
        # per rank: the event of its last launch on this exchange
        self._done: List[Optional[torch.cuda.Event]] = [None] * n

    @classmethod
    def of(cls, mesh: DspMesh, c: int, h: int) -> "HaloExchange":
        key = ("halo_exchange", c, h)
        if key not in mesh.cache:
            mesh.cache[key] = cls(mesh, c, h)
        return mesh.cache[key]

    def edge(self, r: int):
        """State of the protocol edge ``r − 1 → r``, made at first use:
        ``(buffer, flag)`` of rank ``r`` and the counter of rank ``r − 1``,
        as pointers."""
        if self.bufs[r] is None:
            src, dst = (self.mesh.ranks[q].device for q in (r - 1, r))
            if src != dst:
                enable_peer_access(src, dst)
            self.bufs[r] = torch.empty((self.c, self.h), dtype=torch.float32,
                                       device=dst)
            self.flags[r] = torch.zeros(1, dtype=torch.int32, device=dst)
            self.counters[r - 1] = torch.zeros(1, dtype=torch.int32,
                                               device=src)
            for dev in {src, dst}:  # the zeroed words exist before a kernel
                torch.cuda.synchronize(dev)
        return (self.bufs[r].data_ptr(), self.flags[r].data_ptr(),
                self.counters[r - 1].data_ptr())

    def err_ptr(self, r: int) -> int:
        return self.err.data_ptr() + 4 * r

    def check(self) -> None:
        """Raise if a receive of this exchange timed out.  The word is host
        memory: this waits for nothing and sees what finished kernels have
        reported (:func:`check_exchanges` drains the streams first)."""
        if self._err_np.any():
            bad = {r: int(e) for r, e in enumerate(self._err_np) if e}
            self._err_np[:] = 0
            raise RuntimeError(
                f"halo exchange (C={self.c}, h={self.h}): the receive of "
                f"rank(s) {sorted(bad)} never arrived within "
                f"{WAIT_LIMIT_S} s (epochs {bad}); its output is invalid")

    def begin(self) -> int:
        """Start one exchange over all ranks: the new epoch."""
        self.check()
        self.epoch += 1
        return self.epoch

    def before_send(self, r: int, stream: torch.cuda.Stream) -> None:
        """Order ``stream``'s send into rank ``r + 1``'s buffer behind that
        rank's read of what the buffer holds now."""
        if self._done[r + 1] is not None:
            stream.wait_event(self._done[r + 1])

    def launch_args(self, r: int):
        """Pointers of a launch that runs the protocol on both sides of
        rank ``r`` (kernel B4): ``(nbr_buf, nbr_flag, my_buf, my_flag,
        counter, err)``, None where the rank has no such side.  Also orders
        the launch behind the neighbour's read of the buffer it is about to
        overwrite."""
        nbr_buf = nbr_flag = my_buf = my_flag = counter = None
        if r + 1 < len(self.mesh):
            nbr_buf, nbr_flag, counter = self.edge(r + 1)
            self.before_send(r, self.mesh.ranks[r].stream)
        if r:
            my_buf, my_flag, _ = self.edge(r)
        return nbr_buf, nbr_flag, my_buf, my_flag, counter, self.err_ptr(r)

    def launched(self, r: int, event: Optional[torch.cuda.Event] = None
                 ) -> None:
        """Record that rank ``r``'s launch of the current epoch is queued
        (``event``: one already recorded behind it)."""
        self._done[r] = (self.mesh.ranks[r].stream.record_event()
                         if event is None else event)


def _expandable_segments() -> bool:
    """Whether PyTorch's allocator maps memory in expandable segments
    (``PYTORCH_CUDA_ALLOC_CONF`` / ``PYTORCH_ALLOC_CONF``)."""
    conf = ",".join(os.environ.get(v, "") for v in (
        "PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"))
    return "expandable_segments:true" in conf.replace(" ", "").lower()


def enable_peer_access(a: torch.device, b: torch.device) -> List[int]:
    """Let kernels of card ``a`` store into card ``b``'s memory, and of
    ``b`` into ``a``'s: ``cudaDeviceEnablePeerAccess`` in both directions,
    from the build's C library (``halo_enable_peer_access``).  Returns,
    per direction, 0 where this call enabled the access and -1 where it
    was enabled already.  Raises for a pair without peer access (the halo
    kernels write the neighbour's buffer directly; nothing falls back to
    copies through the host), and under PyTorch's expandable segments,
    whose memory a peer reaches only after ``cuMemSetAccess`` on each
    segment."""
    for src, dst in ((a, b), (b, a)):
        if not torch.cuda.can_device_access_peer(src.index, dst.index):
            raise RuntimeError(
                f"no peer access from {src} to {dst}: the halo kernels "
                f"write the neighbour card's buffer directly")
    if _expandable_segments():
        raise RuntimeError(
            "the halo kernels between cards need PyTorch's default "
            "allocator: under expandable_segments (PYTORCH_CUDA_ALLOC_CONF)"
            " a peer card reaches memory only after cuMemSetAccess")
    lib = _build.load("halo_ring", _declare)
    got = []
    for src, dst in ((a, b), (b, a)):
        rc = lib.halo_enable_peer_access(src.index, dst.index)
        _build.check(max(rc, 0), f"peer access from {src} to {dst}")
        got.append(rc)
    return got


def check_exchanges(mesh: DspMesh, after=None) -> None:
    """Raise if any halo receive on the mesh timed out since the last
    check, once its kernels have run: the host first waits for the stream
    events ``after``, or without them until the mesh's streams have
    drained."""
    if after is None:
        mesh.synchronize()
    for event in after or ():
        event.synchronize()
    failed = []
    for ex in mesh.cache.values():
        if isinstance(ex, HaloExchange):
            try:
                ex.check()
            except RuntimeError as exc:
                failed.append(str(exc))
    if failed:  # every exchange's error words are read, and so cleared
        raise RuntimeError("; ".join(failed))


def check_time_mesh(mesh: DspMesh, parts: Sequence[torch.Tensor]) -> None:
    if mesh.axis_names != (TIME_AXIS,):
        raise ValueError(f"needs a 1-D ({TIME_AXIS!r},) mesh, got "
                         f"{mesh.axis_names}")
    if mesh.is_distributed:
        raise ValueError("needs a mesh of this process's ranks: the halo "
                         "kernels address ranks by pointer, and a rank of "
                         "another process has none here")
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} shards for {len(mesh)} ranks")


class _HaloRank(ctypes.Structure):
    """``HaloRank`` of csrc/halo_ring.cu: how one rank gets its halo."""
    _fields_ = [("src", ctypes.c_void_p), ("src_stride", ctypes.c_longlong),
                ("out", ctypes.c_void_p), ("flag", ctypes.c_void_p),
                ("err", ctypes.c_void_p)]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.halo_ring_launch.argtypes = [p, i, i, i, p, ll, i, p, p, p, i, ll, p]
    lib.halo_ring_launch.restype = i
    lib.halo_enable_peer_access.argtypes = [i, i]
    lib.halo_enable_peer_access.restype = i


def left_halo_ring_cuda(parts: Sequence[torch.Tensor], h: int, mesh: DspMesh,
                        *, first_shard_value: Optional[torch.Tensor] = None,
                        _per_rank: bool = False) -> List[torch.Tensor]:
    """Launch kernel B3 once per card, on the stream of the card's first
    rank; the stream of every other rank of the card is ordered before and
    behind the launch by one event.  ``parts[r]``: ``(C, T)`` f32 on rank
    ``r``'s device, unit stride along time (rows may be strided).  Returns
    one ``(C, h)`` halo per rank, slices of one tensor per card whose memory
    is held until every rank's stream is done with it (``record_stream``).

    ``.launches`` counts the launches; ``.cross_card_launches`` those of
    them that send to or wait for another card.  ``_per_rank`` (for the
    checks of the protocol, not an entry point): launch each rank alone on
    its own stream, every edge through the send / wait protocol, also
    between ranks of one card."""
    check_time_mesh(mesh, parts)
    c, t = parts[0].shape if parts[0].dim() == 2 else (0, 0)
    for r, part in enumerate(parts):
        if not part.is_cuda or part.device != mesh.ranks[r].device:
            raise ValueError(f"shard {r} must lie on {mesh.ranks[r].device}, "
                             f"got {part.device}")
        if (part.dtype != torch.float32 or tuple(part.shape) != (c, t)
                or part.stride(1) != 1):
            raise ValueError(
                f"shards must be equal-shaped 2-D float32 with unit stride "
                f"along time, got {part.dtype} {tuple(part.shape)} strides "
                f"{part.stride()} at rank {r}")
    if not 0 <= h <= t:
        raise ValueError(f"halo width {h} outside [0, {t}]")
    if (first_shard_value is not None
            and tuple(first_shard_value.shape) != (c, h)):
        raise ValueError(f"first_shard_value must be {(c, h)}, got "
                         f"{tuple(first_shard_value.shape)}")
    if c == 0 or h == 0:  # nothing to exchange, nothing launched
        return [torch.empty((c, h), dtype=torch.float32, device=rank.device)
                for rank in mesh.ranks]
    key = ("halo_ring_layout", _per_rank)
    if key not in mesh.cache:
        devices = [rank.device for rank in mesh.ranks]
        cards = ranks_by_card(devices)
        mesh.cache[key] = (
            [[r] for r in range(len(devices))] if _per_rank else cards,
            [False] * (len(devices) - 1) if _per_rank
            else same_card_edges(devices),
            same_card_edges(devices))
    cards, same_card, on_one_card = mesh.cache[key]
    lib = _build.load("halo_ring", _declare)
    ex = HaloExchange.of(mesh, c, h)
    epoch = ex.begin()
    ranks, n = mesh.ranks, len(mesh)
    out: List[torch.Tensor] = []
    for run in cards:
        first, last = run[0], run[-1]
        dev, stream = ranks[first].device, ranks[first].stream
        others = run[1:]  # whose tensors the launch reads and writes too
        send = last + 1 < n  # the next rank is on another card
        # the card's device and its first rank's stream, entered once
        with torch.cuda.stream(stream):
            halos = torch.empty((len(run), c, h), dtype=torch.float32,
                                device=dev)
            table = (_HaloRank * len(run))()
            out0 = halos.data_ptr()
            for i, r in enumerate(run):
                entry = table[i]
                entry.out = out0 + 4 * c * h * i
                if r == 0:
                    if first_shard_value is not None:
                        carry = first_shard_value.to(
                            device=dev, dtype=torch.float32).contiguous()
                        entry.src, entry.src_stride = carry.data_ptr(), h
                elif same_card[r - 1]:  # the left neighbour's tails
                    entry.src = parts[r - 1].data_ptr() + 4 * (t - h)
                    entry.src_stride = parts[r - 1].stride(0)
                else:  # another card's: through the receive buffer
                    entry.src, entry.flag, _ = ex.edge(r)
                    entry.src_stride, entry.err = h, ex.err_ptr(r)
            nbr_buf = nbr_flag = counter = None
            if send:
                nbr_buf, nbr_flag, counter = ex.edge(last + 1)
                ex.before_send(last, stream)
            for r in others:
                stream.wait_event(ranks[r].mark())
            rc = lib.halo_ring_launch(
                table, len(run), c, h,
                parts[last].data_ptr() if send else None,
                parts[last].stride(0), t, nbr_buf, nbr_flag, counter, epoch,
                int(WAIT_LIMIT_S * 1e9), stream.cuda_stream)
            _build.check(rc, "halo_ring")
            left_halo_ring_cuda.launches += 1
            if (send and not on_one_card[last]) or (
                    first and not on_one_card[first - 1]):
                left_halo_ring_cuda.cross_card_launches += 1
            if table[0].flag:  # the next send into this buffer waits for
                done = stream.record_event()  # this: an event that is kept
                ex.launched(first, done)
            else:
                done = ranks[first].mark()
        for r in others:
            ranks[r].stream.wait_event(done)
            # the halos were allocated under the first rank's stream: keep
            # their memory from reuse there while rank r may still read it
            halos.record_stream(ranks[r].stream)
        out.extend(halos.unbind(0))
    note_traffic("collective-permute", 4 * c * h, n - 1)
    return out


left_halo_ring_cuda.launches = 0
left_halo_ring_cuda.cross_card_launches = 0


def left_halo_ring(parts: Sequence[torch.Tensor], h: int, mesh: DspMesh, *,
                   first_shard_value: Optional[torch.Tensor] = None
                   ) -> List[torch.Tensor]:
    """Left-halo exchange on a 1-D time mesh: kernel B3 on a CUDA mesh, the
    plain version on a CPU mesh.  Orders rank against rank; the caller
    orders the mesh against its own stream (``mesh.fork`` / ``mesh.join``)."""
    check_time_mesh(mesh, parts)
    if mesh.is_cuda:
        return left_halo_ring_cuda(parts, h, mesh,
                                   first_shard_value=first_shard_value)
    return left_halo_ring_plain(parts, h, mesh,
                                first_shard_value=first_shard_value)

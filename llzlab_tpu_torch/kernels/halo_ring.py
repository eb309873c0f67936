"""Kernel B3: the left-halo exchange between time shards, by hand for Hopper
(``csrc/halo_ring.cu``).

Replaces the Pallas TPU kernel ``llzlab_tpu/kernels/halo_ring.py``
(``_ring_send_kernel``, entry ``left_halo_ring``).  Contract (the same as
``parallel/halo.left_halo``): rank ``r`` of a 1-D time mesh receives the
last ``h`` samples of rank ``r − 1``'s ``(C, T)`` tensor; rank 0 receives
``first_shard_value`` (the stream carry) or zeros.

* :func:`left_halo_ring` is the entry: a CUDA mesh launches the kernel,
  once per rank in rank order on the rank's stream
  (:func:`left_halo_ring_cuda`, which counts its launches in
  ``.launches``); a CPU mesh runs the plain version.  Nothing falls back.
* :func:`left_halo_ring_plain` is the plain PyTorch version:
  ``parallel.halo.left_halo``, copies ordered by stream events.

The kernel of rank ``r − 1`` writes its tail into rank ``r``'s receive
buffer and publishes a rising epoch in rank ``r``'s flag; the kernel of
rank ``r`` waits for the epoch and copies the buffer out
(``csrc/halo_exchange.cuh``).  :class:`HaloExchange` owns that state, one
per ``(mesh, C, h)``, allocated once and kept in ``mesh.cache``: one
receive buffer per rank, and a stream event that keeps the send of call
``e + 1`` behind the receiver's launch of call ``e``, so that it never lands
on a halo that is still being read.  A receiver whose sender never comes gives up after
``WAIT_LIMIT_S`` and sets an error word in pinned host memory;
:meth:`HaloExchange.check` raises on it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.parallel.halo import left_halo
from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh

__all__ = ["left_halo_ring", "left_halo_ring_cuda", "left_halo_ring_plain",
           "HaloExchange", "check_exchanges", "WAIT_LIMIT_S"]

#: how long a receiving kernel waits for its sender before it gives up
WAIT_LIMIT_S = 4.0

left_halo_ring_plain = left_halo


class HaloExchange:
    """Receive buffers, flags, counters and error words of one halo
    exchange pattern ``(C, h)`` on a CUDA time mesh."""

    def __init__(self, mesh: DspMesh, c: int, h: int):
        n = len(mesh)
        self.mesh, self.c, self.h = mesh, c, h
        self.epoch = 0
        self.bufs: List[Optional[torch.Tensor]] = [None] * n
        self.flags: List[Optional[torch.Tensor]] = [None] * n
        self.counters: List[torch.Tensor] = []
        for r, rank in enumerate(mesh.ranks):
            if r:
                self.bufs[r] = torch.empty((c, h), dtype=torch.float32,
                                           device=rank.device)
                self.flags[r] = torch.zeros(1, dtype=torch.int32,
                                            device=rank.device)
            self.counters.append(torch.zeros(1, dtype=torch.int32,
                                             device=rank.device))
            if r and rank.device != mesh.ranks[r - 1].device:
                _enable_peer_access(mesh.ranks[r - 1].device, rank.device)
        # one word per rank, written by a kernel that gave up waiting
        self.err = torch.zeros(n, dtype=torch.int32).pin_memory()
        # per rank: the event of its last launch on this exchange
        self._done: List[Optional[torch.cuda.Event]] = [None] * n
        for rank in mesh.ranks:  # the zeroed flags exist before any kernel
            torch.cuda.synchronize(rank.device)

    @classmethod
    def of(cls, mesh: DspMesh, c: int, h: int) -> "HaloExchange":
        key = ("halo_exchange", c, h)
        if key not in mesh.cache:
            mesh.cache[key] = cls(mesh, c, h)
        return mesh.cache[key]

    def check(self) -> None:
        """Raise if a receive of this exchange timed out.  The word is host
        memory: this waits for nothing and sees what finished kernels have
        reported (:func:`check_exchanges` drains the streams first)."""
        if bool(self.err.any()):
            bad = {r: int(e) for r, e in enumerate(self.err.tolist()) if e}
            self.err.zero_()
            raise RuntimeError(
                f"halo exchange (C={self.c}, h={self.h}): the receive of "
                f"rank(s) {sorted(bad)} never arrived within "
                f"{WAIT_LIMIT_S} s (epochs {bad}); its output is invalid")

    def begin(self) -> int:
        """Start one exchange over all ranks: the new epoch."""
        self.check()
        self.epoch += 1
        return self.epoch

    def launch_args(self, r: int):
        """Pointers of rank ``r``'s launch: ``(nbr_buf,
        nbr_flag, my_buf, my_flag, counter, err)``, None where the rank
        has no such side.  Also orders the launch behind the neighbour's
        read of the buffer it is about to overwrite."""
        nbr = r + 1 < len(self.mesh)
        if nbr and self._done[r + 1] is not None:
            self.mesh.ranks[r].stream.wait_event(self._done[r + 1])
        return (
            self.bufs[r + 1].data_ptr() if nbr else None,
            self.flags[r + 1].data_ptr() if nbr else None,
            self.bufs[r].data_ptr() if r else None,
            self.flags[r].data_ptr() if r else None,
            self.counters[r].data_ptr(),
            self.err.data_ptr() + 4 * r,
        )

    def launched(self, r: int) -> None:
        """Record that rank ``r``'s launch of the current epoch is queued."""
        self._done[r] = self.mesh.ranks[r].stream.record_event()


def _enable_peer_access(a: torch.device, b: torch.device) -> None:
    """Make ``a``'s kernels able to write ``b``'s memory.  PyTorch enables
    peer access between two cards at their first direct copy."""
    if not torch.cuda.can_device_access_peer(a.index, b.index):
        raise RuntimeError(f"no peer access from {a} to {b}: the halo "
                           f"kernels write the neighbour's buffer directly")
    torch.zeros(1, device=a).to(b)
    torch.zeros(1, device=b).to(a)


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
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} shards for {len(mesh)} ranks")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.halo_ring_launch.argtypes = [p, ll, i, i, i, p, p, p, p, p, p, p, p,
                                     i, ll, p]
    lib.halo_ring_launch.restype = i


def left_halo_ring_cuda(parts: Sequence[torch.Tensor], h: int, mesh: DspMesh,
                        *, first_shard_value: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """Launch kernel B3 once per rank, in rank order, each on its rank's
    stream.  ``parts[r]``: ``(C, T)`` f32 on rank ``r``'s device, unit
    stride along time (rows may be strided)."""
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
    lib = _build.load("halo_ring", _declare)
    ex = HaloExchange.of(mesh, c, h)
    epoch = ex.begin()
    out = []
    for r, part in enumerate(parts):
        with mesh.on(r) as rank:
            nbr_buf, nbr_flag, my_buf, my_flag, counter, err = \
                ex.launch_args(r)
            recv = torch.empty((c, h), dtype=torch.float32,
                               device=rank.device)
            carry = None
            if r == 0 and first_shard_value is not None:
                carry = first_shard_value.to(
                    device=rank.device, dtype=torch.float32).contiguous()
            rc = lib.halo_ring_launch(
                part.data_ptr(), part.stride(0), t, c, h, nbr_buf, nbr_flag,
                my_buf, my_flag,
                None if carry is None else carry.data_ptr(),
                recv.data_ptr(), counter, err, epoch,
                int(WAIT_LIMIT_S * 1e9), rank.stream.cuda_stream)
            _build.check(rc, "halo_ring")
            ex.launched(r)
        left_halo_ring_cuda.launches += 1
        out.append(recv)
    return out


left_halo_ring_cuda.launches = 0


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

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
  ``parallel.halo.left_halo``, copies ordered by stream events (sends of
  ``torch.distributed`` between processes).

One exchange is host-bound (the copy is microseconds of device time), so
the wrapper does as little as it can per call: it groups the mesh's ranks
by process and card (:func:`edge_plan`) and launches once per run of this
process's ranks that share a card, on the stream of the run's first rank,
with one ``torch.empty`` for the run's halos.  Each edge ``r − 1 → r`` is
one of four kinds:

* ``DIRECT`` (one process, one card): the kernel copies the left
  neighbour's row tails straight into the halo: no receive buffer, no
  flag, no wait; stream events alone order it.
* ``PROTOCOL`` (one process, two cards): the protocol of
  ``csrc/halo_exchange.cuh``: the kernel of the left card writes its last
  rank's tails into the right card's receive buffer and publishes a rising
  epoch in its flag; the kernel of the right card waits for the epoch and
  copies the buffer out.  A stream event keeps the send of call ``e + 1``
  behind the receiver's launch of call ``e``, so that it never lands on a
  halo that is still being read.
* ``PROCESS`` (two processes of one host, on one card or two): the same
  protocol through CUDA IPC.  The receive buffer and flag are exported
  with ``cudaIpcGetMemHandle`` and opened by the other process with
  ``cudaIpcOpenMemHandle``, and so is the sender's ack word; in place of
  the event, the receiver acknowledges each epoch into the ack word once
  it has read the buffer, and the sender waits for the previous epoch's
  ack before it stores.
* ``NET`` (two processes on two hosts): a kernel can store only into
  memory of its own host (its card, a peer card, another process's memory
  opened through CUDA IPC), and the port builds on no library that lets a
  kernel start a transfer to another host (NVSHMEM, NCCL's device API).
  So the bytes travel through
  the process group: the sender's tails (``x[:, -h:]``, taken from the
  input on the sending rank's stream) go out by NCCL's point-to-point
  send, which the host queues before any kernel of the epoch launches,
  and the receiving process receives them into its receive buffer on a
  transfer stream of its own, then publishes the epoch in the flag with a
  one-thread kernel (``st.release.sys``).  The receiving kernel keeps
  what the TPU kernel does with the halo: B3's receiver waits on its flag
  and copies the buffer out, B4's waiters compute y-block 0 from it after
  the rest of the output was computed while it travelled.  The sending
  kernel stores nothing remotely.  This is the port's form of the TPU
  kernel's ``make_async_remote_copy`` and its receive semaphore, with the
  copy's start moved from the kernel's first grid step to the host just
  before the launch (from the input, so that no rank waits for its left
  neighbour's kernel and the ring never runs in series).  The transfer
  stream first waits for the receiving rank's launch of the previous
  epoch (back-pressure within the process, as on ``PROTOCOL`` edges).  The
  sends and receives of an epoch are one group call
  (``batch_isend_irecv``), posted in edge order by every process.

The receive buffer and flag of every edge that is not ``DIRECT`` (and the
ack word of a ``PROCESS`` edge) have their own ``cudaMalloc``, not a block
of PyTorch's caching allocator: a block cannot be exported alone, and
under PyTorch's expandable segments a peer card reaches the allocator's
memory only after ``cuMemSetAccess``.  So the kernels between cards run
under ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` as without it.

:class:`HaloExchange` owns that state, one per ``(mesh, C, h)``, kept in
``mesh.cache`` and shared with kernel B4 (which runs the protocol on every
edge).  Edges within a process are made when first needed.  Edges across
processes are made when the exchange is made, by a handshake that every
process joins at the same point, since every process walks the same
exchanges in the same order: each process's host name
(:func:`host_name`) is gathered once a mesh (:func:`process_hosts`),
which decides ``PROCESS`` or ``NET``; each process exports the handles of
its side of the ``PROCESS`` edges, all are gathered with
``torch.distributed.all_gather_object`` (gloo or NCCL), and each opens the
other side's; each ``NET`` pair is warmed with one transfer, so that
NCCL's connection setup never falls inside a kernel's wait.  A ``NET``
edge needs a NCCL group (gloo carries host memory only, and the kernels
stage nothing through the host): on another group every process raises,
naming NCCL.  The processes' epochs agree only if every process calls the
halo functions of the mesh the same number of times, with the same ``(C,
h)``; the same order keeps the processes' group calls matched.  The state
is closed and freed when the exchange goes (with the mesh's cache, or at
exit); a process frees its side only after its peers are done with it (a
caller that drops a mesh while other processes still run on it
synchronizes and joins them first).  A failed open raises, naming
``halo="ppermute"``; a failed send or receive raises from the group call.

A receiver whose sender never comes gives up after ``WAIT_LIMIT_S`` and
sets an error word in pinned host memory of its own process (a sender
whose acknowledgement never comes too); :meth:`HaloExchange.check` raises
on it, in the process whose rank waited.

Between cards the kernels store into the neighbour card's memory over
NVLink: :func:`enable_peer_access` enables that explicitly, in both
directions, when an edge within a process is first made, and a pair of
cards without peer access raises (nothing is staged through the host).
The cross-card branch of B3, and B4 with its neighbours on other cards,
ran on four H100s of one host joined by NVLink: 1-D meshes laid out ``[0,
0, 1, 1]``, ``[0, 1, 2, 3]``, ``[0, 0, 0, 0, 1, 1, 1, 1]`` and the
channelizer on 2 and 4 cards, each bitwise the same ranks on one card
(``tests/test_torch_multicard.py``, ``chip_smoke.py`` phase 11); across
processes, two processes on one card and a process a card, bitwise the
same ranks in one process (``chip_smoke.py`` phase 12), and ``NET``
edges between processes of one host with NCCL held to its network
transport (``NCCL_P2P_DISABLE=1``, ``NCCL_SHM_DISABLE=1``), each process
naming itself a host of its own (phase 12, the ``hosts`` mode of
``scripts/halo_ipc_worker_torch.py``).  Two machines have not run it.
``left_halo_ring_cuda(..., _per_rank=True)`` launches each rank alone on
its own stream, so that every edge runs the protocol, also between ranks
of one card, and ``_net=True`` makes every edge of a mesh of one process
a ``NET`` edge whose transport is a device copy on the transfer stream:
phase 11 checks both branches so on a machine with one card.
"""

from __future__ import annotations

import ctypes
import socket
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.parallel.halo import left_halo
from llzlab_tpu_torch.parallel.mesh import (TIME_AXIS, DspMesh, local_block,
                                            note_traffic)
from llzlab_tpu_torch.runtime.profiler import span

__all__ = ["left_halo_ring", "left_halo_ring_cuda", "left_halo_ring_plain",
           "HaloExchange", "check_exchanges", "edge_plan", "mesh_plan",
           "host_name", "process_hosts", "check_net_group", "ranks_by_card",
           "same_card_edges", "enable_peer_access", "WAIT_LIMIT_S",
           "DIRECT", "PROTOCOL", "PROCESS", "NET"]

#: how long a receiving kernel waits for its sender before it gives up
WAIT_LIMIT_S = 4.0
#: the most ranks one card may hold: one launch of kernel B3 serves them all
#: (MAX_RANKS in csrc/halo_ring.cu)
HALO_MAX_RANKS = 16
#: the kinds of edge r − 1 → r: both ranks on one card of this process (a
#: direct copy), the send / wait protocol within a process, across two
#: processes of one host (through CUDA IPC), and across two hosts (the
#: bytes through NCCL, the wait in the kernel)
DIRECT, PROTOCOL, PROCESS, NET = "direct", "protocol", "process", "net"
#: bytes before the receive buffer in its own allocation: the flag and the
#: receiver's count of reading blocks, an int each, padded
_IPC_HEAD = 256

left_halo_ring_plain = left_halo


def host_name() -> str:
    """The name of this process's host: processes of one name share
    memory through CUDA IPC, processes of two are joined by ``NET`` edges
    (:func:`process_hosts` gathers it from every process)."""
    return socket.gethostname()


def edge_plan(places: Sequence[Tuple[Optional[int], torch.device]],
              me: Optional[int] = None, per_rank: bool = False,
              hosts: Optional[Sequence[str]] = None
              ) -> Tuple[List[List[int]], List[str]]:
    """The launch plan of a 1-D time mesh from each rank's ``(process,
    device)``: the runs of consecutive ranks that process ``me`` launches
    (ranks of ``me`` that share a card; each rank alone with ``per_rank``),
    and the kind of each edge ``r − 1 → r`` (``r = 1 … n − 1``):
    :data:`DIRECT`, :data:`PROTOCOL`, :data:`PROCESS` or, where ``hosts``
    (each rank's host name; None: one host) differ, :data:`NET`.  A
    process of None is this one (``me`` None).  A ``(process, device)``
    that comes back after another one raises: the ranks of a card of one
    process must be consecutive, as ``make_dsp_mesh`` and
    ``global_dsp_mesh`` deal them.  So does a card of one process with more
    than ``HALO_MAX_RANKS`` ranks."""
    keys = [(p, torch.device(d)) for p, d in places]
    groups: List[List[int]] = []
    for r, key in enumerate(keys):
        if groups and key == keys[groups[-1][0]]:
            groups[-1].append(r)
        elif any(keys[g[0]] == key for g in groups):
            raise ValueError(
                f"rank {r} is on {key[1]} of process {key[0]}, which an "
                f"earlier run of ranks already left: the ranks of one card "
                f"of a process must be consecutive (got "
                f"{[(p, str(d)) for p, d in keys]})")
        else:
            groups.append([r])
    for g in groups:
        if len(g) > HALO_MAX_RANKS:
            raise ValueError(f"{len(g)} ranks on {keys[g[0]][1]}: one launch "
                             f"of the halo kernel serves at most "
                             f"{HALO_MAX_RANKS} ranks of a card")

    def kind(r: int) -> str:
        if keys[r - 1][0] != keys[r][0]:
            return NET if hosts and hosts[r - 1] != hosts[r] else PROCESS
        return DIRECT if keys[r - 1] == keys[r] and not per_rank \
            else PROTOCOL

    kinds = [kind(r) for r in range(1, len(keys))]
    runs = [g for g in groups if keys[g[0]][0] == me]
    if per_rank:
        runs = [[r] for g in runs for r in g]
    return runs, kinds


def process_hosts(mesh: DspMesh) -> Optional[List[str]]:
    """Each rank's host name on a mesh whose ranks live in several
    processes: :func:`host_name` of every process, gathered over the
    process group once a mesh (every process of the group calls this at
    the same point, as it walks the same exchanges).  None for a mesh of
    one process, or without a process group (no rank of another process
    can run then)."""
    import torch.distributed as dist

    if not mesh.is_distributed or not dist.is_initialized():
        return None
    if "process_hosts" not in mesh.cache:
        got: list = [None] * dist.get_world_size()
        dist.all_gather_object(got, host_name())
        me = dist.get_rank()
        mesh.cache["process_hosts"] = [
            got[me if rank.process is None else rank.process]
            for rank in mesh.ranks]
    return mesh.cache["process_hosts"]


def mesh_plan(mesh: DspMesh, per_rank: bool = False
              ) -> Tuple[List[List[int]], List[str]]:
    """:func:`edge_plan` of a mesh's ranks and hosts, for this process."""
    return edge_plan([(rank.process if rank.remote else None, rank.device)
                      for rank in mesh.ranks], None, per_rank,
                     process_hosts(mesh))


def ranks_by_card(devices: Sequence[torch.device]) -> List[List[int]]:
    """The runs of consecutive ranks of one card of a 1-D time mesh of one
    process: kernel B3 launches once per run (:func:`edge_plan`)."""
    return edge_plan([(None, d) for d in devices])[0]


def same_card_edges(devices: Sequence[torch.device]) -> List[bool]:
    """For each edge ``r − 1 → r`` of a mesh of one process, whether both
    ranks share a card: kernel B3 copies directly there, and runs the send
    / wait protocol on the other edges."""
    return [k == DIRECT for k in edge_plan([(None, d) for d in devices])[1]]


def check_net_group(kinds: Sequence[str]) -> None:
    """Raise unless the process group that carries the ``NET`` edges among
    ``kinds`` is NCCL's: gloo carries host memory only, and the halo
    kernels stage nothing through the host."""
    import torch.distributed as dist

    net = [r for r, k in enumerate(kinds, start=1) if k == NET]
    if not net:
        return
    backend = (str(dist.get_backend()) if dist.is_available()
               and dist.is_initialized() else "no process group")
    if "nccl" not in backend:
        raise RuntimeError(
            f"the halo kernels' edges {[(r - 1, r) for r in net]} join two "
            f"hosts, and their bytes travel through NCCL's point-to-point "
            f"sends; the process group is {backend!r}: initialise "
            f"torch.distributed with NCCL (gloo carries host memory only, "
            f"and the kernels stage nothing through the host)")


class Edge(NamedTuple):
    """Pointers of one protocol edge ``r − 1 → r`` valid in this process
    (None where this process has no use for one): rank ``r``'s receive
    buffer and flag, rank ``r − 1``'s send counter, and across processes
    of one host the ack word of rank ``r − 1`` and rank ``r``'s count of
    reading blocks."""
    buf: Optional[int]
    flag: Optional[int]
    counter: Optional[int]
    ack: Optional[int] = None
    rcount: Optional[int] = None


class _Raw:
    """A ``(c, h)`` float32 array of this module's own device memory, for
    ``torch.as_tensor`` (CUDA's array interface): the receive buffer of a
    ``NET`` edge, which the group call receives into."""

    def __init__(self, ptr: int, shape: Tuple[int, int]):
        self.__cuda_array_interface__ = {
            "shape": shape, "typestr": "<f4", "data": (ptr, False),
            "version": 2, "strides": None}


def _release(owned: list, opened: list) -> None:
    """Close what this process opened of other processes' exchange state,
    then free its own (after its kernels are done with either)."""
    lib = _build._LIBS.get("halo_ring")
    if lib is not None:  # at teardown an error has nowhere to go
        for dev, ptr in opened:
            lib.halo_ipc_close(dev, ptr)
        for dev, ptr in owned:
            lib.halo_ipc_free(dev, ptr)
    opened.clear()
    owned.clear()


class HaloExchange:
    """Receive buffers, flags, counters and error words of one halo
    exchange pattern ``(C, h)`` on a CUDA time mesh, in memory of their
    own; across processes of one host also the ack words, shared through
    CUDA IPC; across hosts the transfer streams.  ``close()`` closes and
    frees them (so does the exchange's collection, or the interpreter's
    exit).  ``net``: every edge is a ``NET`` edge whose transport is a
    device copy (a mesh of one process; the check of that branch on one
    card)."""

    def __init__(self, mesh: DspMesh, c: int, h: int, net: bool = False):
        n = len(mesh)
        self.mesh, self.c, self.h, self.net = mesh, c, h, net
        self.epoch = 0
        self.kinds = [NET] * (n - 1) if net else mesh_plan(mesh)[1]
        if net and mesh.is_distributed:
            raise ValueError("net=True takes a mesh of one process")
        if not net:
            check_net_group(self.kinds)
        self.edges: Dict[int, Edge] = {}
        self.counters: List[Optional[torch.Tensor]] = [None] * n
        # one word per rank, written by a kernel that gave up waiting
        self.err = torch.zeros(n, dtype=torch.int32).pin_memory()
        self._err_np = self.err.numpy()  # the same memory, cheaper to read
        # per rank: the event of its last launch on this exchange
        self._done: List[Optional[torch.cuda.Event]] = [None] * n
        # NET edges with an end in this process: receive buffers as
        # tensors, and the transfer stream of each receiving rank
        self._net = [r for r, k in enumerate(self.kinds, start=1)
                     if k == NET and (mesh.local(r - 1) or mesh.local(r))]
        self._recv: Dict[int, torch.Tensor] = {}
        self._xfer: Dict[int, torch.cuda.Stream] = {}
        self._owned: List[Tuple[int, int]] = []
        self._opened: List[Tuple[int, int]] = []
        self.close = weakref.finalize(self, _release, self._owned,
                                      self._opened)
        if net:
            lib = _build.load("halo_ring", _declare)
            for r in self._net:
                dev = mesh.ranks[r].device
                self._receive_side(lib, r, dev)
                self._xfer[r] = torch.cuda.Stream(dev)
        elif PROCESS in self.kinds or NET in self.kinds:
            self._handshake()

    @classmethod
    def of(cls, mesh: DspMesh, c: int, h: int, net: bool = False
           ) -> "HaloExchange":
        key = ("halo_exchange", c, h) + (("net",) if net else ())
        if key not in mesh.cache:
            mesh.cache[key] = cls(mesh, c, h, net)
        return mesh.cache[key]

    def _receive_side(self, lib, r: int, dev: torch.device) -> int:
        """Allocate rank ``r``'s receive buffer and flag (zeroed, in their
        own allocation); on a ``NET`` edge also its tensor.  The base."""
        base = self._alloc(lib, dev, _IPC_HEAD + 4 * self.c * self.h)
        if self.kinds[r - 1] == NET:
            self.edges[r] = Edge(base + _IPC_HEAD, base, None)
            self._recv[r] = torch.as_tensor(
                _Raw(base + _IPC_HEAD, (self.c, self.h)), device=dev)
        return base

    def _handshake(self) -> None:
        """Make every edge across processes: allocate and export this
        process's side of the ``PROCESS`` edges, gather every process's
        handles, open the other side; allocate the receive side of the
        ``NET`` edges and warm each pair with one transfer."""
        import torch.distributed as dist

        from llzlab_tpu_torch.kernels import halo_fir_fused

        # both halo kernels are built before any process can launch one,
        # so that no peer waits out WAIT_LIMIT_S behind a compiler
        lib = _build.load("halo_ring", _declare)
        halo_fir_fused.library()
        ranks = self.mesh.ranks
        world = dist.get_world_size() if dist.is_initialized() else 0
        if {rank.process for rank in ranks} != set(range(world)):
            raise ValueError(
                "the halo kernels across processes make their edges in a "
                "handshake of the whole process group: it needs "
                "torch.distributed initialised and ranks of the mesh in "
                f"every one of its {world} processes")
        own, mine = {}, {}
        for r, kind in enumerate(self.kinds, start=1):
            src, dst = ranks[r - 1], ranks[r]
            if kind == NET and not dst.remote:
                self._receive_side(lib, r, dst.device)
            if kind != PROCESS:
                continue
            # the receiver: buffer, flag and count; the sender: its ack word
            if not dst.remote:
                own[("recv", r)] = self._receive_side(lib, r, dst.device)
                mine[("recv", r)] = self._export(lib, dst.device,
                                                 own[("recv", r)])
            if not src.remote:
                own[("ack", r)] = self._alloc(lib, src.device, _IPC_HEAD)
                mine[("ack", r)] = self._export(lib, src.device,
                                                own[("ack", r)])
        if PROCESS in self.kinds:
            got: list = [None] * world
            dist.all_gather_object(got, mine)
            theirs = {k: v for handles in got for k, v in handles.items()}
        for r, kind in enumerate(self.kinds, start=1):
            if kind != PROCESS:
                continue
            src, dst = ranks[r - 1], ranks[r]
            if not src.remote:
                base = self._open(lib, src.device, theirs[("recv", r)])
                self.counters[r - 1] = torch.zeros(1, dtype=torch.int32,
                                                   device=src.device)
                torch.cuda.synchronize(src.device)
                self.edges[r] = Edge(base + _IPC_HEAD, base,
                                     self.counters[r - 1].data_ptr(),
                                     ack=own[("ack", r)])
            elif not dst.remote:
                base = own[("recv", r)]
                self.edges[r] = Edge(base + _IPC_HEAD, base, None,
                                     ack=self._open(lib, dst.device,
                                                    theirs[("ack", r)]),
                                     rcount=base + 4)
        if self._net:
            devs = {ranks[r if self.mesh.local(r) else r - 1].device
                    for r in self._net}
            if len(devs) > 1:
                raise ValueError(
                    f"this process's ends of the edges across hosts lie on "
                    f"{sorted(map(str, devs))}: one group call of NCCL "
                    f"serves one card")
            stream = torch.cuda.Stream(devs.pop())
            self._xfer = dict.fromkeys(self._net, stream)
            self._transfer(None, 0)  # NCCL connects each pair here
            stream.synchronize()

    def _transfer(self, parts, epoch: int) -> None:
        """Queue epoch ``epoch``'s transfers of this process's ``NET``
        edges, in edge order: the tails of each sending rank of this
        process (``parts[r − 1][:, -h:]``, taken on its stream; zeros for
        the warm-up, ``parts`` None), sent and received in one group call
        on the transfer stream once the receiving rank's launch of the
        previous epoch is done, then each receive's epoch published in its
        flag.  ``net``: a device copy on each receiving rank's transfer
        stream in place of the group call."""
        ranks, c, h = self.mesh.ranks, self.c, self.h
        lib = _build.load("halo_ring", _declare)
        if self.net:
            for r in self._net:
                stream, src = self._xfer[r], parts[r - 1]
                stream.wait_event(ranks[r - 1].mark())
                if self._done[r] is not None:
                    stream.wait_event(self._done[r])
                with torch.cuda.device(ranks[r].device), \
                        torch.cuda.stream(stream):
                    self._recv[r].copy_(src.narrow(1, src.shape[1] - h, h))
                    self._publish(lib, r, epoch, stream)
            return
        import torch.distributed as dist

        stream = self._xfer[self._net[0]]
        ops, sent = [], []
        for r in self._net:
            src, dst = ranks[r - 1], ranks[r]
            if not src.remote:
                with torch.cuda.device(src.device), \
                        torch.cuda.stream(src.stream):
                    tails = (torch.zeros((c, h), device=src.device)
                             if parts is None else parts[r - 1].narrow(
                                 1, parts[r - 1].shape[1] - h, h
                             ).contiguous())
                stream.wait_event(src.mark())
                sent.append(tails)
                ops.append(dist.P2POp(dist.isend, tails, dst.process))
            if not dst.remote:
                if self._done[r] is not None:
                    stream.wait_event(self._done[r])
                ops.append(dist.P2POp(dist.irecv, self._recv[r],
                                      src.process))
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            if c * h:
                for work in dist.batch_isend_irecv(ops) or ():
                    work.wait()  # the transfer stream waits for NCCL's
            if epoch:
                for r in self._net:
                    if not ranks[r].remote:
                        self._publish(lib, r, epoch, stream)
        for tails in sent:  # their memory is not reused before the send
            tails.record_stream(stream)

    def _publish(self, lib, r: int, epoch: int,
                 stream: torch.cuda.Stream) -> None:
        _build.check(lib.halo_net_publish(self.edges[r].flag, epoch,
                                          stream.cuda_stream),
                     "halo_net_publish")

    def _alloc(self, lib, dev: torch.device, nbytes: int) -> int:
        ptr = ctypes.c_void_p()
        _build.check(lib.halo_ipc_alloc(dev.index, nbytes, ctypes.byref(ptr)),
                     f"cudaMalloc of {nbytes} bytes for the halo exchange "
                     f"on {dev}")
        self._owned.append((dev.index, ptr.value))
        return ptr.value

    def _export(self, lib, dev: torch.device, ptr: int) -> bytes:
        handle = (ctypes.c_ubyte * 64)()
        _build.check(lib.halo_ipc_export(dev.index, ptr, handle),
                     f"cudaIpcGetMemHandle on {dev}")
        return bytes(handle)

    def _open(self, lib, dev: torch.device, handle: bytes) -> int:
        ptr = ctypes.c_void_p()
        raw = (ctypes.c_ubyte * 64).from_buffer_copy(handle)
        rc = lib.halo_ipc_open(dev.index, raw, ctypes.byref(ptr))
        if rc:
            raise RuntimeError(
                f"cudaIpcOpenMemHandle on {dev} failed (CUDA error {rc}): "
                f"the halo kernels cannot reach the other process's halo "
                f"buffer; use halo='ppermute'")
        self._opened.append((dev.index, ptr.value))
        return ptr.value

    def edge(self, r: int) -> Edge:
        """State of the protocol edge ``r − 1 → r``; within a process made
        at first use."""
        if r not in self.edges:
            src, dst = (self.mesh.ranks[q].device for q in (r - 1, r))
            if src != dst:
                enable_peer_access(src, dst)
            base = self._receive_side(_build.load("halo_ring", _declare), r,
                                      dst)
            self.counters[r - 1] = torch.zeros(1, dtype=torch.int32,
                                               device=src)
            torch.cuda.synchronize(src)  # the zeroed word exists first
            self.edges[r] = Edge(base + _IPC_HEAD, base,
                                 self.counters[r - 1].data_ptr())
        return self.edges[r]

    def err_ptr(self, r: int) -> int:
        return self.err.data_ptr() + 4 * r

    def check(self) -> None:
        """Raise if a receive of this exchange timed out (or, across
        processes, a send whose acknowledgement never came).  The word is
        host memory: this waits for nothing and sees what finished kernels
        have reported (:func:`check_exchanges` drains the streams first)."""
        if self._err_np.any():
            bad = {r: int(e) for r, e in enumerate(self._err_np) if e}
            self._err_np[:] = 0
            got = {r: e for r, e in bad.items() if e > 0}
            acks = {r: -e for r, e in bad.items() if e < 0}
            msg = []
            if got:
                msg.append(f"the receive of rank(s) {sorted(got)} never "
                           f"arrived within {WAIT_LIMIT_S} s (epochs {got})")
            if acks:
                msg.append(f"the send of rank(s) {sorted(acks)} waited "
                           f"longer than {WAIT_LIMIT_S} s for the receiver "
                           f"to read the previous epoch (epochs {acks})")
            raise RuntimeError(
                f"halo exchange (C={self.c}, h={self.h}): {'; '.join(msg)}; "
                f"its output is invalid")

    def begin(self, parts) -> int:
        """Start one exchange of ``parts`` over all ranks: the new epoch,
        whose transfers over ``NET`` edges are queued here, before any
        kernel of the epoch launches."""
        self.check()
        self.epoch += 1
        if self._net:
            self._transfer(parts, self.epoch)
        return self.epoch

    def sends(self, r: int) -> bool:
        """Whether rank ``r``'s kernel B4 stores its tails into rank ``r +
        1``'s receive buffer (on every edge but a ``NET`` one)."""
        return r + 1 < len(self.mesh) and self.kinds[r] != NET

    def before_send(self, r: int, stream: torch.cuda.Stream) -> None:
        """Order ``stream``'s send into rank ``r + 1``'s buffer behind that
        rank's read of what the buffer holds now (within a process; across
        processes the kernel waits for the receiver's acknowledgement)."""
        if self._done[r + 1] is not None:
            stream.wait_event(self._done[r + 1])

    def launch_args(self, r: int):
        """Pointers of a launch that runs the protocol on both sides of
        rank ``r`` (kernel B4): ``(nbr, mine)``, the :class:`Edge` of the
        right and of the left side, None where the rank has no such side
        (or, on a ``NET`` edge, stores nothing into the right one).  Also
        orders the launch behind the neighbour's read of the buffer it is
        about to overwrite."""
        nbr = mine = None
        if self.sends(r):
            nbr = self.edge(r + 1)
            self.before_send(r, self.mesh.ranks[r].stream)
        if r:
            mine = self.edge(r)
        return nbr, mine

    def launched(self, r: int, event: Optional[torch.cuda.Event] = None
                 ) -> None:
        """Record that rank ``r``'s launch of the current epoch is queued
        (``event``: one already recorded behind it)."""
        self._done[r] = (self.mesh.ranks[r].stream.record_event()
                         if event is None else event)


def enable_peer_access(a: torch.device, b: torch.device) -> List[int]:
    """Let kernels of card ``a`` store into card ``b``'s memory, and of
    ``b`` into ``a``'s: ``cudaDeviceEnablePeerAccess`` in both directions,
    from the build's C library (``halo_enable_peer_access``).  Returns,
    per direction, 0 where this call enabled the access and -1 where it
    was enabled already.  Raises for a pair without peer access (the halo
    kernels write the neighbour's buffer directly; nothing falls back to
    copies through the host).  What a peer stores into is the exchange's
    own ``cudaMalloc``, so PyTorch's expandable segments change nothing."""
    for src, dst in ((a, b), (b, a)):
        if not torch.cuda.can_device_access_peer(src.index, dst.index):
            raise RuntimeError(
                f"no peer access from {src} to {dst}: the halo kernels "
                f"write the neighbour card's buffer directly")
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
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} shards for {len(mesh)} ranks")


class _HaloRank(ctypes.Structure):
    """``HaloRank`` of csrc/halo_ring.cu: how one rank gets its halo."""
    _fields_ = [("src", ctypes.c_void_p), ("src_stride", ctypes.c_longlong),
                ("out", ctypes.c_void_p), ("flag", ctypes.c_void_p),
                ("err", ctypes.c_void_p), ("ack", ctypes.c_void_p),
                ("rcount", ctypes.c_void_p)]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.halo_ring_launch.argtypes = [p, i, i, i, p, ll, i, p, p, p, p, p, i,
                                     ll, p]
    lib.halo_ring_launch.restype = i
    lib.halo_net_publish.argtypes = [p, i, p]
    lib.halo_net_publish.restype = i
    lib.halo_enable_peer_access.argtypes = [i, i]
    lib.halo_enable_peer_access.restype = i
    lib.halo_ipc_alloc.argtypes = [i, ll, p]
    lib.halo_ipc_export.argtypes = [i, p, p]
    lib.halo_ipc_open.argtypes = [i, p, p]
    lib.halo_ipc_close.argtypes = [i, p]
    lib.halo_ipc_free.argtypes = [i, p]
    for f in (lib.halo_ipc_alloc, lib.halo_ipc_export, lib.halo_ipc_open,
              lib.halo_ipc_close, lib.halo_ipc_free):
        f.restype = i


def count_launch(wrapper, mesh: DspMesh, kinds: Sequence[str],
                 edges: Sequence[int]) -> None:
    """Count one launch of ``wrapper`` in ``.launches``, and in
    ``.cross_card_launches`` / ``.cross_process_launches`` /
    ``.cross_host_launches`` where one of the launch's protocol ``edges``
    (``r`` for ``r − 1 → r``) joins two cards of this process / two
    processes / two hosts (a ``NET`` edge)."""
    wrapper.launches += 1
    ranks = mesh.ranks
    if any(kinds[r - 1] == PROTOCOL and ranks[r - 1].device != ranks[r].device
           for r in edges):
        wrapper.cross_card_launches += 1
    if any(kinds[r - 1] == PROCESS for r in edges):
        wrapper.cross_process_launches += 1
    if any(kinds[r - 1] == NET for r in edges):
        wrapper.cross_host_launches += 1


def left_halo_ring_cuda(parts: Sequence[Optional[torch.Tensor]], h: int,
                        mesh: DspMesh, *,
                        first_shard_value: Optional[torch.Tensor] = None,
                        _per_rank: bool = False, _net: bool = False
                        ) -> List[Optional[torch.Tensor]]:
    """Launch kernel B3 once per run of this process's ranks on one card,
    on the stream of the run's first rank; the stream of every other rank
    of the run is ordered before and behind the launch by one event.
    ``parts[r]``: ``(C, T)`` f32 on rank ``r``'s device, unit stride along
    time (rows may be strided); None for a rank of another process.
    Returns one ``(C, h)`` halo per rank of this process (None for the
    others), slices of one tensor per run whose memory is held until every
    rank's stream is done with it (``record_stream``).

    ``.launches`` counts the launches; ``.cross_card_launches`` those of
    them that send to or wait for another card of this process,
    ``.cross_process_launches`` another process, ``.cross_host_launches``
    another host.  ``_per_rank`` (for the checks of the protocol, not an
    entry point): launch each rank alone on its own stream, every edge
    through the send / wait protocol, also between ranks of one card.
    ``_net`` (the same, for the ``NET`` branch): on a mesh of one process,
    each rank alone, every edge a ``NET`` edge whose transport is a device
    copy on the receiving rank's transfer stream."""
    with span("kernels", "B3"):
        check_time_mesh(mesh, parts)
        ranks, n = mesh.ranks, len(mesh)
        local = [r for r in range(n) if mesh.local(r)]
        ref = local_block(parts)
        c, t = ref.shape if ref.dim() == 2 else (0, 0)
        for r in local:
            part = parts[r]
            if not part.is_cuda or part.device != ranks[r].device:
                raise ValueError(f"shard {r} must lie on {ranks[r].device}, "
                                 f"got {part.device}")
            if (part.dtype != torch.float32 or tuple(part.shape) != (c, t)
                    or part.stride(1) != 1):
                raise ValueError(
                    f"shards must be equal-shaped 2-D float32 with unit "
                    f"stride along time, got {part.dtype} "
                    f"{tuple(part.shape)} strides {part.stride()} at rank "
                    f"{r}")
        if not 0 <= h <= t:
            raise ValueError(f"halo width {h} outside [0, {t}]")
        if (first_shard_value is not None
                and tuple(first_shard_value.shape) != (c, h)):
            raise ValueError(f"first_shard_value must be {(c, h)}, got "
                             f"{tuple(first_shard_value.shape)}")
        out: List[Optional[torch.Tensor]] = [None] * n
        if c == 0 or h == 0:  # nothing to exchange, nothing launched
            for r in local:
                out[r] = torch.empty((c, h), dtype=torch.float32,
                                     device=ranks[r].device)
            return out
        alone = _per_rank or _net
        key = ("halo_ring_layout", alone)
        if key not in mesh.cache:
            mesh.cache[key] = mesh_plan(mesh, alone)[0]
        runs = mesh.cache[key]
        lib = _build.load("halo_ring", _declare)
        ex = HaloExchange.of(mesh, c, h, _net)
        kinds = [PROTOCOL if k == DIRECT and alone else k for k in ex.kinds]
        epoch = ex.begin(parts)
        for run in runs:
            first, last = run[0], run[-1]
            dev, stream = ranks[first].device, ranks[first].stream
            others = run[1:]  # whose tensors the launch reads and writes too
            # the next rank is across an edge that the kernel stores into
            send = last + 1 < n and kinds[last] != NET
            # the run's device and its first rank's stream, entered once
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
                    elif kinds[r - 1] == DIRECT:
                        # the left neighbour's tails
                        entry.src = parts[r - 1].data_ptr() + 4 * (t - h)
                        entry.src_stride = parts[r - 1].stride(0)
                    else:  # through the receive buffer
                        e = ex.edge(r)
                        entry.src, entry.flag = e.buf, e.flag
                        entry.src_stride = h
                        entry.err, entry.ack, entry.rcount = (ex.err_ptr(r),
                                                              e.ack, e.rcount)
                nbr = Edge(None, None, None)
                if send:
                    nbr = ex.edge(last + 1)
                    ex.before_send(last, stream)
                for r in others:
                    stream.wait_event(ranks[r].mark())
                rc = lib.halo_ring_launch(
                    table, len(run), c, h,
                    parts[last].data_ptr() if send else None,
                    parts[last].stride(0), t, nbr.buf, nbr.flag, nbr.counter,
                    nbr.ack, ex.err_ptr(last), epoch, int(WAIT_LIMIT_S * 1e9),
                    stream.cuda_stream)
                _build.check(rc, "halo_ring")
                count_launch(left_halo_ring_cuda, mesh, kinds,
                             [r for r in (first, last + 1) if 0 < r < n])
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
            for r, halo in zip(run, halos.unbind(0)):
                out[r] = halo
        note_traffic("collective-permute", 4 * c * h, n - 1)
        return out


left_halo_ring_cuda.launches = 0
left_halo_ring_cuda.cross_card_launches = 0
left_halo_ring_cuda.cross_process_launches = 0
left_halo_ring_cuda.cross_host_launches = 0


def left_halo_ring(parts: Sequence[Optional[torch.Tensor]], h: int,
                   mesh: DspMesh, *,
                   first_shard_value: Optional[torch.Tensor] = None
                   ) -> List[Optional[torch.Tensor]]:
    """Left-halo exchange on a 1-D time mesh, whose ranks may live in
    several processes, of one host or of several (None in ``parts`` for
    the ranks of other processes): kernel B3 on a CUDA mesh, the plain
    version on a CPU mesh.  Orders rank against rank; the caller orders the mesh against
    its own stream (``mesh.fork`` / ``mesh.join``)."""
    check_time_mesh(mesh, parts)
    if mesh.is_cuda:
        return left_halo_ring_cuda(parts, h, mesh,
                                   first_shard_value=first_shard_value)
    return left_halo_ring_plain(parts, h, mesh,
                                first_shard_value=first_shard_value)

"""Multi-process bootstrap: ``torch.distributed``, the global mesh and the
per-process shards (port of ``llzlab_tpu/runtime/distributed.py``).

:func:`init_distributed` joins this process to the group.  It reads the
JAX package's arguments and environment (``JAX_COORDINATOR_ADDRESS`` as
``host:port``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so that a
launcher written for the JAX package starts the port too.  The transport
follows from the device the caller names: NCCL for CUDA ranks (and a CUDA
group without NCCL raises), gloo for CPU ranks.

:func:`global_dsp_mesh` deals ranks over every process's devices: each
process holds its own ranks, the others are remote ranks of the same
``DspMesh``.  Only the exchange points cross a process boundary
(``DspMesh.move`` / ``fetch``: the halo, the state tails, the reshard, the
IIR carry, the tap-parallel FIR's partial sums, the heartbeat's
``all_reduce``), so the sharded ops, ``fir_filter_tap_parallel`` and the
channelizer's ``sharded_step`` run on such a mesh.  Kernels B3 and B4
(``halo="rdma"`` / ``"rdma_fused"``, on a 1-D mesh: ``mesh.row(0)`` of a
``(1, n)`` one) reach the neighbour of another process of the same host
through CUDA IPC: each process opens the other's receive buffer, flag and
ack word in a handshake over the process group (``kernels/halo_ring.py``),
which works over gloo as well as NCCL.  Between two hosts (as each
process's ``socket.gethostname()`` says, gathered in the handshake) an
edge is a ``NET`` edge: the sender's tails travel by NCCL's
point-to-point send, queued before the kernels launch, and the receiving
kernel waits for them on its flag as on any other edge; that needs a NCCL
group, and on gloo every process raises, naming NCCL.  NCCL ran between 2
and 4 processes of one machine, a card each, bit for bit one process's
mesh (``tests/test_torch_distributed.py``, ``tests/test_torch_multicard.py``),
and so did the ``NET`` edges with NCCL held to its network transport
(``NCCL_P2P_DISABLE=1 NCCL_SHM_DISABLE=1``, each process naming itself a
host: ``python3 scripts/halo_ipc_worker_torch.py hosts 2`` on a machine
of two cards, or ``chip_smoke.py --only-processes``); between two real
machines it is unverified.  NCCL refuses two processes on one card: there
a CUDA mesh of several processes takes a gloo group (the halo kernels
exchange only their handles through it), or the CUDA path runs as a group
of one.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from llzlab_tpu_torch.parallel.mesh import (CHANNEL_AXIS, TIME_AXIS,
                                            TIME_MAJOR, DspMesh, _row_major)
from llzlab_tpu_torch.runtime.platform import require_cuda

#: how long a collective or point-to-point send waits for a peer before it
#: raises (a dead peer's closed connection raises at once)
TIMEOUT_S = 60.0

__all__ = [
    "init_distributed",
    "global_dsp_mesh",
    "host_local_shard",
    "make_global_array",
    "process_index",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> None:
    """Join the process group.  The arguments default to the JAX
    package's environment variables (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).  ``device``: the device
    type of this process's ranks, "cuda" (NCCL; raises without a card or
    without NCCL) or "cpu" (gloo)."""
    import torch.distributed as dist

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    n = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get(
        "JAX_PROCESS_ID")
    if addr is None or n is None or pid is None:
        raise ValueError("init_distributed needs the coordinator address, "
                         "the process count and this process's index "
                         "(arguments or JAX_COORDINATOR_ADDRESS, "
                         "JAX_NUM_PROCESSES, JAX_PROCESS_ID)")
    kind = torch.device(device).type
    if kind == "cuda":
        require_cuda()
        if not dist.is_nccl_available():
            raise RuntimeError("CUDA ranks need NCCL, and this PyTorch has "
                               "no NCCL")
        backend = "nccl"
        torch.cuda.set_device(int(pid) % torch.cuda.device_count())
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unknown device type {kind!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=int(n),
        rank=int(pid), timeout=datetime.timedelta(seconds=TIMEOUT_S))


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_dsp_mesh(
    n_channel: Optional[int] = None, n_time: Optional[int] = None, *,
    ranks_per_process: Optional[int] = None,
) -> DspMesh:
    """``(channel, time)`` mesh over every process's ranks: process ``p``
    holds ranks ``p·k … p·k + k − 1`` in row-major order, ``k`` =
    ``ranks_per_process`` (default: its visible cards, or 1 on CPU ranks;
    the same on every process).  Default shape: the time axis spans
    everything."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("global_dsp_mesh needs init_distributed first")
    kind = _device_type()
    if ranks_per_process is None:
        ranks_per_process = torch.cuda.device_count() if kind == "cuda" \
            else 1
    k = int(ranks_per_process)
    procs = dist.get_world_size()
    n = k * procs
    if n_channel is None and n_time is None:
        n_channel, n_time = 1, n
    elif n_channel is None:
        n_channel = n // n_time
    elif n_time is None:
        n_time = n // n_channel
    if n_channel * n_time != n:
        raise ValueError(f"{n_channel}x{n_time} != {n} devices")
    cards = torch.cuda.device_count() if kind == "cuda" else 1
    devices = [torch.device("cuda", (i % k) * cards // k) if kind == "cuda"
               else torch.device("cpu") for i in range(n)]
    return DspMesh(devices, (CHANNEL_AXIS, TIME_AXIS), (n_channel, n_time),
                   processes=[i // k for i in range(n)])


def host_local_shard(c: int, t: int, mesh: DspMesh
                     ) -> Tuple[slice, slice]:
    """The ``(channel, time)`` slice of the global ``(c, t)`` signal that
    this process's ranks hold under the time-major layout (for loading
    per-process input)."""
    mine = [sl for r, sl in enumerate(_row_major(mesh, c, t, TIME_MAJOR))
            if mesh.local(r)]
    ch = (min(s[0].start for s in mine), max(s[0].stop for s in mine))
    tm = (min(s[1].start for s in mine), max(s[1].stop for s in mine))
    return slice(*ch), slice(*tm)


def make_global_array(
    global_shape: Tuple[int, ...],
    mesh: DspMesh,
    spec,
    fill_local: Callable[[tuple], np.ndarray],
) -> List[Optional[torch.Tensor]]:
    """This process's blocks of a global ``(C, T)`` signal in layout
    ``spec`` (``TIME_MAJOR`` or ``CHANNEL_MAJOR``): ``fill_local(index)``
    gives the block of a rank's global index (a tuple of slices, called
    once per rank of this process), placed on the rank's device; None for
    the ranks of other processes."""
    c, t = global_shape
    mesh.fork()
    out = mesh.map(lambda idx, rank: torch.from_numpy(np.ascontiguousarray(
        fill_local(idx))).to(rank.device), _row_major(mesh, c, t, spec),
        mesh.ranks)
    mesh.join()
    return out

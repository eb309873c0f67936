"""One process of the multi-process runs of
``tests/test_torch_distributed.py`` (2 processes) and
``tests/test_torch_multicard.py`` (4 processes, a card each; not a test
module): joins the process group from the JAX package's environment
variables (gloo for CPU ranks, NCCL for CUDA ranks), builds the global
``(1, 4)`` mesh (``4 / JAX_NUM_PROCESSES`` ranks a process), and writes
what each exchange, and two steps of the channelizer's ``sharded_step``,
gave its ranks into ``argv[1]`` as ``.npy`` files, the channelizer's
state as each process got it back; then kernels B3 and B4 (their plain
versions on CPU ranks) on the mesh's time row, each with a carry, the
channelizer with ``halo="rdma"`` and ``"rdma_fused"``, and the
tap-parallel FIR, which on CUDA ranks reach the other processes through
CUDA IPC.  ``argv[2]``: the ranks' device type,
"cpu" (the default) or "cuda" (one card per process).

    JAX_COORDINATOR_ADDRESS=localhost:PORT JAX_NUM_PROCESSES=2 \\
        JAX_PROCESS_ID=0 python tests/torch_dist_worker.py DIR [cuda]
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from llzlab_tpu_torch.chains.channelizer import Channelizer
from llzlab_tpu_torch.kernels.halo_fir_fused import block2_fir_halo_fused
from llzlab_tpu_torch.kernels.halo_ring import (check_exchanges,
                                                left_halo_ring)
from llzlab_tpu_torch.ops.fir import block2_block, firwin
from llzlab_tpu_torch.ops.iir import peaking_eq_sos
from llzlab_tpu_torch.parallel import halo
from llzlab_tpu_torch.parallel.mesh import TIME_MAJOR
from llzlab_tpu_torch.parallel.reshard import to_channel_major
from llzlab_tpu_torch.parallel.sharded_ops import sosfilt_sharded
from llzlab_tpu_torch.parallel.tap_tp import fir_filter_tap_parallel
from llzlab_tpu_torch.runtime import distributed as rd
from llzlab_tpu_torch.runtime.health import heartbeat

C, T = 8, 4 * 1024
#: the channelizer at the reference kernel tests' shapes (129 taps, 3/4,
#: K = 8, 64-point frames), halo="ppermute": (fir_method, frames, T_loc);
#: block2's a2a length puts frames across the rank boundaries
CZ_RUNS = (("fused", "local", 1024), ("block2", "local", 1024),
           ("block2", "a2a", 640))
#: the kernel halo modes, on the mesh's time row: (fir_method, frames,
#: T_loc, halo)
CZ_KERNEL_RUNS = (("fused", "local", 1024, "rdma"),
                  ("block2", "local", 1024, "rdma"),
                  ("block2", "local", 1024, "rdma_fused"))
CZ_STEPS = 2
#: the outputs of kernels B3 and B4 called directly, and of the
#: tap-parallel FIR; B3's halo width
KERNEL_OUTPUTS = ("ring", "b4", "tap")
RING_H = 63


def signal() -> np.ndarray:
    return np.random.default_rng(5).standard_normal((C, T)).astype(
        np.float32)


def cz_signal(t_loc: int) -> np.ndarray:
    """The channelizer's input, ``CZ_STEPS`` steps of 4 ranks."""
    return np.random.default_rng(6).standard_normal(
        (C, CZ_STEPS * 4 * t_loc)).astype(np.float32)


def channelizer(method: str, device) -> Channelizer:
    return Channelizer(fir_taps=firwin(129, 0.2), up=3, down=4,
                       taps_per_phase=8, fft_n=64, fir_method=method,
                       device=device)


def run_name(method, frames, halo="ppermute") -> str:
    return f"cz_{method}_{frames}" + ("" if halo == "ppermute"
                                      else f"_{halo}")


def channelizer_runs(mesh, blocks_of, runs=CZ_RUNS):
    """Per run of ``runs`` (``CZ_RUNS``, ``CZ_KERNEL_RUNS``), per step: the
    spectra of the ranks and the state (on ``mesh.home``);
    ``blocks_of(x)`` makes the blocks of one step's ``(C, 4 · T_loc)``
    input.  The kernel halos run on the mesh's time row."""
    home = mesh.ranks[mesh.home].device
    out = {}
    for method, frames, t_loc, *halo in runs:
        halo = halo[0] if halo else "ppermute"
        ch = channelizer(method, home)
        step = ch.sharded_step(mesh if halo == "ppermute" else mesh.row(0),
                               halo=halo, frames=frames)
        st = ch.init_state(C, device=home)
        x = cz_signal(t_loc)
        for i in range(CZ_STEPS):
            name = f"{run_name(method, frames, halo)}_{i}"
            spec, st = step(blocks_of(x[:, i * 4 * t_loc:
                                        (i + 1) * 4 * t_loc]), st)
            out[name] = (spec, st)
    if mesh.is_cuda:
        check_exchanges(mesh.row(0))
    return out


def kernel_outputs(mesh, parts) -> dict:
    """``KERNEL_OUTPUTS``: B3 (``left_halo_ring``, a carry of ``RING_H``
    samples) and B4 (``block2_fir_halo_fused`` at "highest", a carry of a
    block) on the mesh's time row, each rank's ``parts``, and
    ``fir_filter_tap_parallel`` of the whole signal over the mesh."""
    row = mesh.row(0)
    home = mesh.ranks[mesh.home].device
    rng = np.random.default_rng(8)
    taps = firwin(129, 0.2)

    def carry(h):
        return torch.from_numpy(rng.standard_normal((C, h)).astype(
            np.float32)).to(home)

    row.fork()
    out = {"ring": left_halo_ring(parts, RING_H, row,
                                  first_shard_value=carry(RING_H)),
           "b4": block2_fir_halo_fused(
               parts, taps, row, first_shard_value=carry(block2_block(129)),
               mode="highest")}
    row.join()
    if row.is_cuda:
        check_exchanges(row)
    out["tap"] = fir_filter_tap_parallel(torch.from_numpy(signal()), taps,
                                         mesh)
    return out


def main(out: str, device: str) -> None:
    rd.init_distributed(device=device)
    me = rd.process_index()
    mesh = rd.global_dsp_mesh(ranks_per_process=4 // dist.get_world_size())
    x = signal()
    parts = rd.make_global_array((C, T), mesh, TIME_MAJOR,
                                 lambda idx: x[idx])
    carry = torch.from_numpy(np.arange(C * 5, dtype=np.float32).reshape(
        C, 5)).to(mesh.ranks[mesh.home].device)
    got = {
        "halo": halo.left_halo(parts, 5, mesh, first_shard_value=carry),
        "right": halo.right_halo(parts, 7, mesh),
        "tail": halo.broadcast_from_last(mesh.map(lambda p: p[:, -3:],
                                                  parts), mesh),
        "a2a": to_channel_major(parts, mesh),
        "iir": sosfilt_sharded(parts, peaking_eq_sos([100, 1000], [3, -4],
                                                     48000.0), mesh,
                               block_size=256),
    }
    got.update(kernel_outputs(mesh, parts))
    for name, (spec, st) in channelizer_runs(mesh, lambda v: (
            rd.make_global_array(v.shape, mesh, TIME_MAJOR,
                                 lambda idx: v[idx])),
            CZ_RUNS + CZ_KERNEL_RUNS).items():
        got[name] = spec
        for k, v in enumerate(st):
            np.save(os.path.join(out, f"{name}_state{k}_p{me}.npy"),
                    v.cpu().numpy())
    mesh.join()
    for name, blocks in got.items():
        mesh.map(lambda v, r: np.save(os.path.join(out, f"{name}_r{r}.npy"),
                                      v.cpu().numpy()), blocks, range(4))
    bad = torch.zeros(T)
    if me == 1:
        bad[-1] = float("nan")  # on a rank of process 1 only
    info = {
        "mesh": [mesh.n_channel, mesh.n_time],
        "local": [r for r in range(len(mesh)) if mesh.local(r)],
        "slice": [[s.start, s.stop] for s in rd.host_local_shard(C, T,
                                                                  mesh)],
        "clean": heartbeat(mesh)["ok"],
        "nan": heartbeat(mesh, bad)["ok"],
    }
    with open(os.path.join(out, f"info_{me}.json"), "w") as f:
        json.dump(info, f)
    mesh.synchronize()  # no peer frees halo state this process still uses
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "cpu")

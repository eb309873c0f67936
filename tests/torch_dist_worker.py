"""One process of the multi-process runs of
``tests/test_torch_distributed.py`` (2 processes) and
``tests/test_torch_multicard.py`` (4 processes, a card each; not a test
module): joins the process group from the JAX package's environment
variables (gloo for CPU ranks, NCCL for CUDA ranks), builds the global
``(1, 4)`` mesh (``4 / JAX_NUM_PROCESSES`` ranks a process), and writes
what each exchange, and two steps of the channelizer's ``sharded_step``,
gave its ranks into ``argv[1]`` as ``.npy`` files, the channelizer's
state as each process got it back.  ``argv[2]``: the ranks' device type,
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
from llzlab_tpu_torch.ops.fir import firwin
from llzlab_tpu_torch.ops.iir import peaking_eq_sos
from llzlab_tpu_torch.parallel import halo
from llzlab_tpu_torch.parallel.mesh import TIME_MAJOR
from llzlab_tpu_torch.parallel.reshard import to_channel_major
from llzlab_tpu_torch.parallel.sharded_ops import sosfilt_sharded
from llzlab_tpu_torch.runtime import distributed as rd
from llzlab_tpu_torch.runtime.health import heartbeat

C, T = 8, 4 * 1024
#: the channelizer at the reference kernel tests' shapes (129 taps, 3/4,
#: K = 8, 64-point frames), halo="ppermute": (fir_method, frames, T_loc);
#: block2's a2a length puts frames across the rank boundaries
CZ_RUNS = (("fused", "local", 1024), ("block2", "local", 1024),
           ("block2", "a2a", 640))
CZ_STEPS = 2


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


def channelizer_runs(mesh, blocks_of):
    """Per run of ``CZ_RUNS``, per step: the spectra of the ranks and the
    state (on ``mesh.home``); ``blocks_of(x)`` makes the blocks of one
    step's ``(C, 4 · T_loc)`` input."""
    home = mesh.ranks[mesh.home].device
    out = {}
    for method, frames, t_loc in CZ_RUNS:
        ch = channelizer(method, home)
        step = ch.sharded_step(mesh, frames=frames)
        st = ch.init_state(C, device=home)
        x = cz_signal(t_loc)
        for i in range(CZ_STEPS):
            name = f"cz_{method}_{frames}_{i}"
            spec, st = step(blocks_of(x[:, i * 4 * t_loc:
                                        (i + 1) * 4 * t_loc]), st)
            out[name] = (spec, st)
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
    for name, (spec, st) in channelizer_runs(mesh, lambda v: (
            rd.make_global_array(v.shape, mesh, TIME_MAJOR,
                                 lambda idx: v[idx]))).items():
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
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "cpu")

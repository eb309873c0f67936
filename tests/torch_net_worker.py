"""One process of ``tests/test_torch_net_edge.py`` (not a test module):
joins a gloo group from the JAX package's environment variables, names
itself a host of its own (``kernels.halo_ring.host_name`` replaced, as the
``hosts`` mode of ``scripts/halo_ipc_worker_torch.py`` does), builds the
global ``(1, 4)`` mesh of two CPU ranks a process and, on its time row,
writes into ``argv[1]``: the kind of each edge as the halo kernels plan it
and what making their exchange raised on this gloo group (``info_<p>.json``),
then one step of the channelizer's ``sharded_step`` for each of
:data:`RUNS` (the plain versions of kernels B3 and B4 on CPU ranks), each
rank's spectra and the state as ``.npy`` files.

    JAX_COORDINATOR_ADDRESS=localhost:PORT JAX_NUM_PROCESSES=2 \\
        JAX_PROCESS_ID=0 python tests/torch_net_worker.py DIR
"""

import json
import os
import sys

import numpy as np
import torch.distributed as dist

from llzlab_tpu_torch.chains.channelizer import Channelizer
from llzlab_tpu_torch.kernels import halo_ring as hr
from llzlab_tpu_torch.ops.fir import firwin
from llzlab_tpu_torch.parallel.mesh import TIME_MAJOR
from llzlab_tpu_torch.runtime import distributed as rd

#: (fir_method, halo) of the kernel halo modes
RUNS = (("block2", "rdma"), ("fused", "rdma"), ("block2", "rdma_fused"))
C, N_RANKS = 8, 4


def config(method: str) -> dict:
    """The small flagship of the JAX package's sharded tests
    (``tests/test_torch_channelizer.py``'s ``_config``)."""
    return dict(fir_taps=firwin(256, 0.4), fft_n=128, fir_method=method,
                up=3, down=4, taps_per_phase=8)


def t_loc(chan) -> int:
    m = chan.block_multiple()
    return -(-512 // m) * m  # at least two 256-blocks, for rdma_fused


def signal(t: int) -> np.ndarray:
    return np.random.default_rng(63).standard_normal((C, t)).astype(
        np.float32)


def main(out: str) -> None:
    me = int(os.environ["JAX_PROCESS_ID"])
    hr.host_name = lambda: f"host{me}"
    rd.init_distributed(device="cpu")
    mesh = rd.global_dsp_mesh(1, N_RANKS, ranks_per_process=2)
    row = mesh.row(0)
    info = {"kinds": hr.mesh_plan(row)[1], "hosts": hr.process_hosts(row)}
    try:
        hr.HaloExchange(row, C, 63)
        info["exchange"] = "made"
    except RuntimeError as exc:
        info["exchange"] = str(exc)
    for method, halo in RUNS:
        chan = Channelizer(device="cpu", **config(method))
        x = signal(N_RANKS * t_loc(chan))
        parts = rd.make_global_array(x.shape, mesh, TIME_MAJOR,
                                     lambda idx: x[idx])
        spec, st = chan.sharded_step(row, halo=halo)(
            parts, chan.init_state(C))
        for r, s in enumerate(spec):
            if s is not None:
                np.save(os.path.join(out, f"{method}_{halo}_r{r}.npy"),
                        s.numpy())
        for k, v in enumerate(st):
            np.save(os.path.join(out, f"{method}_{halo}_state{k}_p{me}.npy"),
                    v.numpy())
    with open(os.path.join(out, f"info_{me}.json"), "w") as f:
        json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])

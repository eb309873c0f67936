"""The halo kernels' edges between hosts (``NET``), on the CPU: two
processes joined over gloo on loopback, each naming itself a host of its
own, form one ``(1, 4)`` mesh of two ranks a process
(``tests/torch_net_worker.py``).  The edge between them plans as ``NET``
(the tails through NCCL, the wait in the kernels) and the ones within a
process as direct copies; making the kernels' exchange on this gloo group
raises in both processes, naming NCCL; and ``sharded_step`` with
``halo="rdma"`` and ``"rdma_fused"`` builds on that mesh and runs (the
kernels' plain versions on CPU ranks), equal to the JAX package's
``sharded_step`` on the same input at the port's floor against it, with
each process's state bitwise the reference's.  Marked ``multihost``, as
``tests/test_torch_distributed.py``."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from llzlab_tpu.chains.channelizer import Channelizer as RefChannelizer
from llzlab_tpu.ops.fir import firwin as ref_firwin
from llzlab_tpu.parallel.mesh import TIME_AXIS as REF_TIME_AXIS
from llzlab_tpu_torch.kernels import halo_ring as hr
from tests.torch_net_worker import C, N_RANKS, RUNS, config, signal, t_loc
from llzlab_tpu_torch.chains.channelizer import Channelizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
#: port against the JAX package: f32 engines that sum in another order
#: (tests/test_torch_channelizer.py)
VS_REFERENCE_DB = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def net_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("net")
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_net_worker.py"), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    return out


def _infos(out):
    return [json.load(open(os.path.join(out, f"info_{p}.json")))
            for p in range(2)]


@pytest.mark.multihost
def test_edges_between_two_hosts_plan_as_net(net_run):
    for info in _infos(net_run):
        assert info["hosts"] == ["host0", "host0", "host1", "host1"]
        assert info["kinds"] == [hr.DIRECT, hr.NET, hr.DIRECT]


@pytest.mark.multihost
def test_the_exchange_of_a_net_edge_on_gloo_raises_naming_nccl(net_run):
    for info in _infos(net_run):
        assert "NCCL" in info["exchange"], info["exchange"]
        assert "'gloo'" in info["exchange"] and "(1, 2)" in info["exchange"]


def _snr_db(ref, y) -> float:
    ref = np.asarray(ref)
    perr = float(np.sum(np.abs(ref - np.asarray(y)).astype(np.float64) ** 2))
    return float("inf") if perr == 0.0 else 10.0 * np.log10(
        float(np.sum(np.abs(ref).astype(np.float64) ** 2)) / perr)


@pytest.mark.multihost
@pytest.mark.parametrize("method,halo", RUNS,
                         ids=[f"{m}-{h}" for m, h in RUNS])
def test_sharded_step_across_two_hosts_matches_the_reference(
        net_run, method, halo, monkeypatch):
    """One step on the mesh of two "hosts" against the JAX package's
    ``sharded_step`` over four CPU devices, on the same input."""
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "highest")
    kw = config(method)
    kw["fir_taps"] = ref_firwin(256, 0.4)
    ref = RefChannelizer(**kw)
    x = signal(N_RANKS * t_loc(Channelizer(device="cpu", **config(method))))
    rmesh = Mesh(np.asarray(jax.devices()[:N_RANKS]), (REF_TIME_AXIS,))
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(rmesh, P(None, REF_TIME_AXIS)))
    rst = tuple(jax.device_put(s, NamedSharding(rmesh, P(None, None)))
                for s in ref.init_state(C))
    spec_r, rst = ref.sharded_step(rmesh, halo=halo)(xd, rst)
    got = np.concatenate([np.load(os.path.join(
        net_run, f"{method}_{halo}_r{r}.npy")) for r in range(N_RANKS)], 1)
    assert got.shape == tuple(spec_r.shape)
    assert _snr_db(np.asarray(spec_r), got) >= VS_REFERENCE_DB
    for p in range(2):
        np.testing.assert_array_equal(
            np.load(os.path.join(net_run, f"{method}_{halo}_state0_p{p}.npy")),
            np.asarray(rst[0]), err_msg=f"state of process {p}")

"""The port across processes on the CPU: two processes joined over gloo
on loopback (a free port from the OS, so parallel test workers do not
collide) form one ``(1, 4)`` mesh, two ranks each
(``runtime.distributed.global_dsp_mesh``); every exchange that crosses
the process boundary (the halo, the state tail, the reshard, the IIR
carry, the heartbeat) gives each rank what one process gives it on a
4-rank CPU mesh, bit for bit; so do two steps of the channelizer's
``sharded_step`` (``halo="ppermute"``, frames local and ``a2a``), and
each process gets the whole stream state back.  So do kernels B3 and B4
(their plain versions on CPU ranks) with a carry on the mesh's time row,
the channelizer with ``halo="rdma"`` and ``"rdma_fused"`` and the
tap-parallel FIR.  Then the multi-process demo
(``scripts/multihost_fir_demo_torch.py``), clean and with a worker killed
and the run resumed from its checkpoint.  Marked ``multihost``, not
``slow``: each process start costs seconds, not minutes.  The same two
processes with one card each, over NCCL, need two cards (NCCL will not
put two processes on one card) and are marked ``cuda`` too."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.ops.iir import peaking_eq_sos
from llzlab_tpu_torch.parallel import halo
from llzlab_tpu_torch.parallel.mesh import DspMesh, TIME_AXIS, shard
from llzlab_tpu_torch.parallel.reshard import to_channel_major
from llzlab_tpu_torch.parallel.sharded_ops import sosfilt_sharded
from llzlab_tpu_torch.runtime import distributed as rd
from tests.torch_dist_worker import CZ_KERNEL_RUNS, KERNEL_OUTPUTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _env(pid: int, port: int, n_procs: int = 2) -> dict:
    env = dict(os.environ)
    env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
               JAX_NUM_PROCESSES=str(n_procs), JAX_PROCESS_ID=str(pid),
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(out, device: str = "cpu", n_procs: int = 2):
    """``n_procs`` worker processes (2 or 4) on ``device`` ranks (a card
    each on "cuda"); their output directory."""
    port = _free_port()
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    envs = [_env(pid, port, n_procs) for pid in range(n_procs)]
    if device == "cuda":
        for pid, env in enumerate(envs):
            env["CUDA_VISIBLE_DEVICES"] = str(pid)
    procs = [subprocess.Popen([sys.executable, worker, str(out), device],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for env in envs]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * n_procs, logs
    return out


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("dist"))


def _blocks(out, name):
    return [np.load(os.path.join(out, f"{name}_r{r}.npy")) for r in range(4)]


@pytest.mark.multihost
def test_global_mesh_and_the_host_slices(two_process_run):
    infos = [json.load(open(os.path.join(two_process_run, f"info_{p}.json")))
             for p in range(2)]
    assert [i["mesh"] for i in infos] == [[1, 4], [1, 4]]
    assert [i["local"] for i in infos] == [[0, 1], [2, 3]]
    t = 4 * 1024
    assert infos[0]["slice"] == [[0, 8], [0, t // 2]]
    assert infos[1]["slice"] == [[0, 8], [t // 2, t]]


def _same_as_one_process(out, device):
    """Each exchange's blocks of the run in ``out`` == those of one
    process's 4-rank mesh on ``device``, bit for bit."""
    import tests.torch_dist_worker as w

    mesh = DspMesh([device] * 4, (TIME_AXIS,))
    parts = shard(torch.from_numpy(w.signal()), mesh)
    carry = torch.from_numpy(np.arange(8 * 5, dtype=np.float32).reshape(
        8, 5)).to(device)
    want = {
        "halo": halo.left_halo(parts, 5, mesh, first_shard_value=carry),
        "right": halo.right_halo(parts, 7, mesh),
        "tail": halo.broadcast_from_last([p[:, -3:] for p in parts], mesh),
        "a2a": to_channel_major(parts, mesh),
        "iir": sosfilt_sharded(parts, peaking_eq_sos([100, 1000], [3, -4],
                                                     48000.0), mesh,
                               block_size=256),
    }
    mesh.join()
    for name, blocks in want.items():
        for got, ref in zip(_blocks(out, name), blocks):
            np.testing.assert_array_equal(got, ref.cpu().numpy(),
                                          err_msg=name)


def kernels_same_as_one_process(out, devices, names=None):
    """The outputs ``names`` of ``torch_dist_worker.KERNEL_OUTPUTS`` in
    ``out`` == those of one process's 4-rank mesh on ``devices``, bit for
    bit."""
    import tests.torch_dist_worker as w

    mesh = DspMesh(list(devices), (TIME_AXIS,))
    want = w.kernel_outputs(mesh, shard(torch.from_numpy(w.signal()), mesh))
    mesh.join()
    for name in names or w.KERNEL_OUTPUTS:
        for got, ref in zip(_blocks(out, name), want[name]):
            np.testing.assert_array_equal(got, ref.cpu().numpy(),
                                          err_msg=name)


def channelizer_same_as_one_process(out, devices, n_procs: int, runs=None):
    """Each step's spectra of the channelizer ``runs`` (default
    ``CZ_RUNS``) in ``out`` == those of one process's 4-rank mesh on
    ``devices``, and the state every process got back == that mesh's, bit
    for bit."""
    import tests.torch_dist_worker as w

    mesh = DspMesh(list(devices), (TIME_AXIS,))
    want = w.channelizer_runs(mesh, lambda v: shard(torch.from_numpy(v),
                                                    mesh), runs or w.CZ_RUNS)
    mesh.join()
    for name, (spec, st) in want.items():
        for got, ref in zip(_blocks(out, name), spec):
            np.testing.assert_array_equal(got, ref.cpu().numpy(),
                                          err_msg=name)
        for p in range(n_procs):
            for k, v in enumerate(st):
                got = np.load(os.path.join(out, f"{name}_state{k}_p{p}.npy"))
                np.testing.assert_array_equal(
                    got, v.cpu().numpy(), err_msg=f"{name} state {k} of "
                                                  f"process {p}")


@pytest.mark.multihost
def test_exchanges_across_the_process_boundary_are_bitwise(two_process_run):
    _same_as_one_process(two_process_run, "cpu")


@pytest.mark.multihost
def test_channelizer_across_the_process_boundary_is_bitwise(two_process_run):
    channelizer_same_as_one_process(two_process_run, ["cpu"] * 4, 2)


@pytest.mark.multihost
@pytest.mark.parametrize("run", CZ_KERNEL_RUNS,
                         ids=[f"{r[0]}-{r[3]}" for r in CZ_KERNEL_RUNS])
def test_channelizer_kernel_halos_across_the_process_boundary_are_bitwise(
        two_process_run, run):
    """``halo="rdma"`` (fused, block2) and ``"rdma_fused"`` on the time row
    of the two processes' mesh: two steps, each process's state, bitwise
    one process's mesh."""
    channelizer_same_as_one_process(two_process_run, ["cpu"] * 4, 2, [run])


@pytest.mark.multihost
@pytest.mark.parametrize("name", KERNEL_OUTPUTS)
def test_halo_kernels_and_tap_parallel_across_the_boundary_are_bitwise(
        two_process_run, name):
    """``left_halo_ring`` and ``block2_fir_halo_fused``, each with a carry,
    on the time row of the two processes' mesh, and
    ``fir_filter_tap_parallel`` over it: bitwise one process's mesh."""
    kernels_same_as_one_process(two_process_run, ["cpu"] * 4, [name])


@pytest.mark.cuda
@pytest.mark.multihost
def test_exchanges_across_processes_over_nccl_are_bitwise(tmp_path):
    """The NCCL point-to-point sends (halo, tail, reshard, IIR carry) and
    all_reduce (heartbeat) between two processes, a card each; kernels B3
    and B4 between them through CUDA IPC, and the tap-parallel FIR."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL will not put two "
                    "processes on one card)")
    out = _launch(tmp_path, "cuda")
    _same_as_one_process(out, "cuda")
    channelizer_same_as_one_process(out, ["cuda"] * 4, 2)
    # B3 and B4 across the two processes, through CUDA IPC
    kernels_same_as_one_process(out, ["cuda"] * 4)
    channelizer_same_as_one_process(out, ["cuda"] * 4, 2, CZ_KERNEL_RUNS)
    infos = [json.load(open(os.path.join(out, f"info_{p}.json")))
             for p in range(2)]
    assert [(i["clean"], i["nan"]) for i in infos] == [(True, False)] * 2


@pytest.mark.multihost
def test_heartbeat_reduces_over_both_processes(two_process_run):
    infos = [json.load(open(os.path.join(two_process_run, f"info_{p}.json")))
             for p in range(2)]
    assert [i["clean"] for i in infos] == [True, True]
    # the NaN lay on a rank of process 1: process 0 sees it too
    assert [i["nan"] for i in infos] == [False, False]


def test_init_distributed_needs_its_three_values_and_a_known_device(
        monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        rd.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="device type"):
        rd.init_distributed("localhost:1", 1, 0, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rd.init_distributed("localhost:1", 1, 0)  # CUDA by default
    with pytest.raises(RuntimeError, match="init_distributed"):
        rd.global_dsp_mesh()
    assert rd.process_index() == 0


def _demo(tmp_path, *extra):
    script = os.path.join(REPO, "scripts", "multihost_fir_demo_torch.py")
    env = dict(os.environ)
    env.pop("JAX_PROCESS_ID", None)
    return subprocess.run([sys.executable, script, "--procs", "2",
                           "--ranks-per-proc", "2", "--workdir",
                           str(tmp_path), *extra], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)


@pytest.mark.multihost
def test_demo_two_processes_match_the_streaming_golden(tmp_path):
    r = _demo(tmp_path / "clean")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "multihost == streaming-golden: True" in r.stdout + r.stderr
    assert "spectral sharded == unsharded: True" in r.stdout + r.stderr


@pytest.mark.multihost
def test_demo_survives_a_killed_worker(tmp_path):
    r = _demo(tmp_path / "fault", "--inject-fault", "1")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "fault observed" in r.stdout + r.stderr
    assert "multihost == streaming-golden: True" in r.stdout + r.stderr

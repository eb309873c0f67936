"""``scripts/pod_scaling_torch.py --cpu``, the port of the JAX package's
scaling harness, at its tiny size: one JSON line a mesh point and a final
summary, the JAX script's keys, and on every point the analytic model's
bytes equal to what ``collective_traffic`` counted of the step (as
``tests/parallel/test_collective_traffic.py`` holds the JAX script's model
against the compiled HLO); the model is the JAX script's where the state
tails go the same way (one process a rank on a ``1xn`` mesh)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "pod_scaling_torch.py")
#: the JAX script's per-point keys (scripts/pod_scaling.py)
JAX_KEYS = {"mesh", "devices", "msps_per_chip", "aggregate_msps",
            "weak_scaling_eff", "step_seconds", "comm_bytes_per_step",
            "comm_bytes_hlo", "comm_ops_hlo", "host_cores", "config"}


def _run(*args):
    r = subprocess.run([sys.executable, SCRIPT, "--cpu", "--iters", "1",
                        *args], capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(v) for v in r.stdout.strip().splitlines()]
    return lines[:-1], lines[-1]


@pytest.mark.parametrize("args,meshes", [
    (("--scaling", "weak"), ["1x1", "1x2", "1x4"]),
    (("--scaling", "strong"), ["1x1", "1x2", "1x4", "2x2", "4x1"]),
    (("--scaling", "strong", "--fir-method", "block2", "--frames", "a2a",
      "--meshes", "1x4,2x2"), ["1x4", "2x2"]),
])
def test_points_carry_the_model_and_the_count(args, meshes):
    points, summary = _run(*args)
    assert [p["mesh"] for p in points] == meshes
    for p in points:
        assert JAX_KEYS <= set(p), sorted(JAX_KEYS - set(p))
        assert p["comm_bytes_per_step"] == p["comm_bytes_hlo"], p
        assert p["step_seconds"] > 0 and p["msps_per_chip"] > 0
    assert points[0]["weak_scaling_eff"] == 1.0
    assert points[1]["comm_bytes_per_step"] > 0
    assert summary["points"] == points and summary["backend"] == "cpu"
    assert summary["final_efficiency"] == points[-1]["weak_scaling_eff"]


@pytest.mark.multihost
def test_one_process_a_rank_over_gloo():
    points, _ = _run("--procs", "--scaling", "strong", "--meshes", "1x2")
    assert points[0]["procs"] == 2
    assert points[0]["comm_bytes_per_step"] == points[0]["comm_bytes_hlo"]


@pytest.mark.multihost
def test_processes_as_hosts_plan_net_edges_over_gloo():
    """``--procs --hosts --halo rdma``: each process a host of its own, so
    the kernels' one edge is a ``NET`` edge (the plain versions run on CPU
    ranks); the model's bytes are the count."""
    points, summary = _run("--procs", "--hosts", "--halo", "rdma",
                           "--meshes", "1x2")
    assert points[0]["procs"] == 2 and points[0]["halo_edges"] == ["net"]
    assert points[0]["comm_bytes_per_step"] == points[0]["comm_bytes_hlo"]
    assert summary["config"]["hosts"] is True


def test_the_model_is_the_jax_scripts_for_a_process_a_rank():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import pod_scaling_torch as ps
    finally:
        sys.path.pop(0)
    chan = ps.make_channelizer(ps.TINY, "block2", "cpu")
    h = chan.h_fir + chan.h_rs
    for n in (1, 2, 4, 8):
        # scripts/pod_scaling.py comm_bytes: 2 (n_time − 1) C (h_fir + h_rs)
        # float32s
        assert ps.comm_bytes(chan, 1, n, 64, procs=n) == \
            2 * (n - 1) * 64 * h * 4
        # one process: the tails go to rank 0 alone
        assert ps.comm_bytes(chan, 1, n, 64) == \
            ((n - 1) + (n > 1)) * 64 * h * 4


@pytest.mark.parametrize("halo,method", [("rdma", "fused"),
                                         ("rdma_fused", "block2")])
def test_kernel_halos_run_on_the_time_row_in_process(halo, method, capsys):
    """``--halo rdma`` / ``rdma_fused`` on ``1xn`` meshes (the plain
    versions of B3 and B4 on CPU ranks, in this process): the model's
    bytes are the count, as with ``ppermute``; a mesh of two channel rows
    raises."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import pod_scaling_torch as ps
    finally:
        sys.path.pop(0)
    assert ps.main(["--cpu", "--iters", "1", "--halo", halo, "--fir-method",
                    method, "--meshes", "1x1,1x2"]) == 0
    lines = [json.loads(v) for v in capsys.readouterr().out.splitlines()]
    assert [p["mesh"] for p in lines[:-1]] == ["1x1", "1x2"]
    assert lines[-1]["config"]["halo"] == halo
    for p in lines[:-1]:
        assert p["comm_bytes_per_step"] == p["comm_bytes_hlo"], p
    assert lines[1]["comm_bytes_hlo"] > 0
    with pytest.raises(ValueError, match="1xn"):
        ps.main(["--cpu", "--iters", "1", "--halo", halo, "--fir-method",
                 method, "--meshes", "2x2"])

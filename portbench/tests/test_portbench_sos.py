"""The cell ``iir64ch.stream`` (``drivers/sos_stream.py``): on the CPU at
4 channels, a run is correct, the control (``control_sos.py``) and each
planted fault are not, and the split check alone catches an engine that
agrees with the scan to rounding but not bit for bit; the float64
reference against scipy; the readers of its three metrics on synthetic
traces and counters; on a card, one short run at the published widths."""

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from scipy import signal

from conftest import ROOT
from llzlab_tpu_torch.ops.iir_matmul import sosfilt_matmul
from llzlab_tpu_torch.pipeline.chain import SOSStage
from portbench import (checks_sos, control_sos, core, design_sos,
                       reference_sos, roofline, roofline_sos)
from portbench.trace import Trace

CELL = "iir64ch.stream"
SMALL = {"channels": 4}
SEED = 2 ** 41 + 9


def sos_run(seed=SEED, seconds=2.0):
    """One untraced run of the cell at 4 channels on the CPU."""
    return core.run_cell(CELL, seed, seconds, False, [torch.device("cpu")],
                         t_start=time.perf_counter(), sizes=SMALL,
                         say=lambda text: None)


def test_a_run_is_correct_and_its_first_blocks_are_bitwise_one_call():
    line = sos_run()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 17
    assert line["checks"]["split_bits_differ"]["value"] == 0
    assert set(line["metrics"]) == {"block_p95_ms", "setup_s"}


@pytest.mark.parametrize("seed", [13, 2 ** 33 + 7])
def test_the_control_fails_the_check(seed):
    got = control_sos.run_control(CELL, seed, 17, torch.device("cpu"),
                                  SMALL["channels"])
    assert got["correct"] is False, got
    c = got["checks"]
    assert c["block_err_max"]["value"] > 10 * c["block_err_max"]["limit"]
    assert c["split_bits_differ"]["value"] > 0


def _break(monkeypatch, fault):
    apply = SOSStage.apply

    def broken(self, x, state):
        if fault == "matmul":
            return sosfilt_matmul(self.sos, x, zi=state, return_zf=True)
        y, new = apply(self, x, state)
        y = y.clone()
        if fault == "half":
            y[y.shape[0] // 2:] = 0
        elif fault == "altered":
            y[0, 100] += 0.01
        return y, (state if fault == "state" else new)

    monkeypatch.setattr(SOSStage, "apply", broken)


@pytest.mark.parametrize("fault", ["state", "half", "altered", "matmul"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    line = sos_run(seconds=5.0 if fault == "matmul" else 2.0)
    assert line["attempted"] >= 17
    assert line["correct"] is False, (fault, line["checks"])
    c = line["checks"]
    assert c["split_bits_differ"]["value"] > 0
    if fault == "matmul":  # only the split check sees it
        assert c["block_err_max"]["value"] <= c["block_err_max"]["limit"]


def test_the_reference_matches_scipy_and_rounds_every_product():
    cfg = core.Cell(CELL).cfg
    sos = design_sos.eq_sos(cfg)
    x = np.random.default_rng(5).standard_normal((3, 2000))
    zi = np.random.default_rng(6).standard_normal((len(sos), 3, 2))
    want, want_zf = signal.sosfilt(sos, x, axis=-1, zi=zi)
    y, zf = reference_sos.sosfilt(sos, torch.from_numpy(x),
                                  torch.from_numpy(zi.transpose(1, 0, 2)))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(zf.numpy(), want_zf.transpose(1, 0, 2),
                               rtol=0, atol=1e-12)
    # TF32 products: the 100 Hz section's a2 rounds to 1, its pole onto
    # the unit circle
    t, _ = reference_sos.sosfilt(sos, torch.from_numpy(x), rounding="tf32")
    assert float((t - y).norm() / y.norm()) > 1e-2


def test_the_design_is_the_cookbooks_and_the_history_its_radius():
    cfg = core.Cell(CELL).cfg
    sos = design_sos.eq_sos(cfg)
    assert sos.shape == (8, 6) and np.all(sos[:, 3] == 1.0)
    w, h = signal.sosfreqz(sos, [100.0, 1600.0, 12800.0], fs=48000.0)
    # each centre's gain, give or take its neighbours' skirts
    assert np.allclose(20 * np.log10(np.abs(h)), [3, 6, -5], atol=1.5)
    hist = reference_sos.history_len(sos)
    assert reference_sos.pole_radius(sos) ** hist < 1e-17
    assert 6000 < hist < 8000


def test_blocks_wrap_the_cycled_signal():
    sig = np.arange(2 * 10, dtype=np.float32).reshape(2, 10)
    np.testing.assert_array_equal(checks_sos.stream_block(sig, 2, 4),
                                  sig[:, [8, 9, 0, 1]])
    ctx = checks_sos.contexts(sig, [0, 3], 4, 3)
    np.testing.assert_array_equal(ctx[0, 0], [0, 0, 0, 0, 1, 2, 3])
    np.testing.assert_array_equal(ctx[1, 1], sig[1, [9, 0, 1, 2, 3, 4, 5]])


def test_the_cascades_least_time_by_the_worked_numbers():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    least, bound = roofline_sos.cascade_least_s(8, pk, 64 * 4096)
    assert bound == "bytes"
    assert least == pytest.approx(64 * 4096 * 8 / 3.35e12)  # 0.626 us
    t, b = roofline_sos.cascade_least_s(64, pk, 1000)
    assert b == "compute" and t == pytest.approx(9 * 64 * 1000 / 67e12)


def _ctx(host=(), ops=None, steps=2):
    cell = core.Cell(CELL)
    return core.Context(trace=Trace(ops or {}, list(host), (0.0, 1.0),
                                    steps),
                        cards=[0], steps=steps, cfg=cell.cfg, wl=cell.wl,
                        samples_per_step=64 * 4096,
                        device_name="NVIDIA H100 80GB HBM3")


def test_the_carry_reader_reads_the_spans_self_time_a_block():
    host = [(0.0, 0.4, "llz/ops/sosfilt"), (0.1, 0.15, "llz/ops/sos_carry"),
            (0.11, 0.12, "aten::copy_"), (0.2, 0.23, "llz/ops/sos_carry"),
            (0.5, 0.9, "llz/ops/sosfilt"), (0.6, 0.62, "llz/ops/sos_carry")]
    mod = core.load_module("metrics", "ops.carry_ms")
    assert mod.read(_ctx(host)) == pytest.approx((0.05 + 0.03 + 0.02) / 2
                                                 * 1e3)
    assert mod.read(_ctx(host[:1])) is None  # a program without the span


def test_the_reads_reader_spreads_the_reads_over_the_calls(monkeypatch):
    from llzlab_tpu_torch.runtime import profiler

    mod = core.load_module("metrics", "ops.state_reads")
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Chain.apply": 10}, "state_reads": {"sosfilt": 160}})
    assert mod.read(_ctx()) == 16.0
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Chain.apply": 10}, "traffic_bytes": {}})
    assert mod.read(_ctx()) is None  # a program without the counter
    monkeypatch.delattr(profiler, "counters")
    assert mod.read(_ctx()) is None


def test_the_roofline_reader_is_the_least_time_over_the_busy_time():
    ops = {0: [(0.0, 0.001, "k"), (0.0005, 0.002, "k"), (0.5, 0.501, "m")]}
    got = core.load_module("metrics", "sos.roofline_pct").read(
        _ctx(ops=ops))
    least, _ = roofline_sos.cascade_least_s(
        8, roofline.peaks("NVIDIA H100 80GB HBM3"), 64 * 4096)
    assert got == pytest.approx(100 * least / (0.003 / 2))


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", [
    "portbench/reference_sos.py", "portbench/checks_sos.py",
    "portbench/design_sos.py", "portbench/roofline_sos.py",
    "portbench/control_sos.py", "tests/sos_reference.py"])
def test_the_reference_side_imports_nothing_of_the_program(path):
    got = _imported(os.path.join(ROOT, path))
    assert not got & {"llzlab_tpu_torch", "llzlab_tpu", "jax", "jaxlib"}


@pytest.mark.cuda
def test_a_short_run_at_the_published_widths_on_the_card(cuda_card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELL, "--seed", str(2 ** 31 + 17), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["checks"]["split_bits_differ"]["value"] == 0

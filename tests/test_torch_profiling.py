"""The port's ``utils/profiling.py`` against the JAX package's on the CPU:
the stage timers, the Chrome trace and the roofline report's keys and
arithmetic; a device name without peaks raises in the port."""

import json
import os
import time

import numpy as np
import pytest
import torch

from llzlab_tpu.utils import profiling as rpr
from llzlab_tpu_torch.utils import profiling as ppr


def test_stage_timer_accumulates_on_the_cpu():
    timer = ppr.StageTimer()
    x = torch.ones(4, 8)
    for _ in range(3):
        with timer.stage("add", sync_on=x):
            x = x + 1.0
            time.sleep(0.002)
    out = timer.time_fn("sum", torch.sum, x, dim=-1)
    timer.time_fn("pair", lambda: (x, {"y": x * 2}))
    assert torch.equal(out, torch.full((4,), 32.0))
    assert timer.counts == {"add": 3, "sum": 1, "pair": 1}
    assert timer.totals["add"] >= 0.006
    lines = timer.report().splitlines()
    assert len(lines) == 3 and lines[0].startswith("add") and "x3" in lines[0]


def test_roofline_report_keys_and_values_equal_the_reference():
    kw = dict(seconds=2e-3, flops=4e12 * 2e-3, bytes_moved=1e9 * 2e-3,
              device_kind="cpu")
    got, want = ppr.roofline_report(**kw), rpr.roofline_report(**kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    h100 = ppr.roofline_report(seconds=1e-3, bytes_moved=3.35e12 * 0.5e-3,
                               device_kind="NVIDIA H100 80GB HBM3")
    assert h100["hbm_fraction"] == pytest.approx(0.5)
    assert h100["peak_tflops_bf16"] == 989.0
    # on this machine the default device is the CPU
    if not torch.cuda.is_available():
        assert ppr.roofline_report(seconds=1.0)["peak_gbps"] == 50.0


def test_roofline_report_raises_for_a_device_without_peaks():
    """The JAX package falls back to the "cpu" row in silence; the port
    raises, so a report never stands on another device's peaks."""
    assert rpr.roofline_report(seconds=1.0, device_kind="NVIDIA A100")[
        "peak_gbps"] == rpr.CHIP_PEAKS["cpu"]["hbm_gbps"]
    with pytest.raises(ValueError, match="NVIDIA A100"):
        ppr.roofline_report(seconds=1.0, device_kind="NVIDIA A100")
    assert not [k for k in ppr.CHIP_PEAKS if k.startswith("TPU")]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.from_numpy(np.arange(64, dtype=np.float32))
    with ppr.trace(str(tmp_path / "prof")):
        torch.fft.rfft(x)
    path = tmp_path / "prof" / "trace.json"
    assert os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)

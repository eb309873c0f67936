"""The result line: only the contract's keys, the compared numbers last;
the command's refusals without a card and without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, cpu_run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown",
        "checks"}


@pytest.mark.parametrize("name", ["chan1024.bulk", "fir1ch.stream"])
def test_the_line_has_the_contract_keys_and_the_checks_last(name):
    line = cpu_run(name)
    assert set(line) <= KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    from portbench import core

    want = {m["name"] for m in core.Cell(name).end_to_end} - {
        "peak_mem_gib"}  # a CPU run has no device memory to read
    assert set(line["metrics"]) == want
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_a_traced_line_holds_the_traced_window():
    line = cpu_run("fir1ch.stream", trace=True)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    # no device operation on the CPU, so no per-layer metric and no
    # end-to-end one
    assert line["metrics"] == {}


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "fir1ch.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_without_the_program_the_drivers_do_not_load(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "cache",
                                                  "__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from portbench import "
            "core; core.load_module('drivers', core.Cell('chan1024.bulk')"
            ".wl['driver'])")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "llzlab_tpu_torch" in p.stderr

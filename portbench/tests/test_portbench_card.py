"""On a card: one short run of each one-card cell through the command,
correct, with the contract's line (``pytest -m cuda portbench/tests``)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fir1ch.stream", "chan1024.bulk"])
def test_a_short_run_on_the_card(cuda_card, name):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 17), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"

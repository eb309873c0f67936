"""The benchmark's own tests (``pytest portbench/tests``): on the CPU at
small sizes through the port's plain kernel versions; those marked
``cuda`` need a card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: cells shrunk for the CPU: B1's plain version at a step of 327 680
#: samples (its block multiple), 8 channels
SMALL = {
    "chan1024.bulk": {"channels": 8, "step_samples": 327680,
                      "fir_method": "fused"},
    "chan1024.1x4.rdma": {"channels": 8, "step_samples": 1310720,
                          "fir_method": "fused"},
    "fir1ch.stream": None,
}


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cpu_run(name, seed=2 ** 40 + 3, seconds=0.5, trace=False):
    """One run of a cell at its small size on CPU ranks."""
    import time

    import torch

    from portbench import core

    n = core.Cell(name).chips
    torch.manual_seed(0)
    return core.run_cell(name, seed, seconds, trace,
                         [torch.device("cpu")] * n,
                         t_start=time.perf_counter(), sizes=SMALL[name],
                         say=lambda text: None)

"""Each test worker's BLAS and OpenMP pools fit in its share of the cores.

The root ``conftest.py`` sizes them for pytest-xdist's workers.  This holds the
sizing: a pool of a thread a core in each of six workers on eight cores made
numpy-bound tests run up to fifty times slower in the suite than alone.
Outside xdist the share is the whole machine, so the test runs serially too.
"""

import os

import numpy  # noqa: F401  (its OpenBLAS is loaded before any conftest)
import pytest
import scipy.linalg  # noqa: F401  (its own OpenBLAS, loaded after the conftest)
import torch
from threadpoolctl import threadpool_info


@pytest.mark.parametrize("user_api", ["blas", "openmp"])
def test_pools_fit_in_the_workers_share_of_the_cores(user_api):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    share = max(1, os.cpu_count() // workers)
    pools = {
        p["filepath"]: p["num_threads"]
        for p in threadpool_info()
        if p["user_api"] == user_api
    }
    if user_api == "openmp":
        pools["torch.get_num_threads()"] = torch.get_num_threads()
    assert pools and max(pools.values()) <= share, (share, pools)

"""One share of the cores for the BLAS and OpenMP pools of each test worker.

pytest loads this file before ``tests/conftest.py`` imports JAX and numpy.
Inside a pytest-xdist worker it sizes the pools to
``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` threads: OpenBLAS and OpenMP
otherwise start a thread a core in every worker, and six workers on eight
cores then spin dozens of threads that wait on one another.

The environment variables reach the libraries loaded after this file (scipy's
OpenBLAS, torch's OpenMP pool, and every subprocess a test starts); ``setdefault``
lets a value the caller exported win.  ``threadpool_limits`` reaches those
already loaded: the jaxtyping plugin imports numpy, and with it OpenBLAS,
before any conftest.  The controller and a run without workers keep the
libraries' own pools, and the workers would inherit any value written here.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    from threadpoolctl import threadpool_limits

    _share = str(max(1, os.cpu_count() // int(_workers)))
    for _var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, _share)
    threadpool_limits(
        {
            "blas": int(os.environ["OPENBLAS_NUM_THREADS"]),
            "openmp": int(os.environ["OMP_NUM_THREADS"]),
        }
    )

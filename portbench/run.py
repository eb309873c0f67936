#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell, warms up every shape it uses (set-up), measures for
``--seconds``, checks the kept outputs against the plain reference and
prints one JSON line last on standard output: the end-to-end metrics with
``--trace 0``, the per-layer metrics (from a profiled slice of the window)
with ``--trace 1``.  Exits 2 without printing a result when the cards the
cell asks for are not there, and 3 when a module of JAX or of the JAX
package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: compile caches of any kernel that needs one: fixed directories of the
#: checkout, so that only a checkout's first run compiles.  nvcc's builds
#: of the port go to ``build/kernels/`` (``kernels/_build.py``).
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(HERE, "cache", sub)
    sys.path.insert(0, ROOT)
    from portbench import core

    cell = core.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    line = core.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), devices, t_start=T_START)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What one run of the port's ``channelizer`` tool costs on the GPU: its
wall time, the step's time from the tool's own metrics, the peak device
memory and the host's peak resident memory.

Runs ``llzlab_tpu_torch.cli.channelizer.main`` in this process with the
given tool arguments (``-o`` and ``--metrics`` are supplied here, into a
temporary directory) and prints the card's name and power limit, then
one JSON line.  Needs one CUDA GPU.

    python3 scripts/profile_channelizer_tool_torch.py --synth 1024 \
        --seconds 81.92 --mesh-time 4 --fir-method ols
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import torch

    from llzlab_tpu_torch.cli import channelizer

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    args = list(sys.argv[1:] if argv is None else argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        out, log = os.path.join(tmp, "spec.npz"), os.path.join(tmp, "m.jsonl")
        t0 = time.perf_counter()
        channelizer.main(["-o", out, "--metrics", log] + args)
        wall = time.perf_counter() - t0
        with open(log) as fh:
            step = [json.loads(v) for v in fh if '"stage"' in v]
    print(json.dumps({
        "args": args, "wall_s": wall, "step": step,
        "peak_device_GiB": torch.cuda.max_memory_allocated(0) / 2**30,
        "host_maxrss_GiB":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

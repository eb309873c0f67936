#!/usr/bin/env python3
"""Where one sharded channelizer step of the PyTorch/CUDA port spends its
time on the GPU.

Runs ``Channelizer.sharded_step`` (``llzlab_tpu_torch``) on a 1-D time mesh
whose ranks sit on the current card (or, with ``--cards N``, are dealt
onto the first N cards by ``parallel.mesh.deal_devices``), a few steps
under ``torch.profiler``, and prints the device time of each kernel per
step (summed over the ranks' streams), the device time of each card, the
step's CUDA-event time and the host time to enqueue it; ``--trace PATH``
also writes the timeline.  Needs one CUDA GPU, or N.

    python3 scripts/profile_channelizer_torch.py --method fused --halo rdma
    python3 scripts/profile_channelizer_torch.py --ranks 4 --cards 4 \
        --halo ppermute --trace step_4cards.json
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--method", default="fused", choices=("fused", "block2"))
    ap.add_argument("--halo", default="rdma",
                    choices=("rdma", "rdma_fused", "ppermute"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import torch

    from llzlab_tpu_torch import Channelizer, shard_time
    from llzlab_tpu_torch.kernels.halo_ring import check_exchanges
    from llzlab_tpu_torch.parallel.mesh import (TIME_AXIS, DspMesh,
                                                deal_devices)
    from llzlab_tpu_torch.runtime.platform import require_cuda
    from llzlab_tpu_torch.runtime.profiler import profile_calls

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index or 0]
    chan = Channelizer(fir_method=args.method, device=dev)
    mesh = DspMesh([dev] * args.ranks if args.cards == 1 else
                   deal_devices(args.ranks, args.cards), (TIME_AXIS,))
    t_loc = chan.block_multiple()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((args.channels, args.ranks * t_loc), generator=gen,
                    device=dev)
    parts = shard_time(x, mesh)
    step = chan.sharded_step(mesh, halo=args.halo)
    state = chan.init_state(args.channels)
    for _ in range(2):  # build, tables, allocator
        _, state = step(parts, state)
    check_exchanges(mesh)
    torch.cuda.synchronize()

    def one_step():
        nonlocal state
        _, state = step(parts, state)

    prof = profile_calls(one_step, args.steps, trace=args.trace)
    check_exchanges(mesh)
    if prof is None:
        print("torch.profiler saw no device time", file=sys.stderr)
        return 1
    print(f"[profile] {smi}; fir_method={args.method} halo={args.halo} "
          f"{args.channels} x {args.ranks * t_loc} on {args.ranks} ranks "
          f"({[str(r.device) for r in mesh.ranks]}), {args.steps} steps "
          f"under torch.profiler")
    print(f"[profile] per step: CUDA events {prof.event_ms:.3f} ms, host "
          f"enqueue {prof.host_ms:.3f} ms, kernel time summed over streams "
          f"{prof.busy_ms:.3f} ms; by card "
          f"{ {k: round(v, 3) for k, v in prof.busy_by_device.items()} }")
    for key, ms, count in prof.rows[: args.top]:
        print(f"[profile] {ms:9.3f} ms  {100 * ms / prof.busy_ms:5.1f} %  "
              f"{count:6.1f} launches  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

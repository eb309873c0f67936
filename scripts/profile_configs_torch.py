#!/usr/bin/env python3
"""Where configs 1, 2 and 4 of the PyTorch/CUDA port spend their time on
the GPU: device time against host time.

Config 1 (``configs/fir_lowpass_1ch.json``: 1 x 480 000, 1024 taps) and
config 2 (``configs/resample_8ch.json``: 8 x 480 000, 147/160) are small
for the card, so a call's CUDA-event time can be the host's.  For each path
this runs ``--iters`` calls back to back under ``torch.profiler`` and prints
per call: the device time of its kernels (by name, summed), the CUDA-event
time from the first call's start to the last call's end, the host time to
enqueue it, and the device's idle share (1 - kernel time / event time).
Paths: kernel B2 on the one row (what ``fir_filter`` launches), on the
rows of the JAX package's low-channel fold (L = 1024; ``chip_smoke.py``
``fold_rows``), and the fold with its framing, ``FIRStage.apply`` at the
``fir`` tool's block of 95 232 samples, ``fir_filter`` with ols, direct and
im2col, config 2's ``ResampleStage.apply`` at the ``resample`` tool's
block of 96 000, and config 4's ``SpectralGainStage.apply``
(``configs/stft_gain_256ch.json``: 256 channels, 2048-point frames, hop
512) with each engine at the ``stft`` tool's block of 95 744 and the
tool's gain (-6 dB, a notch over 1-2 kHz).
Needs one CUDA GPU.

    python3 scripts/profile_configs_torch.py [--iters 50] [--top 4]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--top", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from chip_smoke import fold_geometry, fold_rows
    import numpy as np

    from llzlab_tpu_torch import (Chain, FIRStage, ResampleStage,
                                  SpectralGainStage, firwin, resample_taps)
    from llzlab_tpu_torch.kernels import block2_fir as bf
    from llzlab_tpu_torch.ops import fir as fir_ops
    from llzlab_tpu_torch.runtime.platform import require_cuda
    from llzlab_tpu_torch.runtime.profiler import profile_calls
    from llzlab_tpu_torch.utils.config import from_json

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index or 0]

    def config(name):
        with open(os.path.join(ROOT, "configs", name + ".json")) as f:
            return from_json(f.read())

    cfg1, cfg2 = config("fir_lowpass_1ch"), config("resample_8ch")
    cfg4 = config("stft_gain_256ch")
    f1, rc = cfg1.fir, cfg2.resample
    t1 = int(cfg1.sample_rate * cfg1.seconds)
    t2 = int(cfg2.sample_rate * cfg2.seconds)
    taps = firwin(f1.numtaps, f1.cutoff[0], window=f1.window,
                  pass_zero=f1.kind)
    block = fir_ops.block2_block(len(taps))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x1 = torch.randn((cfg1.channels, t1), generator=gen, device=dev)
    x2 = torch.randn((cfg2.channels, t2), generator=gen, device=dev)
    xpad1 = F.pad(x1, (block, 0))
    lw, _ = fold_geometry(cfg1.channels, t1, block)
    rows = fold_rows(xpad1, block, lw)
    chain1 = Chain([FIRStage(taps)])
    m1 = chain1.block_multiple
    blk1 = x1[:, : int(2.0 * cfg1.sample_rate) // m1 * m1]
    st1 = chain1.init_state((cfg1.channels,), device=dev)
    chain2 = Chain([ResampleStage(rc.up, rc.down, taps=resample_taps(
        rc.up, rc.down, rc.taps_per_phase,
        window=("kaiser", rc.kaiser_beta)))])
    m2 = chain2.block_multiple
    blk2 = x2[:, : int(2.0 * cfg2.sample_rate) // m2 * m2]
    st2 = chain2.init_state((cfg2.channels,), device=dev)
    sc, rate4 = cfg4.stft, int(cfg4.sample_rate)
    gain = np.full(sc.n_fft // 2 + 1, 10.0 ** (-6.0 / 20.0), np.float32)
    f = np.arange(gain.size) * rate4 / sc.n_fft
    gain[(f >= 1000.0) & (f <= 2000.0)] = 0.0
    blk4 = torch.randn((cfg4.channels, int(2.0 * rate4) // sc.hop * sc.hop),
                       generator=gen, device=dev)

    def block2_paths(mode):
        return {
            "B2 on the one row":
                lambda: bf.block2_fir_cuda(xpad1, taps, block, mode),
            f"B2 on {rows.shape[0]} fold rows of L = {lw}":
                lambda: bf.block2_fir_cuda(rows, taps, block, mode),
            "the fold with its framing":
                lambda: bf.block2_fir_cuda(fold_rows(xpad1, block, lw), taps,
                                           block, mode).reshape(
                                               cfg1.channels, -1)[:, :t1],
            f"FIRStage.apply at {tuple(blk1.shape)}":
                lambda: chain1.apply(blk1, st1),
        }

    paths = []
    for mode in ("highest", "high"):
        paths += [(mode, name, fn) for name, fn in block2_paths(mode).items()]
    paths += [("f32", f"fir_filter({m})",
               lambda m=m: fir_ops.fir_filter(x1, taps, method=m))
              for m in ("ols", "direct", "im2col")]
    paths.append(("f32", f"ResampleStage.apply at {tuple(blk2.shape)}",
                  lambda: chain2.apply(blk2, st2)))
    for engine in ("reference", "wdft", "cwola"):
        stage = SpectralGainStage(gain, n_fft=sc.n_fft, hop=sc.hop,
                                  window=sc.window, engine=engine)
        st4 = stage.init_state((cfg4.channels,), device=dev)
        paths.append(("f32", f"SpectralGainStage({engine}).apply at "
                      f"{tuple(blk4.shape)}",
                      lambda s=stage, st=st4: s.apply(blk4, st)))

    print(f"[profile] {smi}; config 1 {cfg1.channels} x {t1}, config 2 "
          f"{cfg2.channels} x {t2}, config 4 at {tuple(blk4.shape)}; "
          f"{args.iters} calls back to back per path under torch.profiler")
    before = os.environ.get("LLZ_MATMUL_PRECISION")
    try:
        for mode, name, fn in paths:
            if mode != "f32":
                os.environ["LLZ_MATMUL_PRECISION"] = mode
            for _ in range(3):  # build, tables, allocator
                fn()
            prof = profile_calls(fn, args.iters)
            if prof is None:
                print("torch.profiler saw no device time", file=sys.stderr)
                return 1
            print(f"[profile] {mode:7s} {name}: device {prof.busy_ms:.4f} ms "
                  f"in {prof.kernels + prof.copies:.0f} kernels, CUDA events "
                  f"{prof.event_ms:.4f} ms, host enqueue {prof.host_ms:.4f} "
                  f"ms, idle {prof.idle_pct:.0f} % per call")
            for key, ms, count in prof.rows[: args.top]:
                print(f"[profile]     {ms:8.4f} ms  {count:4.1f} x  "
                      f"{key[:80]}")
    finally:
        if before is None:
            os.environ.pop("LLZ_MATMUL_PRECISION", None)
        else:
            os.environ["LLZ_MATMUL_PRECISION"] = before
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Measure the IIR engines on the GPU and write the card's calibration
artifact, which ``llzlab_tpu_torch.ops.iir_select.sosfilt_auto`` reads to
pick an engine.

The workload is config 3's 8-section peaking EQ
(``configs/iir_eq_64ch.json``) on 64 channels of 94 208 samples, the
``iir`` tool's block (2 s at 48 kHz in whole scan blocks of 4096).  Rows:
the scan engine (``sosfilt``, "f32") and ``sosfilt_matmul`` at "highest"
and "high" (the same fp32 product on the card).  Each row has its SNR
against scipy float64 ``sosfilt`` on the first 8 channels, the rate from
the fastest of ``REPS`` timed runs (``msps``) and their median, the
spread between the slowest and the fastest run (``spread_pct``), and the
calls per run (``scan_iters``: enough for a run of at least
``MIN_SECONDS``).  The engines take turns within each repetition, after
one repetition that is not counted.  A row with a spread of
``MAX_SPREAD_PCT`` or more is noise, not a ranking: then nothing is
written and the script exits 1.  The artifact records the three
constants and the signal's seed.

    python3 scripts/calibrate_iir_torch.py

writes ``llzlab_tpu_torch/calib/<card>.json`` (``LLZ_CALIB_DIR``
overrides the directory).  Needs one CUDA GPU.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the artifact's gate on the run-to-run spread of a row
MAX_SPREAD_PCT = 10.0
#: timed runs of each engine, and the least length of one run
REPS, MIN_SECONDS = 7, 0.5
#: of the signal, ``torch.randn`` on the card
SEED = 0


def main() -> int:
    import scipy.signal as ss
    import torch

    from llzlab_tpu_torch.ops.iir import peaking_eq_sos, sosfilt
    from llzlab_tpu_torch.ops.iir_matmul import sosfilt_matmul
    from llzlab_tpu_torch.ops.iir_select import calib_path
    from llzlab_tpu_torch.runtime.platform import require_cuda
    from llzlab_tpu_torch.utils.config import from_json

    dev = require_cuda()
    kind = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index or 0]
    with open(os.path.join(ROOT, "configs", "iir_eq_64ch.json")) as f:
        cfg = from_json(f.read())
    ic = cfg.iir
    sos = peaking_eq_sos(ic.freqs, ic.gains_db, ic.sample_rate, q=ic.q)
    c = cfg.channels
    t = int(2.0 * cfg.sample_rate) // ic.block_size * ic.block_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((c, t), generator=gen, device=dev)
    z0 = torch.zeros((c, len(sos), 2), device=dev)
    ref = ss.sosfilt(sos, x[:8].double().cpu().numpy(), axis=-1)
    engines = {
        ("scan", "f32"): lambda: sosfilt(sos, x, zi=z0,
                                         block_size=ic.block_size,
                                         return_zf=True),
        ("matmul", "highest"): lambda: sosfilt_matmul(
            sos, x, zi=z0, return_zf=True, precision="highest"),
        ("matmul", "high"): lambda: sosfilt_matmul(
            sos, x, zi=z0, return_zf=True, precision="high"),
    }

    def run_s(fn, n):
        torch.cuda.synchronize()
        gc.disable()
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            gc.enable()

    rows, iters, walls = {}, {}, {}
    for key, fn in engines.items():
        y = fn()[0][:8].double().cpu().numpy()
        err = ref - y
        rows[key] = round(float(10.0 * np.log10(
            np.sum(ref * ref) / np.sum(err * err))), 1)
        n = 1
        while run_s(fn, n) < MIN_SECONDS:
            n *= 2
        iters[key], walls[key] = n, []
    for rep in range(REPS + 1):  # the engines in turns
        for key, fn in engines.items():
            wall = run_s(fn, iters[key])
            if rep:
                walls[key].append(wall)
    measured = []
    for (engine, prec), snr in rows.items():
        w = np.asarray(walls[(engine, prec)])
        msps = c * t * iters[(engine, prec)] / w / 1e6
        measured.append({
            "engine": engine, "precision": prec, "snr": snr,
            "msps": round(float(msps.max()), 1),
            "msps_median": round(float(np.median(msps)), 1),
            "spread_pct": round(100.0 * float((w.max() - w.min())
                                              / w.min()), 1),
            "scan_iters": iters[(engine, prec)],
        })
        print(f"[calib] {json.dumps(measured[-1])}; runs (s): "
              f"{' '.join(f'{v:.4f}' for v in w)}", flush=True)
    art = {
        "device_kind": kind,
        "power_limit": smi.split(",")[-1].strip(),
        "workload": f"8-section peaking-EQ cascade, {c}ch x {t}",
        "channels": c,
        "block": t,
        "sos": "configs/iir_eq_64ch.json",
        "seed": SEED,
        "reps": REPS,
        "min_seconds": MIN_SECONDS,
        "max_spread_pct": MAX_SPREAD_PCT,
        "measured": measured,
    }
    print(f"[calib] {smi}", flush=True)
    bad = [r for r in measured if r["spread_pct"] >= MAX_SPREAD_PCT]
    if bad:
        print(f"[calib] NOT written: spread >= {MAX_SPREAD_PCT} % on {bad}",
              file=sys.stderr)
        return 1
    path = calib_path(kind)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
        f.write("\n")
    print(f"[calib] written: {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

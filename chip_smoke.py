#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llzlab_tpu_torch``) on one GPU.

Drives the port's main path, the headline streaming chain (64 channels,
``firwin(1024, 0.25, hamming)`` FIR into a 147/160 polyphase resampler with
64 taps per phase, 245 760 samples per channel per block), through the
hand-written CUDA kernels, and checks it:

1. device: the GPU's name and power limit; both kernels built with nvcc;
2. each kernel against its plain PyTorch version on the card, at a small
   shape and at the headline shape, in both precision modes;
3. the main path: ``Chain([FusedFirResampleStage(...)])`` streams three
   blocks through kernel B1 (bit-exact against one shot, SNR against a
   scipy float64 golden), then the unfused ``Chain([FIRStage, ResampleStage])``
   through kernel B2; the launch counts of that phase show the kernels ran;
4. CUDA-event times of each kernel and its plain version at the headline
   shape.

Every phase raises on failure.  The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Needs one CUDA GPU; exits non-zero, printing no result, without one.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

NTAPS, CUTOFF, UP, DOWN, K = 1024, 0.25, 147, 160, 64
CHANNELS, BLOCK_T, NBLOCKS = 64, 245760, 3
SMALL = dict(ntaps=129, cutoff=0.2, up=3, down=4, k=8, channels=8)
#: SNR floors of a kernel against its plain version run in float64
KERNEL_FLOOR_DB = {"highest": 130.0, "high": 75.0}
#: all-channel-min SNR floors of the chain against scipy float64
CHAIN_FLOOR_DB = {"highest": 110.0, "high": 80.0}
MODES = ("high", "highest")


def log(msg: str) -> None:
    print(msg, flush=True)


def snr_db(ref, y) -> float:
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(y, np.float64)
    perr = float(np.sum(err * err))
    return float("inf") if perr == 0.0 else \
        10.0 * np.log10(float(np.sum(ref * ref)) / perr)


def min_channel_snr_db(ref, y) -> float:
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(y, np.float64)
    return float(np.min(10.0 * np.log10(
        np.sum(ref * ref, axis=-1) / np.sum(err * err, axis=-1))))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def main() -> int:
    import scipy.signal as ss
    import torch

    from llzlab_tpu_torch import (Chain, FIRStage, FusedFirResampleStage,
                                  ResampleStage, firwin, resample_taps)
    from llzlab_tpu_torch.kernels import _build
    from llzlab_tpu_torch.kernels import block2_fir as bf
    from llzlab_tpu_torch.kernels import fused_fir_resample as ff
    from llzlab_tpu_torch.ops.fir import block2_block
    from llzlab_tpu_torch.runtime.platform import require_cuda

    # ---- phase 1: device and build ------------------------------------
    dev = require_cuda()
    kind = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index or 0]
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi name, power.limit:")
    log(smi)
    t0 = time.perf_counter()
    for name in ("block2_fir", "fused_fir_resample"):
        _build.build(name)
    log(f"[build] block2_fir.cu + fused_fir_resample.cu for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(0)
    errors = {"block2_fir": 0.0, "fused_fir_resample": 0.0}

    # ---- phase 2: kernels against their plain versions -----------------
    def check_kernels(label, ntaps, cutoff, up, down, k, channels, t):
        taps = firwin(ntaps, cutoff, window="hamming")
        rtaps = resample_taps(up, down, k)
        block = block2_block(ntaps)
        x = torch.from_numpy(
            rng.standard_normal((channels, t)).astype(np.float32)).to(dev)
        hist = torch.from_numpy(rng.standard_normal(
            (channels, 2 * block)).astype(np.float32)).to(dev)
        xpad = torch.cat([hist[:, :block], x], dim=-1).contiguous()
        ref_b2 = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
        ref_b1 = ff.fused_fir_resample_plain(x.double(), hist.double(), taps,
                                             up, down, rtaps, "highest")
        for mode in MODES:
            for name, run_kernel, run_plain, ref in (
                ("block2_fir",
                 lambda: bf.block2_fir_cuda(xpad, taps, block, mode),
                 lambda: bf.block2_fir_plain(xpad, taps, block, mode),
                 ref_b2),
                ("fused_fir_resample",
                 lambda: ff.fused_fir_resample_cuda(x, hist, taps, up, down,
                                                    rtaps, mode),
                 lambda: ff.fused_fir_resample_plain(x, hist, taps, up, down,
                                                     rtaps, mode),
                 ref_b1),
            ):
                got = run_kernel()
                torch.cuda.synchronize()
                plain = run_plain()
                if got.shape != plain.shape or not torch.isfinite(got).all():
                    raise RuntimeError(f"{name} {mode} {label}: bad output "
                                       f"{tuple(got.shape)}")
                err = float((got - plain).abs().max())
                snr = snr_db(ref.cpu().numpy(), got.cpu().numpy())
                errors[name] = max(errors[name], err)
                log(f"[kernel] {name} {mode:7s} {label}: max|kernel-plain| "
                    f"{err:.3e}, SNR vs plain f64 {snr:.1f} dB "
                    f"(floor {KERNEL_FLOOR_DB[mode]})")
                if not snr >= KERNEL_FLOOR_DB[mode]:
                    raise RuntimeError(f"{name} {mode} {label}: SNR {snr:.1f}"
                                       f" dB below {KERNEL_FLOOR_DB[mode]}")

    s = SMALL
    check_kernels("small", s["ntaps"], s["cutoff"], s["up"], s["down"],
                  s["k"], s["channels"],
                  3 * ff.fused_program_in(s["ntaps"], s["up"], s["down"]))
    check_kernels("headline", NTAPS, CUTOFF, UP, DOWN, K, CHANNELS, BLOCK_T)

    # ---- phase 3: the main path ----------------------------------------
    taps = firwin(NTAPS, CUTOFF, window="hamming")
    rtaps = resample_taps(UP, DOWN, K)
    x_np = rng.standard_normal(
        (CHANNELS, NBLOCKS * BLOCK_T)).astype(np.float32)
    t0 = time.perf_counter()
    y64 = ss.lfilter(taps, [1.0], x_np.astype(np.float64), axis=-1)
    golden = ss.upfirdn(rtaps, y64, UP, DOWN, axis=-1)
    log(f"[golden] scipy f64 lfilter + upfirdn in "
        f"{time.perf_counter() - t0:.1f} s")
    x_all = torch.from_numpy(x_np).to(dev)
    blocks = [x_all[:, i * BLOCK_T:(i + 1) * BLOCK_T].contiguous()
              for i in range(NBLOCKS)]

    bf.block2_fir_cuda.launches = 0
    ff.fused_fir_resample_cuda.launches = 0
    for mode in MODES:
        chain = Chain([FusedFirResampleStage(
            taps, UP, DOWN, rtaps=rtaps, channels=CHANNELS, device=dev,
            precision=mode)])
        if chain.stages[0].engine != "kernel" or BLOCK_T % chain.block_multiple:
            raise RuntimeError(f"fused stage resolved to "
                               f"{chain.stages[0].engine!r}")
        streamed = torch.cat(list(chain.stream(blocks)), dim=-1)
        one_shot = chain(x_all)
        torch.cuda.synchronize()
        if not torch.equal(streamed, one_shot):
            raise RuntimeError(f"fused chain {mode}: streamed != one-shot")
        z = streamed.cpu().numpy()
        snr = min_channel_snr_db(golden[:, :z.shape[1]], z)
        log(f"[chain] fused {mode:7s}: {NBLOCKS} blocks of {CHANNELS}x"
            f"{BLOCK_T} -> {tuple(z.shape)}, streamed == one-shot bitwise, "
            f"min-channel SNR vs scipy f64 {snr:.1f} dB "
            f"(floor {CHAIN_FLOOR_DB[mode]})")
        if not snr >= CHAIN_FLOOR_DB[mode]:
            raise RuntimeError(f"fused chain {mode}: SNR {snr:.1f} dB")
    for mode in MODES:
        os.environ["LLZ_MATMUL_PRECISION"] = mode
        chain = Chain([FIRStage(taps, method="block2"),
                       ResampleStage(UP, DOWN, taps=rtaps)])
        z = torch.cat(list(chain.stream(blocks)), dim=-1)
        torch.cuda.synchronize()
        z = z.cpu().numpy()
        snr = min_channel_snr_db(golden[:, :z.shape[1]], z)
        log(f"[chain] unfused {mode:7s}: FIRStage(block2) + ResampleStage -> "
            f"{tuple(z.shape)}, min-channel SNR vs scipy f64 {snr:.1f} dB "
            f"(floor {CHAIN_FLOOR_DB[mode]})")
        if not (np.isfinite(z).all() and snr >= CHAIN_FLOOR_DB[mode]):
            raise RuntimeError(f"unfused chain {mode}: SNR {snr:.1f} dB")
    os.environ.pop("LLZ_MATMUL_PRECISION")
    launches = {"block2_fir": bf.block2_fir_cuda.launches,
                "fused_fir_resample": ff.fused_fir_resample_cuda.launches}
    log(f"[chain] kernel launches in the main-path phase: {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the main path never ran: {launches}")

    # ---- phase 4: times at the headline shape --------------------------
    block = block2_block(NTAPS)
    x = blocks[0]
    hist = torch.zeros((CHANNELS, 2 * block), device=dev)
    xpad = torch.cat([hist[:, :block], x], dim=-1).contiguous()
    samples = CHANNELS * BLOCK_T
    times = {}
    for mode in MODES:
        for name, kern, plain in (
            ("block2_fir",
             lambda: bf.block2_fir_cuda(xpad, taps, block, mode),
             lambda: bf.block2_fir_plain(xpad, taps, block, mode)),
            ("fused_fir_resample",
             lambda: ff.fused_fir_resample_cuda(x, hist, taps, UP, DOWN,
                                                rtaps, mode),
             lambda: ff.fused_fir_resample_plain(x, hist, taps, UP, DOWN,
                                                 rtaps, mode)),
        ):
            # plain, kernel, kernel, plain: compare only within one run
            p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kern, kern, plain))
            ms, pms = float(np.median([k1, k2])), float(np.median([p1, p2]))
            times[(name, mode)] = (ms, pms)
            log(f"[time] {name} {mode:7s} {CHANNELS}x{BLOCK_T}: kernel "
                f"{ms:.3f} ms/step ({samples / ms / 1e3:.0f} Msamples/s), "
                f"plain {pms:.3f} ms/step ({samples / pms / 1e3:.0f} "
                f"Msamples/s) on {smi}")

    sources = {
        "block2_fir": ("llzlab_tpu_torch/csrc/block2_fir.cu",
                       "llzlab_tpu/kernels/block2_fir.py:135"),
        "fused_fir_resample": ("llzlab_tpu_torch/csrc/fused_fir_resample.cu",
                               "llzlab_tpu/kernels/fused_fir_resample.py:202"),
    }
    kernels = []
    for name in ("fused_fir_resample", "block2_fir"):
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": times[(name, "highest")][0],
            "plain_ms": times[(name, "highest")][1],
            "ms_high": times[(name, "high")][0],
            "plain_ms_high": times[(name, "high")][1],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

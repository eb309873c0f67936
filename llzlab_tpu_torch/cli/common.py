"""Shared CLI plumbing (port of ``llzlab_tpu/cli/common.py``): WAV in →
streamed ``Chain`` → WAV out.

Parse args → read the WAV → push super-blocks through ``chain.apply`` with
the state carried → write the WAV.  The chain runs on the current CUDA
device (``require_cuda``: no card is an error, never a quiet fall back to
the CPU) unless ``--cpu`` is given.  PyTorch runs eagerly, so the blocks go
through ``chain.apply`` as it is.  Checkpoint/resume at block granularity
through ``utils/checkpoint.py`` (the JAX package's file format), JSONL
metrics through ``utils/metrics.py``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from llzlab_tpu_torch.io.wav import read_wav, write_wav
from llzlab_tpu_torch.runtime.platform import require_cuda
from llzlab_tpu_torch.utils.checkpoint import load_state, save_state
from llzlab_tpu_torch.utils.metrics import MetricsLogger, config_hash

__all__ = ["add_io_args", "run_chain_tool"]


def add_io_args(p: argparse.ArgumentParser):
    p.add_argument("--input", "-i", required=True, help="input WAV")
    p.add_argument("--output", "-o", required=True, help="output WAV")
    p.add_argument("--block-seconds", type=float, default=2.0,
                   help="super-block length fed per step")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--checkpoint", default=None,
                   help="state checkpoint path (.npz); written per block")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    return p


def run_chain_tool(args, chain, *, out_rate_fn=lambda r: r, tool: str):
    """Stream a WAV through ``chain`` with state carry and optional
    checkpoint/resume.  Returns (out_path, Msamples/s)."""
    dev = torch.device("cpu") if args.cpu else require_cuda()
    x, rate = read_wav(args.input)
    c, t = x.shape
    m = chain.block_multiple
    blk = max(int(args.block_seconds * rate) // m, 1) * m
    log = MetricsLogger(args.metrics, echo=True)
    chash = config_hash({"tool": tool, "blk": blk, "rate": rate})
    log.event("start", tool=tool, channels=c, samples=t, rate=rate,
              block=blk, config=chash, device=str(dev))

    state = chain.init_state((c,), device=dev)
    start_block = 0
    if args.resume and args.checkpoint:
        state, start_block, _ = load_state(args.checkpoint, like=state)
        log.event("resume", block=start_block)

    outs = []
    n_blocks = -(-t // blk)
    total_in = 0
    t0 = time.perf_counter()
    for bi in range(start_block, n_blocks):
        seg = x[:, bi * blk : (bi + 1) * blk]
        pad = blk - seg.shape[-1]  # zero-pad the tail block, trim after
        if pad:
            seg = np.pad(seg, ((0, 0), (0, pad)))
        y, state = chain.apply(torch.from_numpy(seg).to(dev), state)
        y = y.cpu().numpy()
        if pad:
            y = y[..., : y.shape[-1] * (blk - pad) // blk]
        outs.append(y)
        total_in += blk - pad
        if args.checkpoint:
            save_state(args.checkpoint, state, block_index=bi + 1,
                       config_hash=chash)
    dt = time.perf_counter() - t0
    y_all = np.concatenate(outs, axis=-1) if outs else np.zeros((c, 0))
    write_wav(args.output, y_all.astype(np.float32), int(out_rate_fn(rate)))
    msps = c * total_in / dt / 1e6 if dt > 0 else 0.0
    log.event("done", out_samples=y_all.shape[-1], seconds=round(dt, 3),
              msps=round(msps, 2))
    return args.output, msps

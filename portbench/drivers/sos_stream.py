"""Drives ``Chain([SOSStage])`` (``pipeline/chain.py``, the cascade of
``ops/iir.py``'s blockwise scan, as the port's ``iir`` tool builds it) as
a live stream of a multichannel EQ: one caller hands each block of every
channel to the chain in host memory, with the state carried, and takes
its output back to host memory before the next block.  The channels'
signals are made in host memory from the seed and cycled as one
continuing stream; each block is cut from them by index modulo their
length (a tiled period would take gigabytes).

The steps are ``chain_stream.py``'s own (its ``Driver``, which this one
extends), so a block's latency, the spans ``portbench.to_device``,
``Chain.apply`` and ``portbench.to_host``, and the kept blocks are taken
as there: two CUDA events on the card's stream, the first as the call
starts (the stream is idle then) and the second once the output is in
host memory.

Its check (:func:`check`) compares the kept blocks with the float64
reference (``checks_sos.py``) and the window's first blocks, bit for
bit, with the program's own ``sosfilt`` of them in one call: the
configuration's guarantee, a stream cut at multiples of the scan block
resumes bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from llzlab_tpu_torch.ops.iir import sosfilt
from llzlab_tpu_torch.pipeline.chain import Chain, SOSStage

from portbench import checks_sos, design_sos
from portbench.drivers import chain_stream


class _Blocks:
    """The blocks of the stream that cycles ``sig``, by index (one cycle
    of blocks long, as ``chain_stream.Driver.step`` indexes them)."""

    def __init__(self, sig: np.ndarray, block: int):
        self.sig, self.block = sig, block
        self.n = sig.shape[1] // np.gcd(block, sig.shape[1])

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        return checks_sos.stream_block(self.sig, i, self.block)


class Driver(chain_stream.Driver):
    """``chain_stream.Driver``'s stream, whose steps, spans, latencies and
    kept blocks it shares, on the EQ's chain and channels; it also keeps
    the window's first ``check.first`` blocks whole."""

    def __init__(self, cfg, wl, seed, devices, spans, sizes=None):
        channels = (sizes or {}).get("channels", cfg["channels"])
        self.cfg = dict(cfg, channels=channels)
        self.wl, self.spans = wl, spans
        self.dev = torch.device(devices[0])
        self.devices = [self.dev]
        self.cuda = self.dev.type == "cuda"
        self.chain = Chain([SOSStage(design_sos.eq_sos(cfg),
                                     block_size=cfg["iir"]["block_size"])])
        self.block = wl["block"]
        if self.block % self.chain.block_multiple:
            raise ValueError(f"a block of {self.block} samples is not a "
                             f"multiple of the chain's "
                             f"{self.chain.block_multiple}")
        self.samples_per_step = channels * self.block
        self.blocks = _Blocks(checks_sos.stream_signal(cfg, wl, seed,
                                                       channels), self.block)
        self.sampled = checks_sos.kept_mask(seed, wl)

    def check_args(self) -> dict:
        return {"channels": self.cfg["channels"], "device": self.dev}


def split_bits_differ(cfg, wl, sig, kept, device) -> int:
    """Samples of the window's first ``check.first`` blocks that are not
    bit for bit the program's ``sosfilt`` of those blocks in one call from
    zero state on ``device``; every sample of them where a kept block is
    missing or of another shape."""
    first, block = wl["check"]["first"], wl["block"]
    x = np.concatenate([checks_sos.stream_block(sig, i, block)
                        for i in range(first)], axis=1)
    want = sosfilt(design_sos.eq_sos(cfg), torch.from_numpy(x).to(device),
                   block_size=cfg["iir"]["block_size"]).cpu()
    got = {i: torch.as_tensor(np.asarray(y)) for i, y in kept if i < first}
    if sorted(got) != list(range(first)) or any(
            v.shape != (x.shape[0], block) or v.dtype != torch.float32
            for v in got.values()):
        return want.numel()
    got = torch.cat([got[i] for i in range(first)], dim=1)
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def check(cfg, wl, seed, kept, channels, device) -> dict:
    """``block_err_max``, each kept block's relative L2 error against the
    float64 reference at its worst, and ``split_bits_differ``."""
    sig = checks_sos.stream_signal(cfg, wl, seed, channels)
    return {"block_err_max": checks_sos.block_err_max(cfg, wl, sig, kept,
                                                       device),
            "split_bits_differ": split_bits_differ(cfg, wl, sig, kept,
                                                   device)}

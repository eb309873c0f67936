"""Drives ``Chain([ResampleStage])`` (``pipeline/chain.py`` →
``ops/resample.py`` ``resample_poly``: the history join, the zero pad,
the ``unfold`` into a slab and the dense polyphase product, as the port's
``resample`` tool builds it) as a live stream of a multichannel
sample-rate converter: one caller hands each block of every channel to
the chain in host memory, with the state (``K − 1`` input samples a
channel) carried, and takes its output back to host memory before the
next block.  The channels' signals are made in host memory from the seed
and cycled as one continuing stream.

A block's latency and the spans ``portbench.to_device``, ``Chain.apply``
and ``portbench.to_host`` are taken as in ``chain_stream.py``, whose
``Driver`` this one extends: two CUDA events on the card's stream, the
first as the call starts (the stream is idle then) and the second once
the output is in host memory.  The caller takes each block's output into
one host buffer of its own, as an audio callback fills its output buffer,
and a block kept for the check is copied out of it after its latency is
taken.  (``chain_stream``'s step keeps a block by holding the host tensor
that ``Tensor.cpu()`` made, so the copy of the block after it lands on
memory the process has not touched yet.  That cost falls on about one
block in 16, past the 95th percentile: on an H100 host, on the same
seeds, ``block_p95_ms`` spread 15 to 23 % from run to run that way and
3 to 6 % with one buffer.)
It keeps the window's first ``check.first`` blocks whole, about one in
``check.every`` drawn from the seed and the last; its check is
``checks_resample.check``."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from llzlab_tpu_torch.ops.resample import resample_output_len
from llzlab_tpu_torch.pipeline.chain import Chain, ResampleStage

from portbench import checks_resample, checks_sos, design
from portbench.checks_resample import check  # noqa: F401  (the harness's)
from portbench.drivers import chain_stream


class Driver(chain_stream.Driver):
    """``chain_stream.Driver``'s stream, whose spans and latencies it
    shares, on the resampler's chain and channels, each output taken into
    the caller's host buffer."""

    def __init__(self, cfg, wl, seed, devices, spans, sizes=None):
        channels = (sizes or {}).get("channels", cfg["channels"])
        self.cfg = dict(cfg, channels=channels)
        self.wl, self.spans = wl, spans
        self.dev = torch.device(devices[0])
        self.devices = [self.dev]
        self.cuda = self.dev.type == "cuda"
        up, down = design.ratio(cfg)
        self.chain = Chain([ResampleStage(up, down,
                                          taps=design.resample_taps(cfg))])
        self.block = wl["block"]
        if self.block % self.chain.block_multiple:
            raise ValueError(f"a block of {self.block} samples is not a "
                             f"multiple of the chain's "
                             f"{self.chain.block_multiple}")
        self.samples_per_step = channels * self.block
        sig = checks_resample.stream_signal(cfg, wl, seed, channels)
        # one period of the cycled stream, in whole blocks
        n = sig.shape[1] // math.gcd(self.block, sig.shape[1])
        self.blocks = np.stack([checks_sos.stream_block(
            sig, i, self.block) for i in range(n)])
        self.sampled = checks_sos.kept_mask(seed, wl)
        self.out = torch.empty(
            (channels, resample_output_len(self.block, up, down)),
            dtype=torch.float32)

    def start(self):
        super().start()
        self.last = None

    def step(self, i: int):
        x = torch.from_numpy(self.blocks[i % len(self.blocks)])
        if self.cuda:
            t0 = torch.cuda.current_stream(self.dev).record_event(
                torch.cuda.Event(enable_timing=True))
        else:
            h0 = time.perf_counter()
        with self.spans("portbench.to_device"):
            x = x.to(self.dev)
        with self.spans("Chain.apply"):
            y, self.state = self.chain.apply(x, self.state)
        with self.spans("portbench.to_host"):
            self.out.copy_(y)
        if self.cuda:
            t1 = torch.cuda.current_stream(self.dev).record_event(
                torch.cuda.Event(enable_timing=True))
            if self.pending is not None:  # done: this block's copy waited
                self.lat_ms.append(self.pending[0].elapsed_time(
                    self.pending[1]))
            self.pending = (t0, t1)
        else:
            self.lat_ms.append((time.perf_counter() - h0) * 1e3)
        if self.sampled[i % len(self.sampled)]:
            self.kept_blocks.append((i, self.out.clone()))
        self.last = i

    def kept(self):
        out = list(self.kept_blocks)
        if not out or out[-1][0] != self.last:
            out.append((self.last, self.out.clone()))
        return out

    def check_args(self) -> dict:
        return {"channels": self.cfg["channels"], "device": self.dev}

"""Drives ``Chain.apply`` (``pipeline/chain.py``) as a live stream: one
caller hands each block to the chain in host memory, with the state
carried, and takes its output back to host memory before the next block,
as the port's ``fir`` tool does.  The signal is made in host memory from
the seed and cycled as one continuing stream.

A block's latency runs from the call with the block in host memory to its
output in host memory: two CUDA events on the card's stream, the first
recorded as the call starts (the stream is idle then, so it completes at
once) and the second once the output is in host memory.  The harness's
copies to and from the card have spans of their own, outside that of
``Chain.apply``."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from llzlab_tpu_torch.pipeline.chain import Chain, FIRStage
from llzlab_tpu_torch.runtime.platform import precision_scope

from portbench import checks, design, signals

CHECK = "stream"


class Driver:
    def __init__(self, cfg, wl, seed, devices, spans, sizes=None):
        self.cfg, self.wl, self.spans = cfg, wl, spans
        self.dev = torch.device(devices[0])
        self.devices = [self.dev]
        self.cuda = self.dev.type == "cuda"
        self.chain = Chain([FIRStage(design.fir_taps(cfg),
                                     method=cfg["fir"]["method"])])
        self.block = wl["block"]
        if self.block % self.chain.block_multiple:
            raise ValueError(f"a block of {self.block} samples is not a "
                             f"multiple of the chain's "
                             f"{self.chain.block_multiple}")
        self.samples_per_step = cfg["channels"] * self.block
        sig = signals.audio(seed, wl["signal_samples"])
        # one period of the cycled stream, cut into whole blocks
        period = self.block * len(sig) // math.gcd(self.block, len(sig))
        stream = np.tile(sig, period // len(sig))
        self.blocks = stream.reshape(-1, cfg["channels"], self.block)
        self.sampled = checks.stream_sampled(seed, wl)

    def scope(self):
        return precision_scope(self.wl["precision"])

    def warmup(self):
        self.start()
        for i in range(self.wl["warmup_blocks"]):
            self.step(i)
        self.finish()

    def start(self):
        self.state = self.chain.init_state((self.cfg["channels"],),
                                           device=self.dev)
        self.kept_blocks = []
        self.lat_ms = []
        self.pending = None
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
            out = y.cpu()
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
            self.kept_blocks.append((i, out))
        self.last = (i, out)

    def finish(self) -> int:
        self.sync()
        if self.pending is not None:
            self.lat_ms.append(self.pending[0].elapsed_time(self.pending[1]))
            self.pending = None
        return 0

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def latencies_ms(self):
        return self.lat_ms

    def kept(self):
        out = list(self.kept_blocks)
        if not out or out[-1][0] != self.last[0]:
            out.append(self.last)
        return out

    def check_args(self) -> dict:
        return {}

    def free(self):
        self.state = None
        self.chain = None

"""Drives ``Chain([SpectralGainStage])`` (``pipeline/chain.py``: frames,
window, cuFFT's r2c, the per-bin gain, cuFFT's c2r, window, overlap-add,
the envelope and the state carry, as the port's ``stft`` tool builds it)
over a stream of the tool's blocks on one card, the state carried from
step to step, closed loop: before it queues step ``s + 1`` the loop waits
for step ``s - 1``, so at most two steps are in flight.  The input blocks
are made on the card from the seed at set-up and taken in turn; the
outputs stay on the card.

It keeps step 0 of the window whole (the stream's start: its leading
zeros and the frames before the start masked), a few channels of every
16th step among the first 128, and the last step whole; its check is
``checks_stft.check``."""

from __future__ import annotations

import collections

import torch

from llzlab_tpu_torch.pipeline.chain import Chain, SpectralGainStage
from llzlab_tpu_torch.runtime.platform import precision_scope

from portbench import checks_stft
from portbench.checks_stft import check  # noqa: F401  (the harness's)


class Driver:
    def __init__(self, cfg, wl, seed, devices, spans, sizes=None):
        sizes = sizes or {}
        self.cfg, self.wl, self.spans = cfg, wl, spans
        self.dev = torch.device(devices[0])
        self.devices = [self.dev]
        self.channels = sizes.get("channels", cfg["channels"])
        self.block = sizes.get("block", wl["block"])
        st = cfg["stft"]
        self.chain = Chain([SpectralGainStage(
            checks_stft.gain(cfg, seed), n_fft=st["n_fft"], hop=st["hop"],
            window=st["window"])])
        if self.block % self.chain.block_multiple:
            raise ValueError(f"a block of {self.block} samples is not a "
                             f"multiple of the chain's "
                             f"{self.chain.block_multiple}")
        self.samples_per_step = self.channels * self.block
        self.inputs = [checks_stft.input_block(cfg, seed, b, self.channels,
                                               self.block, self.dev)
                       for b in range(wl["input_blocks"])]
        sampled = checks_stft.sampled(seed, wl, self.channels)
        self.rows = {s: (r, torch.as_tensor(r, device=self.dev))
                     for s, r in sampled.items()}
        self.slots = {s: torch.empty((len(r), self.block),
                                     dtype=torch.float32, device=self.dev)
                      for s, r in sampled.items()}

    def scope(self):
        return precision_scope(self.wl["precision"])

    def _fresh(self):
        return self.chain.init_state((self.channels,), device=self.dev)

    def warmup(self):
        state = self._fresh()
        for x in self.inputs:
            y, state = self.chain.apply(x, state)
        for s, slot in self.slots.items():
            torch.index_select(y, 0, self.rows[s][1], out=slot)
        self.sync()

    def start(self):
        self.state = self._fresh()
        self.events = collections.deque(maxlen=2)
        self.first = self.last = None

    def step(self, i: int):
        if len(self.events) == 2:
            with self.spans("portbench.wait"):
                self.events[0].synchronize()
        with self.spans("Chain.apply"):
            y, self.state = self.chain.apply(
                self.inputs[i % len(self.inputs)], self.state)
        if i == 0:
            self.first = y
        if i in self.slots:
            torch.index_select(y, 0, self.rows[i][1], out=self.slots[i])
        self.last = (i, y)
        if self.dev.type == "cuda":
            self.events.append(torch.cuda.current_stream(self.dev)
                               .record_event())

    def finish(self) -> int:
        """Wait for every step; the count of failed steps."""
        self.sync()
        return 0

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def kept(self):
        """``[(step, rows or None, output)]``, as ``kept_steps`` lists
        them."""
        last, y = self.last
        out = [(0, None, self.first)] if last > 0 else []
        out += [(s, self.rows[s][0], slot) for s, slot in self.slots.items()
                if s < last]
        return out + [(last, None, y)]

    def check_args(self) -> dict:
        return dict(channels=self.channels, block=self.block,
                    device=self.dev)

    def free(self):
        """Drop the program's state and inputs; the kept outputs stay."""
        self.inputs = self.state = self.events = None
        self.chain = None

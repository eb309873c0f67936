"""Drives ``Channelizer.step`` (``chains/channelizer.py``) over a stream
of super-blocks on one card, the state carried from step to step, closed
loop: before it queues step ``s + 1`` the loop waits for step ``s - 1``,
so at most two steps are in flight.  The input super-blocks are made on
the card from the seed at set-up and taken in turn; the outputs stay on
the card."""

from __future__ import annotations

import collections

import torch

from llzlab_tpu_torch.chains.channelizer import Channelizer
from llzlab_tpu_torch.runtime.platform import precision_scope

from portbench import checks, design, signals

CHECK = "channelizer"


def make_channelizer(cfg: dict, device, fir_method=None) -> Channelizer:
    """The configuration's channelizer; ``fir_method`` replaces the
    configuration's engine (the tests run B1's plain version on the CPU)."""
    up, down = design.ratio(cfg)
    return Channelizer(fir_taps=design.fir_taps(cfg), up=up, down=down,
                       fft_n=cfg["fft_n"],
                       resample_taps=design.resample_taps(cfg),
                       fir_method=fir_method or cfg["fir"]["method"],
                       spec_format=cfg["spec_format"], device=device)


def frame_shape(cfg: dict, samples: int) -> tuple:
    up, down = design.ratio(cfg)
    n = cfg["fft_n"]
    return samples * up // down // n, n // 2 + 1


class Driver:
    def __init__(self, cfg, wl, seed, devices, spans, sizes=None):
        sizes = sizes or {}
        self.cfg, self.wl, self.spans = cfg, wl, spans
        self.dev = torch.device(devices[0])
        self.devices = [self.dev]
        self.channels = sizes.get("channels", cfg["channels"])
        self.samples = sizes.get("step_samples", wl["step_samples"])
        self.chan = make_channelizer(cfg, self.dev,
                                     sizes.get("fir_method"))
        m = self.chan.block_multiple()
        if self.samples % m:
            raise ValueError(f"a step of {self.samples} samples is not a "
                             f"multiple of the chain's {m}")
        self.samples_per_step = self.channels * self.samples
        self.inputs = [signals.noise_block(seed, b, self.channels,
                                           self.samples, self.dev)
                       for b in range(wl["input_blocks"])]
        sampled = checks.channelizer_sampled(seed, wl, self.channels)
        shape = frame_shape(cfg, self.samples)
        self.rows = {s: (r, torch.as_tensor(r, device=self.dev))
                     for s, r in sampled.items()}
        self.slots = {s: torch.empty((len(r),) + shape,
                                     dtype=torch.complex64, device=self.dev)
                      for s, r in sampled.items()}

    def scope(self):
        return precision_scope(self.wl["precision"])

    def warmup(self):
        state = self.chan.init_state(self.channels)
        for x in self.inputs:
            spec, state = self.chan.step(x, state)
        for s, slot in self.slots.items():
            torch.index_select(spec, 0, self.rows[s][1], out=slot)
        self.sync()

    def start(self):
        self.state = self.chan.init_state(self.channels)
        self.events = collections.deque(maxlen=2)
        self.last = None

    def step(self, i: int):
        if len(self.events) == 2:
            with self.spans("portbench.wait"):
                self.events[0].synchronize()
        with self.spans("Channelizer.step"):
            spec, self.state = self.chan.step(
                self.inputs[i % len(self.inputs)], self.state)
        if i in self.slots:
            torch.index_select(spec, 0, self.rows[i][1], out=self.slots[i])
        self.last = (i, spec)
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
        last, spec = self.last
        out = [(s, self.rows[s][0], slot) for s, slot in self.slots.items()
               if s < last]
        return out + [(last, None, spec)]

    def check_args(self) -> dict:
        return dict(channels=self.channels, samples=self.samples,
                    device=self.dev)

    def free(self):
        """Drop the program's state and inputs; the kept outputs stay."""
        self.inputs = self.state = self.events = None
        self.chan = None

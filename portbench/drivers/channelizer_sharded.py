"""Drives ``Channelizer.sharded_step`` (``chains/channelizer.py``) on a
``(time,)`` mesh of ``mesh_time`` ranks, one a card, in one process, with
the workload's halo mode: each super-block is split in time over the
ranks, the state carried on rank 0.  The step itself waits for the step
before the previous one, so at most two are in flight.  After the
window's last step ``kernels.halo_ring.check_exchanges`` reads the
kernels' error words: a halo receive that timed out counts as a failed
step.  The input super-blocks are made on rank 0's card from the seed at
set-up and dealt to the ranks; the outputs stay on the cards."""

from __future__ import annotations

import contextlib

import torch

from llzlab_tpu_torch.kernels.halo_ring import check_exchanges
from llzlab_tpu_torch.parallel.mesh import make_dsp_mesh, shard_time
from llzlab_tpu_torch.runtime.platform import precision_scope

from portbench import checks, signals
from portbench.drivers.channelizer_step import frame_shape, make_channelizer

CHECK = "channelizer"


class Driver:
    def __init__(self, cfg, wl, seed, devices, spans, sizes=None):
        sizes = sizes or {}
        self.cfg, self.wl, self.spans = cfg, wl, spans
        n = wl["mesh_time"]
        self.mesh = make_dsp_mesh(1, n, devices=list(devices)[:n]).row(0)
        self.devices = [r.device for r in self.mesh.ranks]
        self.dev = self.devices[0]
        self.cuda = self.dev.type == "cuda"
        self.channels = sizes.get("channels", cfg["channels"])
        self.samples = sizes.get("step_samples", wl["step_samples"])
        self.chan = make_channelizer(cfg, self.dev,
                                     sizes.get("fir_method"))
        self.chan.validate_sharded_shapes(self.mesh, self.channels,
                                          self.samples)
        self.samples_per_step = self.channels * self.samples
        self.inputs = []
        for b in range(wl["input_blocks"]):
            x = signals.noise_block(seed, b, self.channels, self.samples,
                                    self.dev)
            self.inputs.append(shard_time(x, self.mesh))
            del x
        self.sharded = self.chan.sharded_step(self.mesh, halo=wl["halo"])
        sampled = checks.channelizer_sampled(seed, wl, self.channels)
        f, bins = frame_shape(cfg, self.samples // n)
        self.rows = {s: (r, [torch.as_tensor(r, device=d)
                             for d in self.devices])
                     for s, r in sampled.items()}
        self.slots = {s: [torch.empty((len(r), f, bins),
                                      dtype=torch.complex64, device=d)
                          for d in self.devices]
                      for s, r in sampled.items()}

    def scope(self):
        return precision_scope(self.wl["precision"])

    def warmup(self):
        state = self.chan.init_state(self.channels, device=self.dev)
        for parts in self.inputs:
            spec, state = self.sharded(parts, state)
        self._keep_rows(spec, next(iter(self.slots), None))
        self.finish()

    def _keep_rows(self, spec, s):
        if s is None:
            return
        for part, rows, slot in zip(spec, self.rows[s][1], self.slots[s]):
            with torch.cuda.device(part.device) if self.cuda \
                    else contextlib.nullcontext():
                torch.index_select(part, 0, rows, out=slot)

    def start(self):
        self.state = self.chan.init_state(self.channels, device=self.dev)
        self.last = None

    def step(self, i: int):
        with self.spans("Channelizer.sharded_step"):
            spec, self.state = self.sharded(
                self.inputs[i % len(self.inputs)], self.state)
        if i in self.slots:
            self._keep_rows(spec, i)
        self.last = (i, spec)

    def finish(self) -> int:
        """Wait for every step and read the exchanges' error words; the
        count of failed steps."""
        try:
            check_exchanges(self.mesh)
            failed = 0
        except RuntimeError as exc:
            print(f"halo exchange failed: {exc}", flush=True)
            failed = 1
        self.sync()
        return failed

    def sync(self):
        self.mesh.synchronize()

    def kept(self):
        last, spec = self.last
        out = [(s, self.rows[s][0], self._join(slots))
               for s, slots in self.slots.items() if s < last]
        return out + [(last, None, self._join(spec))]

    def _join(self, parts):
        """The ranks' frames joined along the frames, on rank 0's card."""
        return torch.cat([p.to(self.dev) for p in parts], dim=1)

    def check_args(self) -> dict:
        return dict(channels=self.channels, samples=self.samples,
                    device=self.dev)

    def free(self):
        self.inputs = self.state = self.sharded = None
        self.chan = None


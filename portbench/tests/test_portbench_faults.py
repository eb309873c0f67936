"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, every other part of a run driven
on the CPU at a small size, one fault at a time, as each cell can have
it: a step that hands its state back unchanged, half of the channels (or
half of a block) left out, the exchange between ranks left out, and one
output value altered where it is produced."""

import pytest
import torch

from conftest import cpu_run
from llzlab_tpu_torch.chains import channelizer as chan_mod
from llzlab_tpu_torch.chains.channelizer import Channelizer
from llzlab_tpu_torch.pipeline.chain import FIRStage


def _spec_fault(spec, fault):
    if fault == "half":
        spec[spec.shape[0] // 2:] = 0
    elif fault == "altered":
        spec[0, 0, 5] += 1.0
    return spec


def break_step(monkeypatch, fault):
    step = Channelizer.step

    def broken(self, x, state):
        spec, new = step(self, x, state)
        return _spec_fault(spec, fault), (state if fault == "state" else new)

    monkeypatch.setattr(Channelizer, "step", broken)


def break_sharded(monkeypatch, fault):
    if fault == "exchange":
        ring = chan_mod.left_halo_ring

        def no_exchange(xs, h, mesh, first_shard_value=None):
            halos = ring(xs, h, mesh, first_shard_value=first_shard_value)
            return [halos[0]] + [torch.zeros_like(v) for v in halos[1:]]

        monkeypatch.setattr(chan_mod, "left_halo_ring", no_exchange)
        return
    make = Channelizer.sharded_step

    def broken_make(self, mesh, **kw):
        step = make(self, mesh, **kw)

        def broken(parts, state):
            spec, new = step(parts, state)
            spec = [_spec_fault(p, fault) for p in spec]
            return spec, (state if fault == "state" else new)

        return broken

    monkeypatch.setattr(Channelizer, "sharded_step", broken_make)


def break_stream(monkeypatch, fault):
    apply = FIRStage.apply

    def broken(self, x, state):
        y, new = apply(self, x, state)
        y = y.clone()
        if fault == "half":
            y[..., y.shape[-1] // 2:] = 0
        elif fault == "altered":
            y[..., 100] += 0.01
        return y, (state if fault == "state" else new)

    monkeypatch.setattr(FIRStage, "apply", broken)


CASES = [("chan1024.bulk", f, break_step)
         for f in ("state", "half", "altered")] + \
    [("chan1024.1x4.rdma", f, break_sharded)
     for f in ("state", "half", "exchange", "altered")] + \
    [("fir1ch.stream", f, break_stream) for f in ("state", "half",
                                                  "altered")]


@pytest.mark.parametrize("name,fault,brk", CASES,
                         ids=[f"{n}-{f}" for n, f, _ in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault, brk):
    brk(monkeypatch, fault)
    line = cpu_run(name, seconds=1.0)
    assert line["attempted"] >= 2
    assert line["correct"] is False, (fault, line["checks"])

"""The reader of ``kernels.wola_gain_share``: the frame-map kernel's
launches over the calls of ``Chain.apply``, and nothing for a program
without the kernel or its counters."""

from portbench import core
from portbench.tests.test_portbench_sos import _ctx


def test_the_share_reader_spreads_the_launches_over_the_calls(monkeypatch):
    from llzlab_tpu_torch.runtime import profiler

    mod = core.load_module("metrics", "kernels.wola_gain_share")
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
        "kernels (kernels/, csrc/)", "launches", "throughput_msps")
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Chain.apply": 8},
        "launches": {"sos_scan": {"launches": 3},
                     "wola_gain": {"launches": 8}}})
    assert mod.read(_ctx()) == 1.0
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Chain.apply": 8}, "launches": {"sos_scan": {"launches": 3}}})
    assert mod.read(_ctx()) is None  # a program without the kernel
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {}, "launches": {"wola_gain": {"launches": 0}}})
    assert mod.read(_ctx()) is None  # no step run
    monkeypatch.delattr(profiler, "counters")
    assert mod.read(_ctx()) is None

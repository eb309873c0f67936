"""The reader of ``kernels.sos_scan_share``: the scan kernel's launches
over the calls of ``Chain.apply``, and nothing for a program without the
kernel or its counters."""

from portbench import core
from portbench.tests.test_portbench_sos import _ctx


def test_the_share_reader_spreads_the_launches_over_the_calls(monkeypatch):
    from llzlab_tpu_torch.runtime import profiler

    mod = core.load_module("metrics", "kernels.sos_scan_share")
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Chain.apply": 10},
        "launches": {"B2": {"launches": 3}, "sos_scan": {"launches": 10}}})
    assert mod.read(_ctx()) == 1.0
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Chain.apply": 10}, "launches": {"B2": {"launches": 3}}})
    assert mod.read(_ctx()) is None  # a program without the kernel
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {}, "launches": {"sos_scan": {"launches": 0}}})
    assert mod.read(_ctx()) is None  # no block streamed
    monkeypatch.delattr(profiler, "counters")
    assert mod.read(_ctx()) is None

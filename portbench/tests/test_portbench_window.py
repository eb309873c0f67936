"""The end-to-end arithmetic: a rate over the whole window and all its
work, a tail over every block, on synthetic timings with a stall."""

import time

import pytest

from portbench import core
from portbench.trace import Spans, Trace

STALL_S = 0.3


class FakeDriver:
    """Steps of 1 ms, one of which stalls; latencies as a driver keeps
    them."""

    samples_per_step = 4096

    def __init__(self):
        self.lat = []

    def sync(self):
        pass

    def step(self, i):
        t = STALL_S if i == 5 else 0.001
        time.sleep(t)
        self.lat.append(t * 1e3)

    def finish(self):
        return 0


def test_the_rate_is_over_every_step_and_the_whole_window():
    drv = FakeDriver()
    steps, window_s, failed, _ = core.measure(drv, Spans(False), 0.5)
    assert failed == 0 and steps == len(drv.lat) >= 6
    assert window_s >= 0.5 and window_s >= sum(drv.lat) / 1e3
    w = core.Window(seconds=window_s, samples=steps * 4096, cards=1,
                    setup_s=1.0, peak_bytes=0, latencies_ms=drv.lat)
    rate = core.END_TO_END["throughput_msps"](w)
    assert rate == pytest.approx(steps * 4096 / window_s / 1e6)
    # the stall is in the window: the rate is below that of 1 ms steps
    assert rate < 4096 / 0.001 / 1e6 * 0.8


def test_the_tail_is_over_every_block():
    p95 = core.END_TO_END["block_p95_ms"]
    lat = [1.0] * 95 + [300.0] * 5
    assert p95(core.Window(latencies_ms=lat)) == 1.0
    lat = [1.0] * 94 + [300.0] * 6
    assert p95(core.Window(latencies_ms=lat)) == 300.0
    assert p95(core.Window(latencies_ms=[])) is None


def test_a_traced_slice_runs_to_its_end():
    class Prof:
        started = stopped = False

        def start(self):
            self.started = True

        def stop(self):
            self.stopped = True

    prof = Prof()
    steps, _, _, got = core.measure(FakeDriver(), Spans(True), 0.0,
                                    (2, 12), lambda: prof)
    assert steps == 12 and got is prof and prof.started and prof.stopped


def test_busy_time_is_a_union_and_idle_gaps_are_named():
    ops = {0: [(0.0, 0.4, "k1"), (0.2, 0.5, "k2"), (0.7, 0.8, "k1")]}
    host = [(0.0, 1.0, "portbench.step"), (0.55, 0.65, "wait")]
    tr = Trace(ops, host, (0.0, 1.0), steps=2)
    assert tr.busy_s(0) == pytest.approx(0.6)
    assert tr.gaps(0) == [(0.5, 0.7), (0.8, 1.0)]
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "k1"
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"wait": 0.2, "portbench.step": 0.2})

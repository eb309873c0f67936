"""The self time of the program's spans (``program_spans.py``) and the
four readers of the program's spans and counters, on synthetic traces:
nested spans, a span with no children, aten events that are not
subtracted, a program without spans or counters."""

import types

import pytest

from portbench import core
from portbench.program_spans import self_s
from portbench.trace import Trace

#: two blocks of a stream: request, stage, op, kernel launch, with aten
#: events among them and one op span with no child
HOST = [
    (0.0, 10.0, "portbench.step"),
    (0.5, 9.5, "llz/pipeline/Chain.apply"),
    (1.0, 9.0, "llz/pipeline/FIRStage"),
    (2.0, 8.0, "llz/ops/fir_filter"),
    (2.5, 3.5, "aten::cat"),
    (4.0, 7.0, "llz/kernels/B2"),
    (4.5, 5.0, "aten::empty"),
    (5.0, 6.0, "llz/kernels/build"),
    (10.0, 20.0, "portbench.step"),
    (11.0, 19.0, "llz/pipeline/Chain.apply"),
    (12.0, 18.0, "llz/ops/fir_filter"),
    (12.5, 13.0, "aten::slice"),
    (14.0, 14.5, "llz/ops/rfft"),
]


@pytest.mark.parametrize("names,inner,want", [
    # 6 less B2's 3; 6 less the nested rfft's 0.5
    ("llz/ops/", "llz/", (3.0 + 5.5 + 0.5, 3)),
    # B2 less the build inside it; the build has no child
    ("llz/kernels/", "llz/", (2.0 + 1.0, 2)),
    ("llz/kernels/B2", "llz/", (2.0, 1)),
    # the stage less fir_filter, whose children are inside it
    ("llz/pipeline/FIRStage", "llz/", (2.0, 1)),
    # only the spans named by inner are taken off
    ("llz/pipeline/Chain.apply", "llz/kernels/B2", (9.0 - 3.0 + 8.0, 2)),
    (("llz/ops/rfft", "llz/kernels/build"), "llz/", (1.5, 2)),
    ("llz/chains/", "llz/", (0.0, 0)),
])
def test_self_time_takes_off_the_nested_spans_only(names, inner, want):
    got, count = self_s(HOST, names, inner)
    assert (got, count) == (pytest.approx(want[0]), want[1])


def test_children_that_overlap_are_taken_off_once():
    host = [(0.0, 10.0, "llz/chains/Channelizer.step"),
            (1.0, 4.0, "llz/parallel/rows"), (2.0, 3.0, "llz/kernels/B1"),
            (2.5, 5.0, "llz/ops/rfft"), (6.0, 7.0, "llz/chains/frames"),
            (6.0, 7.0, "aten::fft_r2c")]
    assert self_s(host, "llz/chains/Channelizer.step") == (
        pytest.approx(10.0 - 4.0 - 1.0), 1)


def _ctx(host, steps, cards=(0,)):
    return core.Context(trace=Trace({}, host, (0.0, 20.0), steps),
                        cards=list(cards), steps=steps)


@pytest.mark.parametrize("metric,want", [
    ("ops.host_ms", (3.0 + 5.5 + 0.5) / 2 * 1e3),
    ("kernels.enqueue_ms", 3.0 / 2 * 1e3),
])
def test_the_stream_readers_read_self_time_a_block(metric, want):
    got = core.load_module("metrics", metric).read(_ctx(HOST, 2))
    assert got == pytest.approx(want)


def test_the_channelizer_reader_takes_off_the_wait_for_the_step_before():
    host = [(0.0, 10.0, "llz/chains/Channelizer.sharded_step"),
            (1.0, 2.0, "llz/parallel/fork"),
            (8.0, 9.5, "llz/parallel/wait_previous"),
            (10.0, 14.0, "llz/chains/Channelizer.step"),
            (11.0, 12.0, "llz/chains/frames")]
    got = core.load_module("metrics", "chains.host_ms").read(_ctx(host, 2))
    assert got == pytest.approx((10.0 - 1.5 + 4.0) / 2 * 1e3)


@pytest.mark.parametrize("metric", ["ops.host_ms", "kernels.enqueue_ms",
                                    "chains.host_ms"])
def test_a_program_without_spans_gives_nothing(metric):
    host = [(0.0, 10.0, "Chain.apply"), (1.0, 2.0, "aten::slice"),
            (0.0, 10.0, "Channelizer.sharded_step")]
    assert core.load_module("metrics", metric).read(_ctx(host, 2)) is None


def test_the_exchange_reader_spreads_the_bytes_over_the_calls(monkeypatch):
    from llzlab_tpu_torch.runtime import profiler

    mod = core.load_module("metrics", "mesh.exchange_mb")
    ctx = _ctx([], 2)
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Channelizer.sharded_step": 4, "Chain.apply": 9},
        "traffic_bytes": {"collective-permute": 8_000_000,
                          "all-to-all": 2_000_000}})
    assert mod.read(ctx) == pytest.approx(2.5)
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": {"Chain.apply": 9}, "traffic_bytes": {}})
    assert mod.read(ctx) is None
    monkeypatch.delattr(profiler, "counters")  # as a program without it
    assert mod.read(ctx) is None

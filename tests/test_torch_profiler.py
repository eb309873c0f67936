"""``runtime/profiler.py`` on the CPU: the program's spans under
``torch.profiler`` (names, nesting, the request's sequence number, the
operator's Chrome trace), that no profiler range is entered while no
profiler runs, the counters
against ``collective_traffic`` and from shapes (the resampler's samples
and slab bytes), and ``profile_calls``' arithmetic on
synthetic device intervals (a card's busy time is the union of its
intervals, user annotations are not device work, idle is a mean over
cards)."""

import contextlib
import json
import types

import pytest
import torch

from llzlab_tpu_torch.chains.channelizer import Channelizer
from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.ops.fir import firwin
from llzlab_tpu_torch.ops.iir import peaking_eq_sos
from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh, shard_time
from llzlab_tpu_torch.parallel.sharded_ops import sosfilt_sharded
from llzlab_tpu_torch.ops.resample import resample_poly
from llzlab_tpu_torch.pipeline.chain import (Chain, FIRStage, ResampleStage,
                                             SOSStage)
from llzlab_tpu_torch.runtime import profiler
from llzlab_tpu_torch.utils.profiling import collective_traffic, trace

#: the small channelizer of ``tests/test_torch_channelizer.py``
CHAN = dict(fir_taps=firwin(256, 0.4), fft_n=128, up=3, down=4,
            taps_per_phase=8, device="cpu")


def _chain():
    chain = Chain([FIRStage(firwin(129, 0.25), method="block2")])
    return chain, chain.init_state((2,), device="cpu"), torch.randn(2, 1024)


#: three peaking sections, the scan in blocks of 256
SOS = peaking_eq_sos([100, 1000, 8000], [3, -4, 5], 48000.0)


def _sos_chain():
    """An IIR chain, a state carried into it, and two blocks of input."""
    chain = Chain([SOSStage(SOS, block_size=256)])
    state = tuple(torch.randn(s.shape) for s in chain.init_state(
        (2,), device="cpu"))
    return chain, state, torch.randn(2, 512)


def _sharded(method="block2", halo="rdma"):
    """A sharded step on a CPU mesh of 4 ranks, its parts and state."""
    chan = Channelizer(fir_method=method, **CHAN)
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,))
    t_loc = -(-512 // chan.block_multiple()) * chan.block_multiple()
    parts = shard_time(torch.randn(8, 4 * t_loc), mesh)
    return chan.sharded_step(mesh, halo=halo), parts, chan.init_state(8)


def _spans(prof):
    """``[(start, end, name)]`` of the program's spans, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("llz/"))


def _inside(spans, outer, inner, every=all):
    """Every span ``inner`` (or, with ``every=any``, one) lies inside a
    span ``outer``."""
    outs = [(s, e) for s, e, n in spans if n == outer]
    ins = [(s, e) for s, e, n in spans if n == inner]
    return bool(ins) and every(any(os <= s and e <= oe for os, oe in outs)
                               for s, e in ins)


def test_a_chain_block_records_its_spans_nested():
    chain, state, x = _chain()
    with torch.profiler.profile() as prof:
        chain.apply(x, state)
    spans = _spans(prof)
    assert [n for _, _, n in spans] == [
        "llz/pipeline/Chain.apply", "llz/pipeline/FIRStage",
        "llz/ops/fir_filter"]
    assert _inside(spans, "llz/pipeline/Chain.apply",
                   "llz/pipeline/FIRStage")
    assert _inside(spans, "llz/pipeline/FIRStage", "llz/ops/fir_filter")


@pytest.mark.parametrize("method", ["ols", "block2", "fused"])
def test_a_channelizer_step_records_its_spans_nested(method):
    chan = Channelizer(fir_method=method, **CHAN)
    state = chan.init_state(8)
    x = torch.randn(8, 4 * chan.block_multiple())
    with torch.profiler.profile() as prof:
        chan.step(x, state)
    spans = _spans(prof)
    names = {n for _, _, n in spans}
    step = "llz/chains/Channelizer.step"
    assert _inside(spans, step, "llz/chains/frames")
    # the overlap-save engine runs rfft too, outside the frames
    assert _inside(spans, "llz/chains/frames", "llz/ops/rfft", any)
    if method != "fused":  # the fused step runs B1's plain version here
        assert _inside(spans, step, "llz/ops/fir_filter")
        assert _inside(spans, step, "llz/ops/resample_poly")
    assert {n.split("/")[1] for n in names} <= set(profiler.LAYERS)


def test_a_sharded_step_records_its_layers_in_the_request():
    step, parts, state = _sharded()
    step(parts, state)
    with torch.profiler.profile() as prof:
        step(parts, state)
    spans = _spans(prof)
    request = "llz/chains/Channelizer.sharded_step"
    for name in ("fork", "rows", "tails", "join"):
        assert _inside(spans, request, f"llz/parallel/{name}"), name
    assert _inside(spans, "llz/parallel/rows", "llz/ops/fir_filter")
    assert _inside(spans, request, "llz/chains/frames")


def test_an_iir_block_records_its_scan_and_carry_spans_nested():
    chain, state, x = _sos_chain()
    with torch.profiler.profile() as prof:
        chain.apply(x, state)
    spans = _spans(prof)
    assert [n for _, _, n in spans] == [
        "llz/pipeline/Chain.apply", "llz/pipeline/SOSStage",
        "llz/ops/sosfilt"] + ["llz/ops/sos_carry"] * len(SOS)
    assert _inside(spans, "llz/pipeline/SOSStage", "llz/ops/sosfilt")
    assert _inside(spans, "llz/ops/sosfilt", "llz/ops/sos_carry")


def _resample_chain():
    """Config 2's chain, a state carried into it, and a block of 8 x 4000."""
    chain = Chain([ResampleStage(147, 160)])
    state = tuple(torch.randn(s.shape) for s in chain.init_state(
        (8,), device="cpu"))
    return chain, state, torch.randn(8, 4000)


def test_a_resampler_block_records_its_weights_and_slab_spans_nested():
    chain, state, x = _resample_chain()
    with torch.profiler.profile() as prof:
        chain.apply(x, state)
    spans = _spans(prof)
    assert [n for _, _, n in spans] == [
        "llz/pipeline/Chain.apply", "llz/pipeline/ResampleStage",
        "llz/ops/resample_poly", "llz/ops/resample_weights",
        "llz/ops/resample_slab"]
    assert _inside(spans, "llz/pipeline/ResampleStage",
                   "llz/ops/resample_poly")
    for inner in ("resample_weights", "resample_slab"):
        assert _inside(spans, "llz/ops/resample_poly", f"llz/ops/{inner}")
    assert not torch.autograd._profiler_enabled()
    assert profiler.span("ops", "resample_slab") is profiler._OFF


def test_a_resampler_block_enters_no_range_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(profiler, "_RecordFunctionFast", refuse)
    chain, state, x = _resample_chain()
    chain.apply(x, state)


@pytest.mark.parametrize("shape,zi,want", [
    # 8 x 4000, the benchmark's block: the joined stream and its pad
    # 8 x 4063 x 4 B each, the slab 8 x 25 groups x 223 x 4 B
    ((8, 4000), True, 438432),
    # 1000 samples: 7 groups, the pad to 6 x 160 + 223 = 1183 samples
    ((2, 3, 1000), False, 4 * 6 * (1063 + 1183 + 7 * 223)),
])
def test_the_resample_counter_adds_samples_and_slab_bytes_from_shapes(
        shape, zi, want):
    x = torch.randn(shape)
    state = torch.randn(shape[:-1] + (63,)) if zi else None
    before = profiler.counters()["resample"]
    resample_poly(x, 147, 160, zi=state, return_zf=zi)
    resample_poly(x, 147, 160, zi=state)
    after = profiler.counters()["resample"]
    assert after["samples"] - before.get("samples", 0) == 2 * x.numel()
    assert after["slab_bytes"] - before.get("slab_bytes", 0) == 2 * want


def test_the_resample_counter_only_rises():
    chain, state, x = _resample_chain()
    seen = [profiler.counters()["resample"]]
    for _ in range(3):
        _, state = chain.apply(x, state)
        seen.append(profiler.counters()["resample"])
    seen[-1]["samples"] = -1  # a snapshot is a copy
    now = profiler.counters()["resample"]
    assert now["samples"] > 0
    for a, b in zip(seen, seen[1:-1] + [now]):
        assert b["samples"] - a.get("samples", 0) == x.numel()
        assert b["slab_bytes"] - a.get("slab_bytes", 0) == 438432


def test_a_resampler_stream_under_a_profiler_is_bitwise_one_without():
    chain, state0, x = _resample_chain()
    blocks = x.repeat(1, 3).chunk(3, dim=-1)  # three blocks of 4000
    want, state = [], state0
    for b in blocks:
        y, state = chain.apply(b, state)
        want.append(y)
    got, state_p = [], state0
    with torch.profiler.profile():
        for b in blocks:
            y, state_p = chain.apply(b, state_p)
            got.append(y)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert torch.equal(state[0], state_p[0])
    # and each block's output is resample_poly's, called plainly
    plain, zi = [], state0[0]
    for b in blocks:
        y, zi = resample_poly(b, 147, 160, taps=chain.stages[0].taps, zi=zi,
                              return_zf=True)
        plain.append(y)
    assert all(torch.equal(a, b) for a, b in zip(want, plain))


def test_the_state_reads_count_two_a_section_a_call():
    chain, state, x = _sos_chain()
    before = profiler.counters()["state_reads"].get("sosfilt", 0)
    chain.apply(x, state)
    chain.apply(x, state)
    after = profiler.counters()["state_reads"]
    assert after["sosfilt"] - before == 2 * 2 * len(SOS)


def test_the_sharded_scan_counts_its_reads_under_its_own_key():
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,))
    parts = shard_time(torch.randn(2, 4 * 512), mesh)
    before = profiler.counters()["state_reads"]
    sosfilt_sharded(parts, SOS, mesh, block_size=256)
    after = profiler.counters()["state_reads"]
    # a zero-state pass and a pass from the composed carry on every rank
    assert after["sosfilt_sharded"] - before.get("sosfilt_sharded", 0) \
        == 2 * 2 * len(mesh) * len(SOS)
    assert after.get("sosfilt", 0) == before.get("sosfilt", 0)


def test_an_iir_block_under_a_profiler_is_bitwise_one_without():
    chain, state, x = _sos_chain()
    y, new = chain.apply(x, state)
    with torch.profiler.profile():
        y_p, new_p = chain.apply(x, state)
    assert torch.equal(y, y_p)
    assert all(torch.equal(a, b) for a, b in zip(new, new_p))


def test_a_request_passes_its_sequence_number(monkeypatch):
    got = []

    def fake(name, inputs=(), keywords=None):
        got.append((name, keywords))
        return contextlib.nullcontext()

    monkeypatch.setattr(profiler, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(profiler, "_RecordFunctionFast", fake)
    chain, state, x = _chain()
    first = profiler.counters()["calls"].get("Chain.apply", 0) + 1
    chain.apply(x, state)
    chain.apply(x, state)
    requests = [a for n, a in got if n == "llz/pipeline/Chain.apply"]
    assert requests == [{"call": first}, {"call": first + 1}]
    assert ("llz/pipeline/FIRStage", None) in got


def test_the_operators_trace_holds_the_spans_and_the_call(tmp_path):
    chain, state, x = _chain()
    with trace(str(tmp_path)):
        chain.apply(x, state)
    first = profiler.counters()["calls"]["Chain.apply"]
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    spans = {e["name"]: e.get("args", {}) for e in events
             if str(e.get("name", "")).startswith("llz/")}
    assert set(spans) == {"llz/pipeline/Chain.apply",
                          "llz/pipeline/FIRStage", "llz/ops/fir_filter"}
    assert spans["llz/pipeline/Chain.apply"]["call"] == first


def test_no_profiler_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    chain, state, x = _chain()
    chain.apply(x, state)
    chan = Channelizer(fir_method="block2", **CHAN)
    chan.step(torch.randn(8, 4 * chan.block_multiple()), chan.init_state(8))
    step, parts, state = _sharded()
    step(parts, state)
    step(parts, state)
    chain, state, x = _sos_chain()
    chain.apply(x, state)
    assert profiler.span("ops", "fir_filter") is profiler._OFF


def test_an_exception_passes_through_a_span_that_is_off():
    with pytest.raises(KeyError):
        with profiler.span("ops", "fir_filter"):
            raise KeyError("out")


@pytest.mark.parametrize("method,halo", [("block2", "rdma"),
                                         ("block2", "ppermute"),
                                         ("fused", "rdma")])
def test_counters_count_the_calls_and_the_bytes_collective_traffic_sees(
        method, halo):
    step, parts, state = _sharded(method, halo)
    before = profiler.counters()
    traffic = collective_traffic(step, parts, state)
    after = profiler.counters()
    entry = "Channelizer.sharded_step"
    assert after["calls"][entry] == before["calls"].get(entry, 0) + 1
    by_kind = {}
    for op in traffic["ops"]:
        by_kind[op["op"]] = by_kind.get(op["op"], 0) + op["bytes"]
    assert traffic["total_bytes"] > 0
    assert {k: after["traffic_bytes"][k] - before["traffic_bytes"].get(k, 0)
            for k in after["traffic_bytes"]
            if after["traffic_bytes"][k] != before["traffic_bytes"].get(k, 0)
            } == by_kind
    # outside a recorder the totals count as well
    step(parts, state)
    again = profiler.counters()
    assert sum(again["traffic_bytes"].values()) - sum(
        after["traffic_bytes"].values()) == traffic["total_bytes"]


def test_counters_read_the_kernels_launches_and_the_builds():
    got = profiler.counters()
    assert set(got) == {"calls", "traffic_bytes", "launches", "builds",
                        "state_reads", "frames", "resample"}
    assert set(got["launches"]) == {"B1", "B2", "B3", "B4", "sos_scan",
                                    "wola_gain"}
    assert got["launches"]["B3"].keys() == {
        "launches", "cross_card_launches", "cross_process_launches",
        "cross_host_launches"}
    base = got["builds"].get("test_only", {"builds": 0, "nvcc_s": 0.0})
    profiler.count_build("test_only", 1.5)
    now = profiler.counters()["builds"]["test_only"]
    assert now == {"builds": base["builds"] + 1,
                   "nvcc_s": base["nvcc_s"] + 1.5}


def test_a_loaded_library_opens_no_build_span(monkeypatch):
    entered = []
    monkeypatch.setattr(profiler, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(profiler, "_RecordFunctionFast",
                        lambda name, *args: entered.append(name)
                        or contextlib.nullcontext())
    monkeypatch.setitem(_build._LIBS, "test_only", object())
    assert _build.load("test_only", lambda lib: None) is \
        _build._LIBS["test_only"]
    assert entered == []


def _event(card, start, end, name="k", annotation=False, cuda=True):
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        device_type=dt.CUDA if cuda else dt.CPU, device_index=card,
        time_range=types.SimpleNamespace(start=start, end=end), name=name,
        is_user_annotation=annotation)


@pytest.mark.parametrize("intervals,length", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),
    ([(0, 10), (5, 15)], 15.0),  # two streams overlap
    ([(0, 30), (5, 10), (12, 20)], 30.0),  # nested
    ([(10, 20), (0, 5), (4, 12)], 20.0),  # out of order, chained
])
def test_busy_time_is_the_union_of_the_intervals(intervals, length):
    assert profiler.union_length(intervals) == length


def test_device_ops_drop_annotations_and_host_events():
    events = [_event(0, 0, 10), _event(0, 5, 15, "copy"),
              _event(0, 0, 100, "llz/kernels/B2", annotation=True),
              _event(1, 2, 4), _event(-1, 0, 50, "aten::cat", cuda=False)]
    ops = profiler.device_ops(events)
    assert ops == {0: [(0, 10, "k"), (5, 15, "copy")], 1: [(2, 4, "k")]}
    assert profiler.union_length((s, e) for s, e, _ in ops[0]) == 15


def test_idle_is_a_mean_over_cards_of_each_cards_union():
    prof = profiler.DeviceProfile(rows=[], kernels=0, copies=0, busy_ms=9.0,
                                  event_ms=10.0, host_ms=1.0,
                                  busy_by_device={0: 8.0, 1: 2.0})
    assert prof.idle_pct == pytest.approx(100.0 * (0.2 + 0.8) / 2)
    over = profiler.DeviceProfile(rows=[], kernels=0, copies=0, busy_ms=25.0,
                                  event_ms=10.0, host_ms=1.0,
                                  busy_by_device={0: 10.0})
    assert over.idle_pct == 0.0

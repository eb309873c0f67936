"""The cells ``rs8ch.stream`` (``drivers/resample_stream.py``) and
``chan1024.block2`` (``drivers/channelizer_route.py``), which run the
port's dense polyphase resampler (``ops/resample.py``): on the CPU, a run
of each is correct (the block2 route on B2's plain version, at 8 channels
and a step of 327 680 samples), and the controls and each planted fault of
the resampler are not; the stream's one output buffer and the copies it
keeps; a kept block's context against the whole stream;
the configuration against its source; the readers of the two
``resample.*`` metrics on synthetic traces and counters, and nothing where
the program has nothing to read; on a card, one short run of each."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from llzlab_tpu_torch.ops import resample as _resample
from llzlab_tpu_torch.pipeline.chain import Chain, ResampleStage
from portbench import checks_resample, checks_sos, control, \
    control_resample, core, design, reference_resample
from portbench.tests.test_portbench_imports import imported
from portbench.trace import Trace

STREAM, BLOCK2 = "rs8ch.stream", "chan1024.block2"
SMALL = {STREAM: None, BLOCK2: {"channels": 8, "step_samples": 327680}}
SEED = 2 ** 41 + 33
H100 = "NVIDIA H100 80GB HBM3"


def run(name, seed=SEED, seconds=0.5):
    """One untraced run of a cell at its small size on the CPU."""
    return core.run_cell(name, seed, seconds, False, [torch.device("cpu")],
                         t_start=time.perf_counter(), sizes=SMALL[name],
                         say=lambda text: None)


def test_the_stream_is_correct_and_keeps_what_the_check_needs():
    line = run(STREAM)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 100  # past block 0 and some sampled ones
    assert line["checks"]["block_err_max"]["value"] < 1e-6
    assert {"block_p95_ms", "setup_s"} == set(line["metrics"])


def test_the_block2_route_is_correct_and_counts_its_slab():
    from llzlab_tpu_torch.runtime import profiler

    before = profiler.counters()["resample"]
    line = run(BLOCK2)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["frame_err_max"]["value"] < 2e-5
    assert {"throughput_msps", "peak_mem_gib", "setup_s"} >= set(
        line["metrics"]) >= {"throughput_msps", "setup_s"}
    after = profiler.counters()["resample"]
    # the warm-up's two steps and the window's, 8 x 327 680 a step: the
    # joined stream and its pad 8 x 327 743 x 4 B each, the slab 8 x
    # 2048 groups x 223 x 4 B
    steps = line["attempted"] + 2
    assert after["samples"] - before.get("samples", 0) == steps * 8 * 327680
    assert after["slab_bytes"] - before.get("slab_bytes", 0) == steps * (
        2 * 8 * 327743 * 4 + 8 * 2048 * 223 * 4)


def test_the_block2_driver_takes_the_workloads_route():
    cell = core.Cell(BLOCK2)
    drv = core.load_module("drivers", cell.wl["driver"]).Driver(
        cell.cfg, cell.wl, 5, [torch.device("cpu")], None,
        {"channels": 2, "step_samples": 327680})
    assert drv.chan.fir_method == "block2" == cell.wl["fir_method"]
    assert cell.cfg["fir"]["method"] == "auto"
    assert cell.wl["step_samples"] % drv.chan.block_multiple() == 0


@pytest.mark.parametrize("seed", [13, 2 ** 33 + 7])
def test_the_stream_control_fails_the_check(seed):
    got = control_resample.run_control(STREAM, seed, 200,
                                       torch.device("cpu"))
    assert got["correct"] is False, got
    c = got["checks"]["block_err_max"]
    assert c["value"] > 10 * c["limit"]


def test_the_block2_control_fails_the_check():
    got = control.run_control(BLOCK2, 17, 3, torch.device("cpu"),
                              SMALL[BLOCK2])
    assert got["rounding"] == "bf16" and got["correct"] is False, got
    c = got["checks"]["frame_err_max"]
    assert c["value"] > 5 * c["limit"]


def _break(monkeypatch, fault):
    """Plant a fault in ``resample_poly``, which both cells run."""
    plain = _resample.resample_poly

    def broken(x, up, down, *, taps=None, zi=None, return_zf=False, **kw):
        if fault == "phase":  # phases 5 and 6 of the prototype swapped
            taps = np.array(taps)
            taps[5::up], taps[6::up] = taps[6::up].copy(), taps[5::up].copy()
        elif fault == "history":  # the history dropped at a block's edge
            zi = torch.zeros_like(zi)
        got = plain(x, up, down, taps=taps, zi=zi, return_zf=return_zf,
                    **kw)
        if fault == "group":  # output group 3 shifted by one sample
            y = (got[0] if return_zf else got).clone()
            y[..., 3 * up:4 * up] = torch.roll(y[..., 3 * up:4 * up], 1, -1)
            got = (y, got[1]) if return_zf else y
        return got

    monkeypatch.setattr(_resample, "resample_poly", broken)


@pytest.mark.parametrize("name", [STREAM, BLOCK2])
@pytest.mark.parametrize("fault", ["phase", "history", "group"])
def test_a_broken_resampler_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, fault)
    # a run's first step starts from a zero history, so a dropped history
    # shows from its second step on: a window long enough for two
    line = run(name, seconds=1.0 if fault == "history" else 0.2)
    assert line["attempted"] >= (2 if fault == "history" else 1)
    assert line["correct"] is False, (fault, line["checks"])


def test_a_kept_blocks_context_gives_the_whole_streams_output():
    cell = core.Cell(STREAM)
    cfg, wl = cell.cfg, dict(cell.wl, signal_samples=16000)
    sig = checks_resample.stream_signal(cfg, wl, 7, 3)
    whole = reference_resample.resample(
        torch.from_numpy(np.concatenate([sig, sig], axis=1)),
        design.resample_taps(cfg), 147, 160)
    got = checks_resample.reference_blocks(cfg, wl, sig, [0, 1, 3, 4, 6],
                                           torch.device("cpu"))
    for n, i in enumerate([0, 1, 3, 4, 6]):
        np.testing.assert_allclose(
            got[n].numpy(), whole[:, i * 3675:(i + 1) * 3675].numpy(),
            rtol=0, atol=1e-12 * float(whole.abs().max()))
    assert checks_resample.history(cfg) == 63


def test_what_a_run_keeps_and_the_signals_from_the_seed():
    wl = core.Cell(STREAM).wl
    mask = checks_sos.kept_mask(5, wl)
    assert mask[0] and 0.04 < mask[:100000].mean() < 0.09
    cfg = core.Cell(STREAM).cfg
    a = checks_resample.stream_signal(cfg, wl, 11, 8)
    assert a.shape == (8, 480000) and a.dtype == np.float32
    assert np.array_equal(a, checks_resample.stream_signal(cfg, wl, 11, 8))
    assert 1.1 < float(a.std()) < 1.6
    assert len({float(r[0]) for r in a}) == 8  # a distinct signal a channel


def test_the_stream_reuses_one_output_buffer_and_copies_what_it_keeps():
    from portbench.trace import Spans

    cell = core.Cell(STREAM)
    drv = core.load_module("drivers", cell.wl["driver"]).Driver(
        cell.cfg, cell.wl, 5, [torch.device("cpu")], Spans(enabled=False),
        {"channels": 2})
    chain = Chain([ResampleStage(147, 160, taps=design.resample_taps(
        cell.cfg))])
    state = chain.init_state((2,), device=torch.device("cpu"))
    want = []
    for i in range(40):
        y, state = chain.apply(torch.from_numpy(drv.blocks[i]), state)
        want.append(y)
    drv.start()
    buf = drv.out.data_ptr()
    for i in range(40):
        drv.step(i)
        assert drv.out.data_ptr() == buf
    kept = drv.kept()
    assert [i for i, _ in kept] == [i for i in range(40) if drv.sampled[i]
                                    ] + ([] if drv.sampled[39] else [39])
    for i, y in kept:
        assert y.untyped_storage().data_ptr() != buf
        assert torch.equal(y, want[i])
    assert len(drv.latencies_ms()) == 40


def test_the_configuration_is_its_source_unchanged():
    entry = core.find(core.benchmark()["configs"], "resample_8ch")
    cfg = core.load_json(os.path.join(ROOT, entry["file"]))
    src = core.load_json(os.path.join(ROOT, "configs", "resample_8ch.json"))
    assert entry["reduced"] == cfg["reduced"] == []
    assert {k: cfg[k] for k in src} == src
    assert len(entry["source"]) <= 200


@pytest.mark.parametrize("name,config,traffic", [
    (STREAM, "resample_8ch", "stream"),
    (BLOCK2, "channelizer_1024ch", "block2")])
def test_the_benchmark_runs_the_cell_on_one_chip(name, config, traffic):
    w = core.find(core.benchmark()["workloads"], name)
    assert (w["config"], w["traffic"], w["chips"]) == (config, traffic, 1)


def _ctx(name, host=(), steps=2):
    cell = core.Cell(name)
    return core.Context(trace=Trace({}, list(host), (0.0, 1.0), steps),
                        cards=[0], steps=steps, cfg=cell.cfg, wl=cell.wl,
                        samples_per_step=8 * 4000, device_name=H100)


def _reader(name):
    return core.load_module("metrics", name).read


def test_the_host_reader_sums_the_nested_spans_alone():
    host = [(0.0, 0.4, "llz/pipeline/Chain.apply"),
            (0.01, 0.39, "llz/pipeline/ResampleStage"),
            (0.02, 0.3, "llz/ops/resample_poly"),
            (0.03, 0.05, "llz/ops/resample_weights"),
            (0.06, 0.1, "llz/ops/resample_slab"), (0.07, 0.08, "aten::cat"),
            (0.5, 0.6, "llz/ops/resample_poly"),
            (0.51, 0.52, "llz/ops/resample_slab")]
    read = _reader("resample.host_ms")
    # the weights 0.02 s, the slabs 0.04 and 0.01 (the aten op inside is
    # their own time), over two blocks; not resample_poly's own time,
    # which ops.host_ms reads
    assert read(_ctx(STREAM, host)) == pytest.approx((0.02 + 0.05) / 2 * 1e3)
    assert _reader("ops.host_ms")(_ctx(STREAM, host)) == pytest.approx(
        (0.28 + 0.1) / 2 * 1e3)
    # a program that marks only resample_poly, as the parent did
    assert read(_ctx(STREAM, [h for h in host if "resample_" not in h[2]
                              or h[2].endswith("poly")])) is None
    assert read(_ctx(STREAM, host[:2])) is None


def test_the_slab_reader_spreads_the_bytes_over_the_steps(monkeypatch):
    from llzlab_tpu_torch.runtime import profiler

    read = _reader("resample.slab_mb")
    calls = {"Channelizer.step": 4, "Chain.apply": 9}
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": calls, "resample": {"samples": 10,
                                     "slab_bytes": 4 * 18220572672}})
    assert read(_ctx(BLOCK2)) == pytest.approx(18220.572672)
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": calls, "resample": {"samples": 10, "slab_bytes": 0}})
    assert read(_ctx(BLOCK2)) == 0.0  # a resampler that makes no slab
    monkeypatch.setattr(profiler, "counters", lambda: {
        "calls": calls, "resample": {}})
    assert read(_ctx(BLOCK2)) is None  # no resampler call
    monkeypatch.setattr(profiler, "counters", lambda: {"calls": calls})
    assert read(_ctx(BLOCK2)) is None  # a program without the counter
    monkeypatch.delattr(profiler, "counters")
    assert read(_ctx(BLOCK2)) is None


def test_the_slab_at_the_cells_step_is_18221_mb():
    """``resample_poly``'s count at the block2 step's shape, 1024 x
    1 310 720 after the FIR: the joined stream and its pad 5 369 MB each,
    the slab 7 483 MB."""
    b, t, halo, down, k2 = 1024, 1310720, 63, 160, 223
    groups = t // down
    joined = 4 * b * (halo + t)
    padded = 4 * b * ((groups - 1) * down + k2)
    slab = 4 * b * groups * k2
    assert (joined, padded, slab) == (5368967168, 5368967168, 7482638336)
    assert (joined + padded + slab) / 1e6 == pytest.approx(18220.57, abs=0.01)


@pytest.mark.parametrize("path", [
    "portbench/reference_resample.py", "portbench/checks_resample.py",
    "portbench/control_resample.py"])
def test_the_reference_side_imports_nothing_of_the_program(path):
    got = imported(os.path.join(ROOT, path))
    assert not got & {"llzlab_tpu_torch", "llzlab_tpu", "jax", "jaxlib"}


@pytest.mark.cuda
@pytest.mark.parametrize("name,metrics", [
    (STREAM, {"block_p95_ms", "setup_s"}),
    (BLOCK2, {"throughput_msps", "peak_mem_gib", "setup_s"})])
def test_a_short_run_at_the_published_widths_on_the_card(cuda_card, name,
                                                         metrics):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 19), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert metrics == set(line["metrics"])

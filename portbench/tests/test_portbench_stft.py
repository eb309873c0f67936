"""The cell ``stft256ch.block`` (``drivers/spectral_block.py``): on the CPU
at 4 channels and blocks of 8192, a run is correct, and the control
(``control_stft.py``) and each planted fault are not; the float64
reference against SciPy's STFT and iSTFT and a kept step's context
against the whole stream; the chain's least time at the cell's shape; the
readers of its four metrics on synthetic traces and counters, and nothing
where the program has nothing to read; on a card, the stage at the
published widths against the reference, and one short run."""

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import scipy.signal as ss
import torch

from conftest import ROOT
from llzlab_tpu_torch.pipeline.chain import Chain, SpectralGainStage
from portbench import checks_stft, control_stft, core, reference_stft, \
    roofline, roofline_stft
from portbench.tests.test_portbench_imports import imported
from portbench.trace import Trace

CELL = "stft256ch.block"
SMALL = {"channels": 4, "block": 8192}
SEED = 2 ** 41 + 21
H100 = "NVIDIA H100 80GB HBM3"


def stft_run(seed=SEED, seconds=1.0):
    """One untraced run of the cell at its small size on the CPU."""
    return core.run_cell(CELL, seed, seconds, False, [torch.device("cpu")],
                         t_start=time.perf_counter(), sizes=SMALL,
                         say=lambda text: None)


def test_a_run_is_correct_and_keeps_what_the_check_needs():
    line = stft_run()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 130  # past every sampled step
    assert line["checks"]["block_err_max"]["value"] < 1e-6
    assert {"throughput_msps", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("seed", [13, 2 ** 33 + 7])
def test_the_control_fails_the_check(seed):
    got = control_stft.run_control(CELL, seed, 40, torch.device("cpu"),
                                   SMALL)
    assert got["correct"] is False, got
    c = got["checks"]["block_err_max"]
    assert c["value"] > 10 * c["limit"]


def _break(monkeypatch, fault):
    apply, init = SpectralGainStage.apply, SpectralGainStage.init_state

    def broken(self, x, state):
        y, new = apply(self, x, state)
        if fault in ("x_hist", "ola"):  # the state not carried
            new = dict(new, **{fault: torch.zeros_like(new[fault])})
        elif fault == "envelope":  # not divided: times the interior's 1.5
            y = y * 1.5
        elif fault == "altered":
            y = y.clone()
            y[0, 1000] += 0.05
        return y, new

    def unmasked(self, batch_shape, *, device, dtype=torch.float32):
        state = init(self, batch_shape, device=device, dtype=dtype)
        return dict(state, pos=torch.full_like(state["pos"], self.latency))

    def bin_dropped(self, spec):
        gain = self._gain_on(spec.device).clone()
        gain[100] = 1.0
        return spec * gain

    if fault == "masking":  # the first step's frames not masked
        monkeypatch.setattr(SpectralGainStage, "init_state", unmasked)
    elif fault == "bin":  # a bin's gain left out
        monkeypatch.setattr(SpectralGainStage, "_apply_gain", bin_dropped)
    else:
        monkeypatch.setattr(SpectralGainStage, "apply", broken)


@pytest.mark.parametrize("fault", ["x_hist", "ola", "envelope", "bin",
                                   "masking", "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    line = stft_run()
    assert line["attempted"] >= 3
    assert line["correct"] is False, (fault, line["checks"])


def test_the_reference_matches_scipys_stft_and_istft():
    """SciPy's iSTFT divides by the window-square envelope where it
    exceeds 1e-10, the reference by its clamp at 1e-8: they differ at
    positions 0 to 6 of the stream only."""
    n_fft, hop = 256, 64
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, hop * 40))
    g = 10.0 ** (rng.uniform(-20.0, 6.0, n_fft // 2 + 1) / 20.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # NOLA at the unpadded ends
        _, _, z = ss.stft(x, window="hann", nperseg=n_fft,
                          noverlap=n_fft - hop, boundary=None, padded=False,
                          detrend=False)
        _, want = ss.istft(z * g[:, None], window="hann", nperseg=n_fft,
                           noverlap=n_fft - hop, boundary=False)
    y = reference_stft.stream(torch.from_numpy(x), g, n_fft, hop).numpy()
    lag = n_fft - hop
    n = x.shape[-1] - lag
    np.testing.assert_allclose(y[:, lag + 7:], want[:, 7:n], rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_a_kept_steps_context_gives_the_whole_streams_output():
    cfg = core.Cell(CELL).cfg
    wl = dict(core.Cell(CELL).wl, input_blocks=2)
    block = 4096
    ref = checks_stft.Reference(cfg, wl, 7, 3, block, torch.device("cpu"))
    whole = reference_stft.stream(torch.cat(ref.inputs * 2, dim=-1),
                                  ref.gain, 2048, 512)
    for i in range(4):
        np.testing.assert_allclose(
            ref.step(i, [0, 2]).numpy(),
            whole[[0, 2], i * block:(i + 1) * block].numpy(), rtol=0,
            atol=1e-9 * float(whole.abs().max()))


def test_what_a_run_keeps():
    wl = core.Cell(CELL).wl
    got = checks_stft.kept_steps(5, wl, 256, 3300)
    steps = [s for s, _ in got]
    assert steps == [0] + list(range(16, 128, 16)) + [3300]
    assert got[0][1] is None and got[-1][1] is None
    assert all(len(r) == 8 and len(set(r)) == 8 for _, r in got[1:-1])
    assert [s for s, _ in checks_stft.kept_steps(5, wl, 256, 20)] == [0, 16,
                                                                     20]


def test_the_gain_and_the_inputs_from_the_seed():
    cfg = core.Cell(CELL).cfg
    g = checks_stft.gain(cfg, 11)
    assert g.shape == (1025,) and g.dtype == np.float32
    db = 20 * np.log10(g)
    assert db.min() >= -20.0 and db.max() <= 6.0 and len(set(g)) == 1025
    assert np.array_equal(g, checks_stft.gain(cfg, 11))
    a = checks_stft.input_block(cfg, 11, 1, 3, 4096, "cpu")
    assert torch.equal(a, checks_stft.input_block(cfg, 11, 1, 3, 4096,
                                                  "cpu"))
    assert a.dtype == torch.float32 and 1.1 < float(a.std()) < 1.6


def test_the_chains_least_time_at_the_cells_shape():
    cell = core.Cell(CELL)
    pk = roofline.peaks(H100)
    samples = cell.cfg["channels"] * cell.wl["block"]
    least, bound = roofline_stft.chain_least_s(cell.cfg, pk, samples)
    assert bound == "compute"
    assert least * 1e6 == pytest.approx(86.3, abs=0.05)  # 5.785 GFLOP
    assert samples * 8 / 3.35e12 * 1e6 == pytest.approx(58.5, abs=0.05)
    assert roofline_stft.flop_per_frame(2048) == 112640 + 4 * 2048 + 2


def _ctx(host=(), ops=None, steps=2, device=H100):
    cell = core.Cell(CELL)
    return core.Context(trace=Trace(ops or {}, list(host), (0.0, 1.0),
                                    steps),
                        cards=[0], steps=steps, cfg=cell.cfg, wl=cell.wl,
                        samples_per_step=256 * 95744, device_name=device)


def _reader(name):
    return core.load_module("metrics", name).read


def test_the_roofline_reader_is_the_least_time_over_the_busy_time():
    ops = {0: [(0.0, 0.001, "k"), (0.0005, 0.002, "k"), (0.5, 0.501, "m")]}
    least, _ = roofline_stft.chain_least_s(
        core.Cell(CELL).cfg, roofline.peaks(H100), 256 * 95744)
    read = _reader("spectral.roofline_pct")
    assert read(_ctx(ops=ops)) == pytest.approx(100 * least / (0.003 / 2))
    assert read(_ctx(ops=ops, device="a card without peaks")) is None
    assert read(_ctx(ops={0: []})) is None


def test_the_launches_reader_counts_the_operations_a_step():
    ops = {0: [(0.0, 0.001, "k"), (0.1, 0.2, "fft"), (0.5, 0.501, "m")]}
    read = _reader("spectral.launches")
    assert read(_ctx(ops=ops)) == 1.5
    assert read(_ctx(ops={0: []})) is None


def test_the_host_reader_sums_the_stages_and_its_ops_self_time():
    host = [(0.0, 0.4, "llz/pipeline/Chain.apply"),
            (0.01, 0.39, "llz/pipeline/SpectralGainStage"),
            (0.1, 0.15, "llz/ops/rfft"), (0.2, 0.22, "llz/ops/irfft"),
            (0.25, 0.3, "llz/ops/overlap_add"),
            (0.31, 0.33, "llz/ops/wola_state"), (0.32, 0.325, "aten::add_"),
            (0.5, 0.9, "llz/pipeline/SpectralGainStage")]
    read = _reader("spectral.host_ms")
    assert read(_ctx(host)) == pytest.approx((0.38 + 0.4) / 2 * 1e3)
    assert read(_ctx(host[:1])) is None  # a program without the spans


def test_the_share_reader_reads_the_frames_by_engine(monkeypatch):
    from llzlab_tpu_torch.runtime import profiler

    read = _reader("spectral.reference_share")
    monkeypatch.setattr(profiler, "counters", lambda: {
        "frames": {"reference": 300, "cwola": 100}})
    assert read(_ctx()) == 0.75
    monkeypatch.setattr(profiler, "counters", lambda: {
        "frames": {"cwola": 100}})
    assert read(_ctx()) == 0.0
    monkeypatch.setattr(profiler, "counters", lambda: {"calls": {}})
    assert read(_ctx()) is None  # a program without the counter
    monkeypatch.setattr(profiler, "counters", lambda: {"frames": {}})
    assert read(_ctx()) is None  # no frame run
    monkeypatch.delattr(profiler, "counters")
    assert read(_ctx()) is None


@pytest.mark.parametrize("path", [
    "portbench/reference_stft.py", "portbench/checks_stft.py",
    "portbench/roofline_stft.py", "portbench/control_stft.py"])
def test_the_reference_side_imports_nothing_of_the_program(path):
    got = imported(os.path.join(ROOT, path))
    assert not got & {"llzlab_tpu_torch", "llzlab_tpu", "jax", "jaxlib"}


@pytest.mark.cuda
def test_the_stage_at_the_cells_shape_on_the_card(cuda_card):
    """Two steps of 256 × 95 744 through the stage on the card, 8 channels
    of each against the float64 reference: the fp32 chain reads about
    2e-7, the check's limit is 1e-5."""
    cell = core.Cell(CELL)
    cfg, wl = cell.cfg, cell.wl
    ref = checks_stft.Reference(cfg, wl, 2 ** 31 + 5, 256, wl["block"],
                                cuda_card)
    stage = SpectralGainStage(ref.gain, n_fft=2048, hop=512)
    chain = Chain([stage])
    state = chain.init_state((256,), device=cuda_card)
    rows = [0, 31, 64, 100, 128, 190, 222, 255]
    for i, x in enumerate(ref.inputs):
        y, state = chain.apply(x, state)
        want = ref.step(i, rows)
        err = float((y[rows].double() - want).norm() / want.norm())
        assert err < 1e-6, (i, err)


@pytest.mark.cuda
def test_a_short_run_at_the_published_widths_on_the_card(cuda_card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELL, "--seed", str(2 ** 31 + 17), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert {"throughput_msps", "peak_mem_gib", "setup_s"} == set(
        line["metrics"])

"""The port's spectral-gain chain on its normal path,
``Chain([SpectralGainStage])`` streamed in blocks, against the plain
float64 WOLA reference (``tests/stft_reference.py``, which imports nothing
of the port), on seeded gains and seeded data; the reference from first
principles and against its copy in the benchmark; and the stage's spans
and frame counter, which leave its outputs bit for bit as they were."""

import ast
import inspect
import os

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.pipeline.chain import Chain, SpectralGainStage
from llzlab_tpu_torch.runtime import profiler
from tests import stft_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the relative L2 error the streamed chain keeps under: float32 FFTs,
#: products and overlap-adds against float64 read 2e-7 to 5e-7 on these
#: streams (the first hop, divided by a Hann envelope near zero, weighs
#: most), TF32 operands 7e-4 and more
REL_L2 = 1e-6


def _gain(bins, seed):
    """A per-bin gain drawn log-uniformly over −20 to +6 dB."""
    rng = np.random.default_rng(seed)
    return (10.0 ** (rng.uniform(-20.0, 6.0, bins) / 20.0)).astype(
        np.float32)


def _x(c, t, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (c, t)).astype(np.float32))


def _streamed(stage, x, blocks):
    chain = Chain([stage])
    state = chain.init_state((x.shape[0],), device="cpu")
    out = []
    for piece in x.chunk(blocks, dim=-1):
        y, state = chain.apply(piece, state)
        out.append(y)
    return torch.cat(out, dim=-1)


def _rel_l2(got, want):
    return float((got.to(torch.float64) - want).norm() / want.norm())


@pytest.mark.parametrize("n_fft,hop,block,blocks,channels,seed", [
    (256, 64, 512, 5, 3, 41),
    (256, 64, 1024, 3, 2, 42),
    (2048, 512, 4096, 4, 2, 43),
    (2048, 512, 8192, 3, 4, 44),
])
def test_the_streamed_chain_against_the_plain_reference(n_fft, hop, block,
                                                        blocks, channels,
                                                        seed):
    gain = _gain(n_fft // 2 + 1, seed)
    x = _x(channels, block * blocks, seed + 100)
    got = _streamed(SpectralGainStage(gain, n_fft=n_fft, hop=hop), x, blocks)
    want = stft_reference.stream(x, gain, n_fft, hop)
    assert _rel_l2(got, want) <= REL_L2
    # the control, TF32 operands, fails the same tolerance by far
    control = stft_reference.stream(x, gain, n_fft, hop, rounding="tf32")
    assert _rel_l2(control, want) > 100 * REL_L2


def test_the_stream_leads_with_n_fft_less_hop_zeros():
    gain = _gain(1025, 45)
    x = _x(3, 3 * 4096, 46)
    got = _streamed(SpectralGainStage(gain, n_fft=2048, hop=512), x, 3)
    want = stft_reference.stream(x, gain, 2048, 512)
    assert bool((got[:, :1536] == 0).all()) and bool((want[:, :1536] == 0)
                                                      .all())
    assert bool((got[:, 1537:1600] != 0).all())


@pytest.mark.parametrize("n_fft,hop,clamped", [(2048, 512, 7), (256, 64, 1)])
def test_a_unity_gain_gives_the_input_back_lagged(n_fft, hop, clamped):
    """Every frame that holds a position carries the same sample, so with
    a unity gain the result is the input lagged by ``n_fft − hop``, but
    where the envelope is clamped: positions 0 to 6 of a 2048-point Hann
    stream (position 0 alone at 256 points), where it reads 0 at 0."""
    x = _x(2, 4 * n_fft, 47).to(torch.float64)
    y = stft_reference.stream(x, np.ones(n_fft // 2 + 1), n_fft, hop)
    lag = n_fft - hop
    d = (y[:, lag:] - x[:, :-lag]).abs()
    assert float(d[:, clamped:].max()) < 1e-11
    assert bool((y[:, lag] == 0).all())
    w = stft_reference.hann(n_fft)
    assert bool((w[:clamped] ** 2 < stft_reference.ENV_FLOOR).all())
    assert float(w[clamped] ** 2) >= stft_reference.ENV_FLOOR


def test_the_window_and_the_rounding_from_their_definitions():
    w = stft_reference.hann(8)
    assert torch.allclose(w, torch.tensor(
        [0.0, 0.1464466, 0.5, 0.8535534, 1.0, 0.8535534, 0.5, 0.1464466],
        dtype=torch.float64), atol=1e-7)
    # 1 + 2^-11 is halfway between two TF32 values: to even, down to 1;
    # 1 + 3·2^-11 rounds up to 1 + 2^-9
    t = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0],
                     dtype=torch.float64)
    assert stft_reference.round_tf32(t).tolist() == [1.0, 1.0 + 2.0 ** -9,
                                                     -3.0]
    z = stft_reference.round_tf32(torch.complex(t, -t))
    assert z.dtype == torch.complex128 and z.imag.tolist() == [
        -1.0, -1.0 - 2.0 ** -9, 3.0]


def test_the_benchmarks_copy_is_the_same_file():
    with open(os.path.join(ROOT, "tests", "stft_reference.py")) as f:
        mine = f.read()
    with open(os.path.join(ROOT, "portbench", "reference_stft.py")) as f:
        theirs = f.read()
    assert mine == theirs
    names = {n.name for n in ast.parse(mine).body
             if isinstance(n, ast.FunctionDef)}
    assert names == {"hann", "round_tf32", "stream"}
    imported = set()
    for node in ast.walk(ast.parse(mine)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert imported <= {"__future__", "math", "torch"}
    assert "highest" in inspect.getdoc(stft_reference)


def _stage_and_state(rows=(2,), t=2048):
    """A stage at 256 / 64, a state carried into it, and a block."""
    stage = SpectralGainStage(_gain(129, 48), n_fft=256, hop=64)
    state = {k: torch.randn(v.shape) for k, v in
             stage.init_state(rows, device="cpu").items() if k != "pos"}
    state["pos"] = torch.tensor(stage.latency, dtype=torch.int32)
    return stage, state, torch.randn(rows + (t,))


def test_the_stage_records_its_spans_under_a_profiler_only():
    stage, state, x = _stage_and_state()
    chain = Chain([stage])
    with torch.profiler.profile() as prof:
        chain.apply(x, (state,))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("llz/"))
    names = [n for _, _, n in spans]
    assert names == ["llz/pipeline/Chain.apply",
                     "llz/pipeline/SpectralGainStage", "llz/ops/rfft",
                     "llz/ops/irfft", "llz/ops/overlap_add",
                     "llz/ops/overlap_add", "llz/ops/wola_state"]
    (s0, e0), = [(s, e) for s, e, n in spans
                 if n == "llz/pipeline/SpectralGainStage"]
    assert all(s0 <= s and e <= e0 for s, e, n in spans
               if n.startswith("llz/ops/"))
    assert not torch.autograd._profiler_enabled()
    assert profiler.span("ops", "wola_state") is profiler._OFF


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(profiler, "_RecordFunctionFast", refuse)
    stage, state, x = _stage_and_state()
    Chain([stage]).apply(x, (state,))


@pytest.mark.parametrize("rows", [(2,), (3, 2)])
def test_the_frame_counter_grows_by_rows_times_hops_a_call(rows):
    stage, state, x = _stage_and_state(rows, t=1280)
    before = profiler.counters()["frames"].get("reference", 0)
    stage.apply(x, state)
    stage.apply(x, state)
    after = profiler.counters()["frames"]
    assert after["reference"] - before == 2 * int(np.prod(rows)) * (1280
                                                                     // 64)


def test_the_frame_counter_names_the_engine_that_ran():
    gain = _gain(129, 49)
    x = torch.randn(2, 512)
    for engine in ("wdft", "cwola"):
        stage = SpectralGainStage(gain, n_fft=256, hop=64, engine=engine)
        before = profiler.counters()["frames"].get(engine, 0)
        stage.apply(x, stage.init_state((2,), device="cpu"))
        assert profiler.counters()["frames"][engine] - before == 2 * 8
    assert SpectralGainStage(gain, n_fft=256).engine == "reference"


def test_outputs_are_bitwise_the_same_with_the_profiler_on_and_off():
    stage, state, x = _stage_and_state()
    y, new = stage.apply(x, state)
    with torch.profiler.profile():
        y_p, new_p = stage.apply(x, state)
    assert torch.equal(y, y_p)
    assert all(torch.equal(new[k], new_p[k]) for k in new)

"""Kernel wola_gain (``kernels/wola_gain.py``, ``csrc/wola_gain.cu``): config
4's whole frame map in one launch.  On the CPU its plain version, which is
the kernel's arithmetic in the kernel's order: its FFT plan against float64
at every size of the kernel's domain, the frame map streamed against the
plain float64 WOLA (``tests/stft_reference.py``) and against the stage's
composite path, the stage's dispatch, the wrapper's refusals and the launch
counter.  On the card (marked ``cuda``) the kernel against its plain version
and the composite path at the benchmark's step.

This file imports no JAX; on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_wola_gain.py
"""

import types

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.kernels import wola_gain as wg
from llzlab_tpu_torch.pipeline.chain import Chain, SpectralGainStage
from llzlab_tpu_torch.runtime import profiler
from tests import stft_reference

#: the kernel's FFT against float64 (float32 twiddles rounded once, a
#: butterfly's sums and products each rounded: 1e-7 to 1.3e-7 at 128 to
#: 2048 points on these inputs)
FFT_REL = 3e-7
#: the frame map against the float64 WOLA, as tests/test_torch_stft_reference
#: holds the composite path
REL_L2 = 1e-6
#: streamed against one shot (tests/test_torch_spectral_stage.py REF_DB):
#: the carried tails sum a hop-block's frames in another association
STREAM_DB = 140.0
SIZES = [256, 512, 1024, 2048, 4096]


def _gain(bins, seed):
    rng = np.random.default_rng(seed)
    return (10.0 ** (rng.uniform(-20.0, 6.0, bins) / 20.0)).astype(
        np.float32)


def _x(c, t, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (c, t)).astype(np.float32))


def _rel(got, want):
    got, want = got.to(torch.float64), want.to(torch.float64)
    return float((got - want).norm() / want.norm())


def _snr_db(ref, y):
    ref, y = ref.to(torch.float64), y.to(torch.float64)
    return float(10.0 * torch.log10((ref * ref).sum()
                                    / ((ref - y) ** 2).sum()))


def _plain_stream(tables, x, blocks, rows):
    """Stream ``x`` through the plain version in ``blocks`` pieces from the
    stage's initial state; the outputs and the last state."""
    st = SpectralGainStage(np.ones(tables.n_fft // 2 + 1), n_fft=tables.n_fft,
                           hop=tables.hop).init_state((rows,), device="cpu")
    state = (st["x_hist"], st["ola"], st["env"], st["pos"])
    outs = []
    for piece in x.chunk(blocks, dim=-1):
        y, *state = wg.wola_gain_plain(piece, *state, tables)
        outs.append(y)
    return torch.cat(outs, -1), state


@pytest.mark.parametrize("n_fft", SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_the_fft_plan_against_float64(n_fft, inverse):
    m = n_fft // 2
    plan = wg.fft_plan(m)
    assert int(np.prod(plan)) == m and max(plan) <= min(32, m // 32)
    tables = wg.wola_tables(np.ones(m + 1), n_fft, n_fft // 4, "hann")
    rng = np.random.default_rng(n_fft + inverse)
    a = (rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))
         ).astype(np.complex64)
    re, im = wg.fft_plain(torch.from_numpy(a.real.copy()),
                          torch.from_numpy(a.imag.copy()), tables, inverse)
    a = a.astype(np.complex128)
    want = np.fft.ifft(a, axis=-1) * m if inverse else np.fft.fft(a, axis=-1)
    got = re.double().numpy() + 1j * im.double().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < FFT_REL


def test_the_twiddle_tables_are_exact_at_the_quarter_turns():
    u = wg._unit(np.arange(8), 8)
    assert u[[0, 2, 4, 6]].tolist() == [[1.0, 0.0], [0.0, -1.0],
                                         [-1.0, 0.0], [0.0, 1.0]]
    assert np.allclose(u[1], [np.sqrt(0.5), -np.sqrt(0.5)], atol=1e-16)


@pytest.mark.parametrize("n_fft,hop,block,blocks,rows,seed", [
    (2048, 512, 8192, 3, 3, 61),
    (2048, 512, 4096, 4, 2, 62),
    (256, 64, 1024, 5, 2, 63),
])
def test_the_streamed_frame_map_against_the_plain_reference(
        n_fft, hop, block, blocks, rows, seed):
    gain = _gain(n_fft // 2 + 1, seed)
    tables = wg.wola_tables(gain, n_fft, hop, "hann")
    x = _x(rows, block * blocks, seed + 100)
    got, _ = _plain_stream(tables, x, blocks, rows)
    assert _rel(got, stft_reference.stream(x, gain, n_fft, hop)) <= REL_L2


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (512, 64), (4096, 4096)])
def test_streamed_blocks_against_one_shot(n_fft, hop):
    rows, t = 2, 6 * n_fft
    tables = wg.wola_tables(_gain(n_fft // 2 + 1, 64), n_fft, hop, "hann")
    x = _x(rows, t, 65)
    one, (xh1, ola1, env1, pos1) = _plain_stream(tables, x, 1, rows)
    for blocks in (2, 3, 6):
        got, (xh, ola, env, pos) = _plain_stream(tables, x, blocks, rows)
        assert _snr_db(one, got) >= STREAM_DB, blocks
        assert torch.equal(xh, xh1) and torch.equal(pos, pos1)
        if ola.numel():
            assert _snr_db(ola1, ola) >= STREAM_DB
            assert torch.equal(env, env1)


@pytest.mark.parametrize("n_fft,hop,t", [(2048, 512, 4096), (2048, 512, 512),
                                         (256, 32, 256), (1024, 1024, 2048)])
def test_the_tails_pos_and_env_against_the_composite_path(n_fft, hop, t):
    """Three blocks through the stage on the CPU (its composite path) and
    through the plain version: x_hist, env and pos bit for bit, the output
    and ola to the FFT's rounding."""
    rows = 3
    gain = _gain(n_fft // 2 + 1, 66)
    stage = SpectralGainStage(gain, n_fft=n_fft, hop=hop)
    tables = wg.wola_tables(gain, n_fft, hop, "hann")
    st = stage.init_state((rows,), device="cpu")
    mine = (st["x_hist"], st["ola"], st["env"], st["pos"])
    for b in range(3):
        x = _x(rows, t, 67 + b)
        y, st = stage.apply(x, st)
        got, *mine = wg.wola_gain_plain(x, *mine, tables)
        xh, ola, env, pos = mine
        assert torch.equal(xh, st["x_hist"]) and torch.equal(env, st["env"])
        assert torch.equal(pos, st["pos"]) and pos.dtype == torch.int32
        for mine_, theirs in ((got, y), (ola, st["ola"])):
            if theirs.abs().sum() > 0:
                assert _rel(mine_, theirs) <= REL_L2
            else:  # the stream's start: every frame masked
                assert not bool(mine_.abs().sum() > 0)


def test_strided_rows_give_the_same_bits():
    tables = wg.wola_tables(_gain(1025, 68), 2048, 512, "hann")
    wide = _x(2, 4096 + 8, 69)
    x = wide[:, 3:3 + 4096]
    st = [v for k, v in sorted(SpectralGainStage(
        np.ones(1025), n_fft=2048).init_state((2,), device="cpu").items())]
    env, ola, pos, xh = st
    a = wg.wola_gain_plain(x, xh, ola, env, pos, tables)
    b = wg.wola_gain_plain(x.contiguous(), xh, ola, env, pos, tables)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _on_card(shape):
    """A stand-in for a CUDA tensor: what the stage's dispatch reads."""
    return types.SimpleNamespace(is_cuda=True, shape=shape)


@pytest.mark.parametrize("kw,shape,takes", [
    ({}, (256, 95744), True),
    ({}, (2, 3, 512), True),
    ({"n_fft": 256, "hop": 32}, (2, 512), True),
    ({"n_fft": 4096, "hop": 4096}, (2, 8192), True),
    ({"engine": "reference"}, (2, 512), True),
    ({}, (0, 512), False),
    ({"gain": "callable"}, (2, 512), False),
    ({"engine": "wdft"}, (2, 512), False),
    ({"engine": "cwola"}, (2, 512), False),
    ({"n_fft": 8192}, (2, 8192), False),
    ({"n_fft": 128}, (2, 512), False),
    ({"n_fft": 255, "hop": 85}, (2, 510), False),
    ({"n_fft": 2048, "hop": 128}, (2, 512), False),
    ({"window": ("kaiser", 8.0)}, (2, 512), False),
])
def test_the_stage_takes_the_kernel_where_the_kernel_runs(kw, shape, takes):
    kw = dict(kw)
    n_fft = kw.pop("n_fft", 2048)
    gain = kw.pop("gain", None)
    gain = ((lambda spec: torch.ones(())) if gain == "callable"
            else np.ones(n_fft // 2 + 1))
    stage = SpectralGainStage(gain, n_fft=n_fft, **kw)
    assert stage._takes_kernel(_on_card(shape)) is takes
    cpu = torch.zeros(shape[:-1] + (stage.hop,))
    assert not stage._takes_kernel(cpu)


def test_the_cpu_path_is_the_composite_one(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the kernel's wrapper called on the CPU")

    monkeypatch.setattr(wg, "wola_gain_cuda", refuse)
    stage = SpectralGainStage(_gain(1025, 70), n_fft=2048)
    y, _ = Chain([stage]).apply(_x(2, 4096, 71), (stage.init_state(
        (2,), device="cpu"),))
    assert y.shape == (2, 4096)


def _state(rows, ov):
    return dict(x_hist=torch.zeros(rows, ov), ola=torch.zeros(rows, ov),
                env=torch.zeros(ov), pos=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("what,change", [
    ("x dtype", dict(x=torch.zeros(2, 1024, dtype=torch.float64))),
    ("x rank", dict(x=torch.zeros(2, 2, 1024))),
    ("x columns", dict(x=torch.zeros(1024, 2).t())),
    ("no rows", dict(x=torch.zeros(0, 1024))),
    ("no samples", dict(x=torch.zeros(2, 0))),
    ("not a multiple of the hop", dict(x=torch.zeros(2, 1000))),
    ("x_hist shape", dict(x_hist=torch.zeros(2, 1535))),
    ("ola dtype", dict(ola=torch.zeros(2, 1536, dtype=torch.float64))),
    ("ola layout", dict(ola=torch.zeros(1536, 2).t())),
    ("env shape", dict(env=torch.zeros(2, 1536))),
    ("pos dtype", dict(pos=torch.zeros((), dtype=torch.int64))),
    ("pos shape", dict(pos=torch.zeros(1, dtype=torch.int32))),
    ("on the CPU", {}),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(what, change):
    tables = wg.wola_tables(np.ones(1025), 2048, 512, "hann")
    args = dict(x=torch.zeros(2, 1024), **_state(2, 1536))
    args.update(change)
    before = wg.wola_gain_cuda.launches
    with pytest.raises(ValueError):
        wg.wola_gain_cuda(args["x"], args["x_hist"], args["ola"], args["env"],
                          args["pos"], tables)
    assert wg.wola_gain_cuda.launches == before


@pytest.mark.parametrize("n_fft,hop,window,gain_bins", [
    (8192, 2048, "hann", 4097), (2048, 128, "hann", 1025),
    (2048, 512, ("kaiser", 8.0), 1025), (2048, 512, "hann", 1024),
])
def test_the_tables_refuse_what_the_kernel_does_not_run(n_fft, hop, window,
                                                        gain_bins):
    with pytest.raises(ValueError):
        wg.wola_tables(np.ones(gain_bins), n_fft, hop, window)


def test_the_runs_cover_a_row_and_fill_the_card():
    for rows, nf in ((256, 187), (1, 187), (8, 9), (3, 1), (100000, 4)):
        fpr = wg.frames_per_run(rows, nf, 132)
        assert 1 <= fpr <= nf
        runs = -(-nf // fpr)
        assert (runs - 1) * fpr < nf <= runs * fpr
    assert wg.frames_per_run(256, 187, 132) == 187


def test_the_counters_read_the_kernels_launches(monkeypatch):
    assert profiler.counters()["launches"]["wola_gain"] == {
        "launches": wg.wola_gain_cuda.launches}
    monkeypatch.setattr(wg.wola_gain_cuda, "launches", 41)
    assert profiler.counters()["launches"]["wola_gain"] == {"launches": 41}


# ---- on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_the_kernel_against_plain_and_composite_at_the_benchmarks_step():
    """256 × 95 744, streamed in two blocks: the kernel bit for bit its
    plain version (outputs and state) and the same over two runs; against
    the composite path (cuFFT, here through a callable gain, the same
    products) to the FFT's rounding, x_hist, env and pos bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rows, t = 256, 95744
    gain = _gain(1025, 72)
    stage = SpectralGainStage(gain, n_fft=2048, hop=512)
    g = torch.from_numpy(gain).to(dev)
    composite = SpectralGainStage(lambda spec: g, n_fft=2048, hop=512)
    tables = stage._tables_on(dev)
    gen = torch.Generator(device=dev).manual_seed(73)
    sk = sc = stage.init_state((rows,), device=dev)
    sp = (sk["x_hist"], sk["ola"], sk["env"], sk["pos"])
    for _ in range(2):
        x = torch.randn((rows, t), generator=gen, device=dev)
        n = wg.wola_gain_cuda.launches
        y, sk2 = stage.apply(x, sk)
        assert wg.wola_gain_cuda.launches == n + 1
        again = stage.apply(x, sk)
        yp, *sp = wg.wola_gain_plain(x, *sp, tables)
        yc, sc = composite.apply(x, sc)
        assert torch.equal(y, yp) and torch.equal(y, again[0])
        for k, v in zip(("x_hist", "ola", "env", "pos"), sp):
            assert torch.equal(sk2[k], v) and torch.equal(sk2[k], again[1][k])
        for k in ("x_hist", "env", "pos"):
            assert torch.equal(sk2[k], sc[k])
        assert _rel(y, yc) <= REL_L2 and _rel(sk2["ola"], sc["ola"]) <= REL_L2
        sk = sk2

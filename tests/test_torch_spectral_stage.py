"""The port's ``SpectralGainStage`` and ``FFTStage`` against the JAX
package's on the CPU, at small shapes: each engine streamed against the
JAX package's stage, streamed against its own one shot, the composed-WOLA
engine against the float64 C++ golden, a state saved by the JAX package's
chain resumed by the port, and the wola_gain kernel's arithmetic
(``kernels/wola_gain.py`` ``wola_gain_plain``, bit for bit the kernel's)
at config 4's frames against the JAX package's reference engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from llzlab_tpu import golden
from llzlab_tpu.pipeline import chain as rchain
from llzlab_tpu.utils import checkpoint as rckpt
from llzlab_tpu_torch.kernels import wola_gain as wg
from llzlab_tpu_torch.ops import spectral as psp
from llzlab_tpu_torch.pipeline import chain as pchain
from llzlab_tpu_torch.utils import checkpoint as pckpt
from tests.conftest import snr_db

N_FFT, HOP, T = 256, 64, 8192
LAT = N_FFT - HOP
#: the JAX package's floors (tests/pipeline/test_chain.py,
#: TestSpectralGainStreaming): streamed == one shot for the reference
#: engine at every sample, for the product engines on the interior
#: [latency + n_fft, T − n_fft), because at both stream edges the output
#: divides by a near-zero envelope that amplifies any f32 rounding about
#: 40 dB.  The port against the JAX package is two f32 computations of
#: the same WOLA (other FFT libraries, other product orders), held as the
#: JAX package holds two of its engines against each other: 120 dB on the
#: interior, for every engine (the reference engine reads 139 dB there
#: and 100 dB over the startup ramp)
REF_DB, INTERIOR_DB = 140.0, 120.0
LO, HI = LAT + N_FFT, T - N_FFT
#: the port against the JAX package over the whole stream, edges included,
#: so that a fault there does not rest on the port agreeing with itself
#: (these inputs read 100.5 / 94.5 / 136.5 dB for reference / wdft / cwola)
WHOLE_DB = 90.0
#: the composed-WOLA engine against the float64 C++ golden
#: (tests/ops/test_golden_cpp.py, the interior)
GOLDEN_DB = 90.0
ENGINES = ("reference", "wdft", "cwola")


def _gain():
    return np.linspace(1.0, 0.25, N_FFT // 2 + 1).astype(np.float32)


def _x(seed, c=2, t=T):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


def _stream_port(stage, x, t_blk):
    state = stage.init_state(x.shape[:-1], device="cpu")
    outs = []
    for i in range(0, x.shape[-1], t_blk):
        y, state = stage.apply(torch.from_numpy(x[:, i:i + t_blk]), state)
        outs.append(y.numpy())
    outs.append(stage.flush(state).numpy())
    return np.concatenate(outs, axis=-1)


def _stream_ref(stage, x, t_blk):
    state = stage.init_state(x.shape[:-1])
    outs = []
    for i in range(0, x.shape[-1], t_blk):
        y, state = stage.apply(jnp.asarray(x[:, i:i + t_blk]), state)
        outs.append(np.asarray(y))
    outs.append(np.asarray(stage.flush(state)))
    return np.concatenate(outs, axis=-1)


def _stage(mod, engine, gain=None, **kw):
    return mod.SpectralGainStage(_gain() if gain is None else gain,
                                 n_fft=N_FFT, hop=HOP, engine=engine, **kw)


@pytest.mark.parametrize("engine", ENGINES)
def test_streamed_stage_matches_the_reference_stage(engine):
    x = _x(11)
    got = _stream_port(_stage(pchain, engine), x, 1024)
    ref = _stream_ref(_stage(rchain, engine), x, 1024)
    assert got.shape == ref.shape == (2, T + LAT)
    np.testing.assert_array_equal(got[:, :LAT], 0.0)
    assert snr_db(ref[:, LO:HI], got[:, LO:HI]) >= INTERIOR_DB
    assert snr_db(ref, got) >= WHOLE_DB


@pytest.mark.parametrize("engine", ENGINES)
def test_streamed_equals_one_shot(engine):
    """Block splits of the port's own stage: the reference engine against
    one istft(gain·stft(x)) at every sample, the product engines against
    their own one-block run on the interior."""
    x = _x(12)
    stage = _stage(pchain, engine)
    if engine == "reference":
        spec = psp.stft(torch.from_numpy(x), n_fft=N_FFT, hop=HOP)
        one = psp.istft(spec * torch.from_numpy(_gain()), n_fft=N_FFT,
                        hop=HOP, length=T).numpy()
        for t_blk in (HOP, 2048):
            ys = _stream_port(stage, x, t_blk)
            assert snr_db(one, ys[:, LAT:]) >= REF_DB, t_blk
    else:
        one = _stream_port(stage, x, T)
        for t_blk in (512, 2048):
            ys = _stream_port(stage, x, t_blk)
            assert snr_db(one[:, LO:HI], ys[:, LO:HI]) >= INTERIOR_DB, t_blk


@pytest.mark.parametrize("engine", ["reference", "wdft"])
def test_callable_gain_matches_the_reference_stage(engine):
    x = _x(13)
    got = _stream_port(_stage(pchain, engine,
                              gain=lambda s: 1.0 / (1.0 + s.abs() / 100.0)),
                       x, 2048)
    ref = _stream_ref(_stage(rchain, engine,
                             gain=lambda s: 1.0 / (1.0 + jnp.abs(s) / 100.0)),
                      x, 2048)
    assert snr_db(ref[:, LO:HI], got[:, LO:HI]) >= INTERIOR_DB


def test_cwola_matches_the_float64_golden():
    t = 4096
    x = _x(14, 1, t)
    gain = _gain()
    stage = _stage(pchain, "cwola")
    st = stage.init_state((1,), device="cpu")
    y, st = stage.apply(torch.from_numpy(x), st)
    ys = np.concatenate([y.numpy(), stage.flush(st).numpy()],
                        axis=-1)[0, LAT:]
    # the golden returns a bogus buffer for an input shorter than one
    # frame: never call it there
    assert x.shape[-1] >= N_FFT
    w = ss.get_window("hann", N_FFT, fftbins=True).astype(np.float64)
    ref = golden.wola_gain(x[0], gain.astype(np.float64), w, n_fft=N_FFT,
                           hop=HOP)
    n = min(ys.size, ref.size)
    lo, hi = N_FFT + LAT, n - 2 * N_FFT
    assert snr_db(ref[lo:hi], ys[lo:hi]) >= GOLDEN_DB


@pytest.mark.parametrize("engine", ENGINES)
def test_reference_state_resumes_in_the_port(engine, tmp_path):
    """A JAX chain streams two blocks and saves its state; the port loads
    the file (and, separately, takes the state over from memory) and its
    next block equals the JAX chain's next block."""
    x = _x(15, 2, 3 * 2048)
    blocks = [x[:, i:i + 2048] for i in range(0, x.shape[-1], 2048)]
    rc = rchain.Chain([_stage(rchain, engine)])
    st = rc.init_state((2,))
    for b in blocks[:2]:
        _, st = rc.apply(jnp.asarray(b), st)
    ref_next, _ = rc.apply(jnp.asarray(blocks[2]), st)
    path = str(tmp_path / "state.npz")
    rckpt.save_state(path, st, block_index=2)
    pc = pchain.Chain([_stage(pchain, engine)])
    like = pc.init_state((2,), device="cpu")
    loaded, index, _ = pckpt.load_state(path, like=like)
    handed = pckpt.from_reference(
        tuple({k: np.asarray(v) for k, v in s.items()} for s in st), "cpu")
    assert index == 2
    for state in (loaded, handed):
        pos = state[0]["pos"]
        assert pos.dtype == torch.int32 and pos.dim() == 0
        assert int(pos) == LAT
        got, _ = pc.apply(torch.from_numpy(blocks[2]), state)
        # a block in mid-stream: all of it is interior
        assert snr_db(np.asarray(ref_next), got.numpy()) >= INTERIOR_DB
    # the leaves in sorted-key order: env, ola, pos, x_hist
    assert [tuple(v.shape) for v in pckpt._leaves(like)] == [
        (LAT,), (2, LAT), (), (2, LAT)]


def test_stage_rules():
    stage = _stage(pchain, "auto")
    assert stage.engine == "reference"
    assert stage.latency == LAT and stage.block_multiple == HOP
    assert pchain.Chain([stage]).block_multiple == HOP
    with pytest.raises(ValueError, match="cwola"):
        pchain.SpectralGainStage(lambda s: 1.0, engine="cwola")
    for engine in ("wdft", "cwola"):
        with pytest.raises(ValueError, match="even n_fft"):
            pchain.SpectralGainStage(np.ones(5), n_fft=9, hop=3,
                                     engine=engine)
    with pytest.raises(ValueError, match="unknown engine"):
        _stage(pchain, "fast")
    with pytest.raises(ValueError, match="multiple of hop"):
        stage.apply(torch.zeros((1, HOP + 1)),
                    stage.init_state((1,), device="cpu"))


def test_fft_stage_and_stream_dtype_match_the_reference():
    x = _x(16, 2, 8 * N_FFT + 17)
    for window in (None, "hann"):
        got, _ = pchain.FFTStage(N_FFT, window=window).apply(
            torch.from_numpy(x), None)
        ref, _ = rchain.FFTStage(N_FFT, window=window).apply(
            jnp.asarray(x), None)
        assert got.shape == ref.shape == (2, 8, N_FFT // 2 + 1)
        err = np.abs(got.numpy() - np.asarray(ref))
        assert err.max() <= 1e-4 * np.abs(np.asarray(ref)).max()
    chain = pchain.Chain([_stage(pchain, "reference")])
    blocks = [torch.from_numpy(x[:, :1024]), torch.from_numpy(x[:, 1024:2048])]
    ys = list(chain.stream(blocks, dtype=torch.float64))
    assert [tuple(y.shape) for y in ys] == [(2, 1024), (2, 1024)]


def _tool_gain(n_fft, rate=48000):
    """The ``stft`` tool's ``--gain-db -6 --notch 1000 2000`` at 48 kHz."""
    f = np.arange(n_fft // 2 + 1) * rate / n_fft
    g = np.full(f.shape, 10.0 ** (-6.0 / 20.0), np.float32)
    g[(f >= 1000.0) & (f <= 2000.0)] = 0.0
    return g


@pytest.mark.parametrize("gain", ["tool_notch", "ramp"])
def test_the_wola_gain_kernels_arithmetic_matches_the_reference_stage(gain):
    """Config 4's frames (2048 points at hop 512), three blocks from the
    stream's start, held as the composite path is above (these inputs read
    136.7 / 136.6 dB on the interior, 105.5 / 96.5 dB over the whole
    stream, for the notch / the ramp)."""
    n_fft, hop, block, rows = 2048, 512, 8192, 3
    lat, t = n_fft - hop, 3 * block
    gain = (_tool_gain(n_fft) if gain == "tool_notch" else
            np.linspace(1.0, 0.25, n_fft // 2 + 1).astype(np.float32))
    x = _x(81, rows, t)
    tables = wg.wola_tables(gain, n_fft, hop, "hann")
    st = pchain.SpectralGainStage(gain, n_fft=n_fft, hop=hop).init_state(
        (rows,), device="cpu")
    mine = (st["x_hist"], st["ola"], st["env"], st["pos"])
    ref_stage = rchain.SpectralGainStage(gain, n_fft=n_fft, hop=hop,
                                         engine="reference")
    ref_state = ref_stage.init_state((rows,))
    got, ref = [], []
    for i in range(0, t, block):
        y, *mine = wg.wola_gain_plain(torch.from_numpy(x[:, i:i + block]),
                                      *mine, tables)
        got.append(y.numpy())
        y, ref_state = ref_stage.apply(jnp.asarray(x[:, i:i + block]),
                                       ref_state)
        ref.append(np.asarray(y))
    got, ref = np.concatenate(got, -1), np.concatenate(ref, -1)
    assert got.shape == ref.shape == (rows, t)
    np.testing.assert_array_equal(got[:, :lat], 0.0)
    lo, hi = lat + n_fft, t - n_fft
    assert snr_db(ref[:, lo:hi], got[:, lo:hi]) >= INTERIOR_DB
    assert snr_db(ref, got) >= WHOLE_DB
    assert int(mine[3]) == int(ref_state["pos"])
    np.testing.assert_array_equal(mine[0].numpy(),
                                  np.asarray(ref_state["x_hist"]))

"""The slice as a whole: the port's streaming chains against the JAX
package's chains, checkpoint hand-over from the JAX chain to the port, and
the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llzlab_tpu.kernels import fused_fir_resample as rff
from llzlab_tpu.ops import fir as rfir
from llzlab_tpu.ops import resample as rrs
from llzlab_tpu.pipeline import chain as rchain
from llzlab_tpu.utils import checkpoint as rckpt
from llzlab_tpu_torch.ops import fused_chain as pfc
from llzlab_tpu_torch.pipeline import chain as pchain
from llzlab_tpu_torch.utils import checkpoint as pckpt
from tests.conftest import snr_db

NTAPS, UP, DOWN, K = 129, 3, 4, 8
#: f32 sums in another order on each side, "highest" precision throughout
#: (the JAX package's own fused-vs-unfused floor)
FLOOR_DB = 130.0


def _design():
    return (rfir.firwin(NTAPS, 0.2, window="hamming"),
            rrs.resample_taps(UP, DOWN, K))


def _blocks(n, length, seed=31):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((8, length)).astype(np.float32)
            for _ in range(n)]


def _stream_ref(chain, blocks):
    state = chain.init_state((8,))
    out = []
    for blk in blocks:
        y, state = chain.apply(jnp.asarray(blk), state)
        out.append(np.asarray(y))
    return np.concatenate(out, -1), state


def _stream_port(chain, blocks, state=None):
    if state is None:
        state = chain.init_state((8,), device="cpu")
    out = []
    for blk in blocks:
        y, state = chain.apply(torch.from_numpy(blk), state)
        out.append(y.numpy())
    return np.concatenate(out, -1), state


@pytest.mark.parametrize("ref_engine", ["pallas", "composite"])
def test_fused_kernel_chain_matches_reference(ref_engine):
    taps, rtaps = _design()
    port = pchain.Chain([pchain.FusedFirResampleStage(
        taps, UP, DOWN, rtaps=rtaps, engine="kernel", channels=8,
        device="cpu", precision="highest")])
    ref = rchain.Chain([rchain.FusedFirResampleStage(
        taps, UP, DOWN, rtaps=rtaps, engine=ref_engine, channels=8,
        precision="highest")])
    p = rff.fused_program_in(NTAPS, UP, DOWN)
    assert port.block_multiple == p
    if ref_engine == "pallas":
        assert ref.block_multiple == port.block_multiple
        assert ([tuple(s.shape) for s in ref.init_state((8,))]
                == [tuple(s.shape) for s in port.init_state((8,),
                                                            device="cpu")])
    blocks = _blocks(2, p)
    z_ref, _ = _stream_ref(ref, blocks)
    z, _ = _stream_port(port, blocks)
    assert z.shape == z_ref.shape
    assert snr_db(z_ref.astype(np.float64), z) >= FLOOR_DB


def test_composite_and_unfused_chains_match_reference(monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "highest")
    taps, rtaps = _design()
    pairs = [
        (pchain.Chain([pchain.FusedFirResampleStage(
            taps, UP, DOWN, rtaps=rtaps, engine="composite", device="cpu")]),
         rchain.Chain([rchain.FusedFirResampleStage(
             taps, UP, DOWN, rtaps=rtaps, engine="composite")])),
        (pchain.Chain([pchain.FIRStage(taps, method="block2"),
                       pchain.ResampleStage(UP, DOWN, taps=rtaps)]),
         rchain.Chain([rchain.FIRStage(taps, method="block2"),
                       rchain.ResampleStage(UP, DOWN, taps=rtaps)])),
    ]
    for port, ref in pairs:
        assert port.block_multiple == ref.block_multiple
        assert ([tuple(s.shape) for s in ref.init_state((8,))]
                == [tuple(s.shape) for s in port.init_state((8,),
                                                            device="cpu")])
        blocks = _blocks(2, 4 * port.block_multiple, seed=32)
        z_ref, _ = _stream_ref(ref, blocks)
        z, _ = _stream_port(port, blocks)
        assert snr_db(z_ref.astype(np.float64), z) >= FLOOR_DB


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """A state saved by the JAX chain mid-stream, loaded by the port,
    resumes to the port's uninterrupted output bit for bit: the fused
    state is the last 2·block input samples, equal on both sides."""
    taps, rtaps = _design()
    ref = rchain.Chain([rchain.FusedFirResampleStage(
        taps, UP, DOWN, rtaps=rtaps, engine="pallas", channels=8,
        precision="highest")])
    port = pchain.Chain([pchain.FusedFirResampleStage(
        taps, UP, DOWN, rtaps=rtaps, engine="kernel", channels=8,
        device="cpu", precision="highest")])
    blocks = _blocks(2, port.block_multiple, seed=33)
    z_full, _ = _stream_port(port, blocks)
    _, ref_state = _stream_ref(ref, blocks[:1])
    path = str(tmp_path / "ref_state.npz")
    rckpt.save_state(path, ref_state, block_index=1)
    like = port.init_state((8,), device="cpu")
    state, block_index, _ = pckpt.load_state(path, like=like)
    assert block_index == 1
    tail = z_full[:, -(z_full.shape[-1] // 2):]
    z_resumed, state_after = _stream_port(port, blocks[1:], state=state)
    np.testing.assert_array_equal(z_resumed, tail)
    handed = pckpt.from_reference(
        tuple(np.asarray(s) for s in ref_state), "cpu")
    np.testing.assert_array_equal(_stream_port(port, blocks[1:], handed)[0],
                                  tail)
    # and back: the port's checkpoint loads into the JAX package
    path2 = str(tmp_path / "port_state.npz")
    pckpt.save_state(path2, state_after, block_index=2)
    back, _, _ = rckpt.load_state(path2, like=ref.init_state((8,)))
    np.testing.assert_array_equal(np.asarray(back[0]),
                                  state_after[0].numpy())


def test_engine_resolution_by_device():
    taps, rtaps = _design()
    p = rff.fused_program_in(NTAPS, UP, DOWN)
    kw = dict(rtaps=rtaps, channels=8)
    assert pchain.FusedFirResampleStage(taps, UP, DOWN, device="cpu",
                                        **kw).engine == "composite"
    assert pchain.FusedFirResampleStage(taps, UP, DOWN, device="cuda",
                                        **kw).engine == "kernel"
    assert pfc.fir_resample_engine(8, NTAPS, UP, DOWN, len(rtaps), 2 * p,
                                   device="cuda") == "kernel"
    assert pfc.fir_resample_engine(5, NTAPS, UP, DOWN, len(rtaps), 2 * p,
                                   device="cuda") == "composite"
    assert pfc.fir_resample_engine(8, NTAPS, UP, DOWN, len(rtaps), 2 * p,
                                   device="cpu") == "composite"


def test_kernel_stage_rejects_bad_batch():
    taps, rtaps = _design()
    stage = pchain.FusedFirResampleStage(taps, UP, DOWN, rtaps=rtaps,
                                         engine="kernel", device="cpu")
    x = torch.zeros(5, stage.block_multiple)
    with pytest.raises(ValueError, match="channels"):
        stage.apply(x, stage.init_state((5,), device="cpu"))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py's own imports, load
    without JAX and without the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import llzlab_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "llzlab_tpu_torch.__path__, 'llzlab_tpu_torch.')]\n"
        "for needed in ('chains.channelizer', 'parallel.mesh', "
        "'parallel.halo', 'kernels.halo_ring', 'kernels.halo_fir_fused', "
        "'kernels.block2_fir', 'kernels.fused_fir_resample', "
        "'ops.transform', 'utils.checkpoint', 'ops.remez', 'ops.resample', "
        "'utils.config', 'utils.metrics', 'io.wav', 'cli.common', "
        "'cli.fir', 'cli.resample', 'ops.spectral', 'cli.stft', "
        "'cli.channelizer', 'ops.iir', 'ops.iir_matmul', 'ops.iir_select', "
        "'cli.iir', 'ops.convolve', 'ops.signals', 'ops.dct', 'ops.chirpz', "
        "'ops.analysis', 'ops.mdct', 'ops.smooth', 'ops.compat', "
        "'utils.profiling'):\n"
        "    assert 'llzlab_tpu_torch.' + needed in names, needed\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "import scipy.signal\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'llzlab_tpu' or m.startswith('llzlab_tpu.')]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)

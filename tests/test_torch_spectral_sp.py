"""The port's time-sharded STFT → gain → iSTFT (config 4 over the mesh) on
CPU meshes, against the port's unsharded chain and against the JAX
``spectral_gain_sharded`` under ``shard_map`` on the CPU device mesh, at
the shapes of its own tests (``tests/parallel/test_spectral_sp.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from llzlab_tpu.parallel.mesh import CHANNEL_AXIS as RC
from llzlab_tpu.parallel.mesh import TIME_AXIS as RT
from llzlab_tpu.parallel.mesh import make_dsp_mesh as ref_mesh
from llzlab_tpu.parallel.spectral_sp import \
    spectral_gain_sharded as ref_sharded
from llzlab_tpu_torch.ops.spectral import istft, stft
from llzlab_tpu_torch.parallel.mesh import gather, make_dsp_mesh, shard
from llzlab_tpu_torch.parallel.spectral_sp import spectral_gain_sharded
from tests.conftest import snr_db

N_FFT, HOP = 2048, 512
#: the interior against the unsharded chain, unity gain, and the cwola
#: engine against the reference one (tests/parallel/test_spectral_sp.py:
#: 29,40,74); the port against the JAX package (two float32 WOLAs)
INTERIOR_DB, CWOLA_DB, VS_REFERENCE_DB = 130.0, 90.0, 120.0
#: the first n_fft − hop samples against the JAX package: there the
#: envelope is the window's rising taper, and dividing by it scales the
#: rounding of two float32 WOLAs (they read 84 dB on the CPU)
LEADING_DB = 80.0


def _cpu(nc, nt):
    return make_dsp_mesh(nc, nt, devices=["cpu"] * (nc * nt))


def _x(seed, c, t=4 * 4096):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


def _run(x, gain, mesh, **kw):
    return gather(spectral_gain_sharded(shard(torch.from_numpy(x), mesh),
                                        gain, mesh, **kw), mesh).numpy()


def _unsharded(x, gain):
    xt = torch.from_numpy(x)
    return istft(stft(xt, n_fft=N_FFT, hop=HOP) * torch.from_numpy(gain),
                 n_fft=N_FFT, hop=HOP, length=x.shape[-1]).numpy()


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (2, 2)])
def test_matches_unsharded_interior(shape):
    x = _x(111, 8)
    gain = np.ones(1025, np.float32)
    gain[100:200] = 0.25
    y = _run(x, gain, _cpu(*shape))
    ref = _unsharded(x, gain)
    t = x.shape[-1]
    assert snr_db(ref[:, :t - N_FFT], y[:, :t - N_FFT]) >= INTERIOR_DB


def test_unity_gain_reconstructs():
    x = _x(112, 4)
    y = _run(x, np.ones(1025, np.float32), _cpu(2, 4))
    assert snr_db(x[:, 2048:-2048], y[:, 2048:-2048]) >= INTERIOR_DB


def test_notch_kills_tone():
    fs, k = 48000.0, 150
    t = np.arange(4 * 4096) / fs
    x = np.tile(np.sin(2 * np.pi * (k * fs / N_FFT) * t).astype(np.float32),
                (8, 1))
    gain = np.ones(N_FFT // 2 + 1, np.float32)
    gain[140:160] = 0.0
    mid = _run(x, gain, _cpu(2, 4))[:, 4096:-4096]
    assert np.sqrt(np.mean(mid ** 2)) < 1e-3


def test_cwola_engine_matches_reference_engine():
    x = _x(113, 8)
    gain = np.linspace(1.0, 0.25, 1025).astype(np.float32)
    mesh = _cpu(2, 4)
    y_ref = _run(x, gain, mesh, engine="reference")
    assert snr_db(y_ref, _run(x, gain, mesh, engine="cwola")) >= CWOLA_DB
    # "auto" is the reference engine (the faster on the card)
    np.testing.assert_array_equal(_run(x, gain, mesh), y_ref)


def test_a_callable_gain_is_the_static_gain_applied_by_the_call():
    x = _x(114, 4)
    gain = np.linspace(1.0, 0.25, 1025).astype(np.float32)
    g = torch.from_numpy(gain)
    mesh = _cpu(1, 4)
    np.testing.assert_array_equal(_run(x, lambda s: g, mesh),
                                  _run(x, gain, mesh))


def test_rejects_what_the_reference_rejects():
    mesh = _cpu(2, 4)
    with pytest.raises(ValueError, match="cwola"):
        _run(np.zeros((4, 4 * 4096), np.float32), lambda s: 1.0, mesh,
             engine="cwola")
    with pytest.raises(ValueError, match="multiple of hop"):
        _run(np.zeros((4, 4 * 1000), np.float32), np.ones(1025), mesh)


def test_trailing_samples_follow_the_reference():
    """The last ``n_fft − hop`` samples of the stream come from frames
    that see zeros past its end; the envelope divides out what those
    frames add, so they reconstruct those frames' (tapered) signal, not
    the unsharded chain's.  Both packages do this: the port holds every
    sample past the first ``n_fft − hop`` against the JAX function, the
    trailing ones too, and the first ``n_fft − hop`` at their own floor
    (over them the envelope rises with the window's taper, and dividing
    by it scales the rounding of two float32 WOLAs)."""
    x = _x(115, 8)
    gain = np.linspace(1.0, 0.25, 1025).astype(np.float32)
    rmesh = ref_mesh(2, 4)
    ref = np.asarray(ref_sharded(jax.device_put(
        jnp.asarray(x), NamedSharding(rmesh, P(RC, RT))), gain, rmesh))
    got = _run(x, gain, _cpu(2, 4))
    ov = N_FFT - HOP
    tail = slice(x.shape[-1] - ov, None)
    assert snr_db(ref[:, ov:], got[:, ov:]) >= VS_REFERENCE_DB
    assert snr_db(ref[:, :ov], got[:, :ov]) >= LEADING_DB
    assert snr_db(ref[:, tail], got[:, tail]) >= VS_REFERENCE_DB
    # ... and they are not the unsharded chain's
    assert snr_db(_unsharded(x, gain)[:, tail], got[:, tail]) < 60.0

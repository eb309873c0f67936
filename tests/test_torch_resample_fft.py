"""The port's FFT ``resample``, ``decimate`` and ``resample_halo``, and
config 2's preset (``configs/resample_8ch.json``), against the JAX package
and scipy on the CPU."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

import llzlab_tpu as rlz
from llzlab_tpu.ops import resample as rrs
from llzlab_tpu.utils import config as rcfg
import llzlab_tpu_torch as lt
from llzlab_tpu_torch.ops import resample as prs
from llzlab_tpu_torch.pipeline import Chain, ResampleStage
from llzlab_tpu_torch.utils import config as pcfg
from tests.conftest import snr_db

#: f32 FFTs (pocketfft here, XLA's in the JAX package) of the same spectrum
#: surgery against each other, and against scipy's float64: measured
#: 132-136 dB at these sizes
VS_REF_DB = 125.0
#: polyphase decimation against scipy.signal.upfirdn in float64
VS_UPFIRDN_DB = 110.0
ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("num", [441, 999, 1000, 1337, 2048])
@pytest.mark.parametrize("window", [None, "hann", ("kaiser", 8.0)])
def test_resample_matches_reference_and_scipy(num, window):
    x = np.random.default_rng(num).standard_normal((3, 1000))
    x32 = x.astype(np.float32)
    y = lt.resample(torch.from_numpy(x32), num, window=window)
    assert y.shape == (3, num) and y.dtype == torch.float32
    ref = np.asarray(rlz.resample(jnp.asarray(x32), num, window=window))
    assert snr_db(ref, y.numpy()) >= VS_REF_DB
    golden = ss.resample(x32.astype(np.float64), num, axis=-1, window=window)
    assert snr_db(golden, y.numpy()) >= VS_REF_DB


def test_resample_keeps_the_dtype_and_leading_axes():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 2, 300)))
    y = prs.resample(x, 150)
    assert y.shape == (2, 2, 150) and y.dtype == torch.float64


@pytest.mark.parametrize("q,k", [(2, 64), (4, 64), (3, 16)])
def test_decimate_matches_reference_and_upfirdn(q, k):
    x = np.random.default_rng(10 + q).standard_normal((2, 40 * q + 7))
    x32 = x.astype(np.float32)
    y = lt.decimate(torch.from_numpy(x32), q, taps_per_phase=k)
    ref = np.asarray(rlz.decimate(jnp.asarray(x32), q, taps_per_phase=k))
    assert y.shape == ref.shape == (2, -(-x.shape[1] // q))
    assert snr_db(ref, y.numpy()) >= VS_REF_DB
    h = prs.resample_taps(1, q, k)
    golden = ss.upfirdn(h, x32.astype(np.float64), 1, q, axis=-1)
    assert snr_db(golden[:, :y.shape[1]], y.numpy()) >= VS_UPFIRDN_DB


def test_resample_halo_equal():
    for k in (8, 16, 64):
        assert prs.resample_halo(k) == rrs.resample_halo(k) == k - 1


@pytest.mark.parametrize("name", ["fir_lowpass_1ch", "resample_8ch",
                                  "iir_eq_64ch", "stft_gain_256ch",
                                  "channelizer_1024ch"])
def test_presets_and_config_files_equal_the_reference(name):
    text = (ROOT / "configs" / f"{name}.json").read_text()
    p, r = pcfg.from_json(text), rcfg.from_json(text)
    assert json.loads(pcfg.to_json(p)) == json.loads(rcfg.to_json(r))
    assert pcfg.to_json(pcfg.PRESETS[name]) == rcfg.to_json(rcfg.PRESETS[name])
    assert pcfg.from_json(pcfg.to_json(p)) == p


def test_config2_stage_from_its_file_against_upfirdn():
    """Config 2's stage built from its file: 147/160, K = 64, β = 8 (the
    taps of resample_taps), two blocks streamed against upfirdn."""
    cfg = pcfg.from_json((ROOT / "configs" / "resample_8ch.json").read_text())
    rc = cfg.resample
    assert (cfg.channels, rc.up, rc.down, rc.taps_per_phase,
            rc.kaiser_beta) == (8, 147, 160, 64, 8.0)
    chain = Chain([ResampleStage(rc.up, rc.down,
                                 taps_per_phase=rc.taps_per_phase)])
    x = np.random.default_rng(20).standard_normal(
        (cfg.channels, 4 * rc.down * 10)).astype(np.float32)
    xt = torch.from_numpy(x)
    n = x.shape[1] // 2
    y = torch.cat(list(chain.stream([xt[:, :n], xt[:, n:]])), -1)
    assert torch.equal(y, chain(xt))
    h = prs.resample_taps(rc.up, rc.down, rc.taps_per_phase,
                          window=("kaiser", rc.kaiser_beta))
    golden = ss.upfirdn(h, x.astype(np.float64), rc.up, rc.down, axis=-1)
    assert snr_db(golden[:, :y.shape[1]], y.numpy()) >= VS_UPFIRDN_DB

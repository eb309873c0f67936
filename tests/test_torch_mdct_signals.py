"""The port's ``ops/mdct.py`` and ``ops/signals.py`` against the JAX
package on the CPU: the window, the MDCT matrix and every test signal bit
for bit, the transforms by SNR."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llzlab_tpu.ops import signals as rsg
from llzlab_tpu_torch.ops import signals as psg
from tests.test_torch_transform import snr_db

rmd = importlib.import_module("llzlab_tpu.ops.mdct")
pmd = importlib.import_module("llzlab_tpu_torch.ops.mdct")

#: the JAX package's floor for the MDCT against float64 and for its
#: reconstruction away from the first and last N (tests/ops/test_mdct.py:15)
MDCT_DB = 110.0


def test_window_and_matrix_bit_equal():
    for n in (16, 256, 960):
        assert np.array_equal(pmd.sine_window(2 * n), rmd.sine_window(2 * n))
        assert np.array_equal(pmd.mdct_matrix(n), rmd.mdct_matrix(n))


@pytest.mark.parametrize("n,window", [(256, "sine"), (240, "hann")])
def test_mdct_matches_reference_and_reconstructs(n, window):
    x = np.random.default_rng(n).standard_normal((2, n * 10)).astype(
        np.float32)
    S = pmd.mdct(torch.from_numpy(x), n, window=window)
    ref = np.asarray(rmd.mdct(jnp.asarray(x), n, window=window))
    assert S.shape == ref.shape == (2, 9, n) and S.dtype == torch.float32
    assert snr_db(ref, S.numpy()) >= MDCT_DB
    if window == "sine":
        frame = x[0, 3 * n:5 * n].astype(np.float64) * pmd.sine_window(2 * n)
        assert snr_db(pmd.mdct_matrix(n) @ frame, S[0, 3].numpy()) >= MDCT_DB
    y = pmd.imdct(S, window=window, length=x.shape[-1])
    ref_y = np.asarray(rmd.imdct(jnp.asarray(ref), window=window,
                                 length=x.shape[-1]))
    assert y.shape == x.shape
    assert snr_db(ref_y, y.numpy()) >= MDCT_DB
    if window == "sine":  # Princen-Bradley: perfect reconstruction
        assert snr_db(x[:, n:-n], y[:, n:-n].numpy()) >= MDCT_DB


def test_mdct_float64_input_and_length_check():
    x = np.random.default_rng(5).standard_normal(64 * 6)
    S = pmd.mdct(torch.from_numpy(x), 64)
    assert S.dtype == torch.float32
    assert snr_db(np.asarray(rmd.mdct(x, 64)), S.numpy()) >= MDCT_DB
    with pytest.raises(ValueError, match="multiple"):
        rmd.mdct(np.zeros(1000, np.float32), 256)
    with pytest.raises(ValueError, match="multiple"):
        pmd.mdct(torch.zeros(1000), 256)


SIGNALS = [
    ("tone", (1000.0, 0.01, 48000.0), dict(amp=0.5, phase=0.3)),
    ("multitone", ([100.0, 3000.0, 9000.0], 0.01, 48000.0), {}),
    ("multitone", ([100.0, 200.0], 0.01, 8000.0), dict(amps=[0.2, 0.7])),
    ("white_noise", (777,), dict(seed=3, amp=0.1)),
    ("pink_noise", (1000,), dict(seed=4)),
    ("pink_noise", (1001,), {}),
    ("noisy_tones", ([440.0, 5000.0], 0.02, 48000.0), dict(snr_db=30.0,
                                                             seed=5)),
]
T = np.linspace(0.0, 1.0, 777)
for method in ("linear", "quadratic", "logarithmic", "hyperbolic"):
    SIGNALS.append(("chirp", (T, 10.0, 1.0, 400.0), dict(method=method,
                                                         phi=30.0)))
SIGNALS += [("chirp", (T, 50.0, 1.0, 50.0), dict(method="log")),
            ("square", (T * 40,), dict(duty=0.3)),
            ("sawtooth", (T * 40,), dict(width=0.5)),
            ("sawtooth", (T * 40,), {}),
            ("gausspulse", (T - 0.5,), dict(fc=20.0, bw=0.4))]


@pytest.mark.parametrize("i", range(len(SIGNALS)))
def test_signals_bit_equal(i):
    name, args, kw = SIGNALS[i]
    got = getattr(psg, name)(*args, **kw)
    want = getattr(rsg, name)(*args, **kw)
    assert got.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("name,args,kw", [
    ("chirp", (T, 0.0, 1.0, 10.0), dict(method="log")),
    ("chirp", (T, 0.0, 1.0, 10.0), dict(method="hyperbolic")),
    ("chirp", (T, 1.0, 1.0, 2.0), dict(method="cubic")),
    ("gausspulse", (T,), dict(bw=-1.0))])
def test_signals_reject_what_the_reference_rejects(name, args, kw):
    for module in (rsg, psg):
        with pytest.raises(ValueError):
            getattr(module, name)(*args, **kw)

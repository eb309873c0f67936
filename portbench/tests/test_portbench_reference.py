"""The plain reference against scipy.signal in float64 at small sizes."""

import numpy as np
import pytest
import torch
from scipy import signal

from portbench import reference

RNG = np.random.default_rng(7)


def test_fir_matches_lfilter():
    h = signal.firwin(129, 0.3)
    x = RNG.standard_normal((3, 2000))
    y = reference.fir_valid(torch.from_numpy(x), h).numpy()
    want = signal.lfilter(h, 1.0, x)[:, 128:]
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("up,down,k", [(147, 160, 8), (3, 4, 16),
                                       (1, 2, 5)])
def test_resample_matches_upfirdn(up, down, k):
    h = signal.firwin(up * k, 1.0 / max(up, down)) * up
    x = RNG.standard_normal((2, down * 40))
    hist = np.zeros((2, k - 1))
    z = reference.resample(torch.from_numpy(np.concatenate([hist, x], 1)),
                           h, up, down).numpy()
    want = signal.upfirdn(h, x, up, down)[:, :x.shape[1] * up // down]
    np.testing.assert_allclose(z, want, rtol=0, atol=1e-12)


def test_chain_matches_scipy_and_streams():
    fir = signal.firwin(65, 0.4)
    rs = signal.firwin(3 * 8, 1 / 4) * 3
    up, down, n = 3, 4, 32
    x = RNG.standard_normal((2, 4 * 256))
    y = signal.lfilter(fir, 1.0, x)
    z = signal.upfirdn(rs, y, up, down)[:, :x.shape[1] * up // down]
    want = np.fft.rfft(z.reshape(2, -1, n), axis=-1)
    h = reference.channelizer_history(fir, rs, up)
    ctx = np.concatenate([np.zeros((2, h)), x], 1)
    got = reference.channelizer(torch.from_numpy(ctx), fir, rs, up, down,
                                n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)
    # two steps, the second behind the first's last h samples
    a, b = x[:, :512], x[:, 512:]
    s1 = reference.channelizer(torch.from_numpy(np.concatenate(
        [np.zeros((2, h)), a], 1)), fir, rs, up, down, n).numpy()
    s2 = reference.channelizer(torch.from_numpy(np.concatenate(
        [a[:, -h:], b], 1)), fir, rs, up, down, n).numpy()
    np.testing.assert_allclose(np.concatenate([s1, s2], 1), want, rtol=0,
                               atol=1e-11)


def test_rounding_keeps_the_formats_bits():
    x = torch.from_numpy(RNG.standard_normal(10000))
    for rounding, bits in (("bf16", 8), ("tf32", 11)):
        r = reference.round_to(x, rounding)
        rel = ((r - x).abs() / x.abs()).max().item()
        assert 2.0 ** -(bits + 1) * 0.5 < rel <= 2.0 ** -bits
    assert torch.equal(reference.round_to(x, None), x)
    with pytest.raises(ValueError):
        reference.round_to(x, "fp8")

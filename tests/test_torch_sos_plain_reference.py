"""The port's IIR cascade on its normal path, ``Chain([SOSStage])``
streamed in blocks, against the plain float64 reference of the cascade
(``tests/sos_reference.py``, which imports nothing of the port), on
seeded designs and seeded data; the reference against scipy.signal in
float64; and the truncated history that the benchmark's check of a block
rests on."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from llzlab_tpu_torch.ops.iir import butter_sos, peaking_eq_sos
from llzlab_tpu_torch.pipeline.chain import Chain, SOSStage
from tests import sos_reference
from tests.conftest import snr_db

#: two float32 scans of the EQ against float64 (tests/test_torch_iir_scan.py)
EQ_DB = 120.0
#: the config's EQ (configs/iir_eq_64ch.json)
EQ = peaking_eq_sos([100, 200, 400, 800, 1600, 3200, 6400, 12800],
                    [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0)


def _seeded_eq(seed: int, sections: int = 6) -> np.ndarray:
    """Peaking sections at centres drawn log-uniformly over 60 Hz to 16 kHz,
    gains over ±6 dB, Q over 0.7 to 2, at 48 kHz."""
    rng = np.random.default_rng(seed)
    freqs = np.exp(rng.uniform(np.log(60.0), np.log(16000.0), sections))
    return np.concatenate([
        peaking_eq_sos([f], [g], 48000.0, q=q) for f, g, q in zip(
            freqs, rng.uniform(-6, 6, sections), rng.uniform(0.7, 2.0,
                                                             sections))])


def _x(c, t, seed):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


@pytest.mark.parametrize("design,seed", [("config", 31), ("seeded", 32),
                                         ("seeded", 33)])
def test_the_streamed_chain_against_the_plain_reference(design, seed):
    sos = EQ if design == "config" else _seeded_eq(seed)
    block, blocks = 512, 5
    x = _x(3, block * blocks, seed)
    chain = Chain([SOSStage(sos, block_size=block)])
    state = chain.init_state((3,), device="cpu")
    out = []
    for j in range(blocks):
        y, state = chain.apply(torch.from_numpy(
            x[:, j * block:(j + 1) * block]), state)
        out.append(y)
    want, _ = sos_reference.sosfilt(sos, torch.from_numpy(x))
    assert snr_db(want.numpy(), torch.cat(out, dim=-1).numpy()) >= EQ_DB


@pytest.mark.parametrize("design", ["config", "seeded", "butter5"])
def test_the_reference_against_scipy_float64(design):
    sos = {"config": EQ, "seeded": _seeded_eq(34),
           "butter5": butter_sos(5, 0.2)}[design]
    x = np.random.default_rng(35).standard_normal((3, 1500))
    zi = np.random.default_rng(36).standard_normal((len(sos), 3, 2))
    want, want_zf = ss.sosfilt(sos, x, axis=-1, zi=zi)
    y, zf = sos_reference.sosfilt(sos, torch.from_numpy(x),
                                  torch.from_numpy(zi.transpose(1, 0, 2)))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(zf.numpy(), want_zf.transpose(1, 0, 2),
                               rtol=0, atol=1e-12)


def test_doubling_the_history_changes_a_block_by_under_1e_14():
    """What the ``H`` samples more of a doubled history add to a block is,
    the cascade being linear, the block's response to those samples alone:
    under 1e-14 of the block.  The two references computed outright differ
    by more, by float64 rounding carried through poles near the unit
    circle (about 1e-13 here, the same at 1.5, 2 and 3 times ``H``)."""
    hist = sos_reference.history_len(EQ)
    r = sos_reference.pole_radius(EQ)
    assert r ** hist < 1e-17 <= r ** (hist - 1)
    block = 256
    x = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (2, 2 * hist + block)))
    short, _ = sos_reference.sosfilt(EQ, x[:, hist:])
    long, _ = sos_reference.sosfilt(EQ, x)
    early = x.clone()
    early[:, hist:] = 0.0  # only the samples the doubling adds
    added, _ = sos_reference.sosfilt(EQ, early)
    b = long[:, -block:]
    assert float(added[:, -block:].norm() / b.norm()) < 1e-14
    assert float((short[:, -block:] - b).norm() / b.norm()) < 1e-12

"""The port's blockwise-scan ``sosfilt`` on the CPU: against scipy float64
at the JAX package's floors (tests/ops/test_iir.py), against the JAX
package's ``sosfilt`` on the same seeded input, streamed splits at
multiples of the block bit for bit (outputs and states), a JAX ``zf``
resumed in the port, and the front doors ``lfilter``, ``filtfilt`` and
``sosfiltfilt`` against the JAX package's."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from llzlab_tpu.ops import iir as riir
from llzlab_tpu_torch.ops import iir as piir
from tests.conftest import snr_db

EQ = piir.peaking_eq_sos([100, 200, 400, 800, 1600, 3200, 6400, 12800],
                         [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0)
#: odd order: one real-pole section (the companion form)
BUTTER7 = piir.butter_sos(7, 0.3)
#: against scipy float64: the coupled-form EQ and a real-pole design
#: (tests/ops/test_iir.py:64,71); two float32 scans of the EQ against each
#: other, and the same EQ at two block sizes (:120)
EQ_DB, REAL_POLE_DB, VS_JAX_DB = 120.0, 100.0, 120.0
#: the port's states against the JAX package's (see the test)
STATES_VS_JAX_DB = 110.0


def _x(c, t, seed):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


@pytest.mark.parametrize("design,floor", [
    ("eq", EQ_DB), ("butter7", REAL_POLE_DB),
    ("real_pole_row", REAL_POLE_DB)])
def test_sosfilt_against_scipy_float64(design, floor):
    sos = {"eq": EQ, "butter7": BUTTER7,
           "real_pole_row": np.array([[0.5, 0.2, 0.1, 1.0, -1.1, 0.3]])}[
               design]
    x = _x(4, 12000, 11)
    y = piir.sosfilt(sos, torch.from_numpy(x), block_size=1024)
    ref = ss.sosfilt(sos, x.astype(np.float64), axis=-1)
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert snr_db(ref, y.numpy()) >= floor


def _states_f64(sos, x):
    """The sections' final states in their scan realization, by the
    serial float64 recurrence written from ``section_realization``."""
    cur, out = x.astype(np.float64), []
    for row in sos:
        kind, p = riir.section_realization(row)
        if kind == "coupled":
            alpha, beta, c1, c2, b0 = p
            P, u, c = [[alpha, -beta], [beta, alpha]], [1.0, 0.0], [c1, c2]
        else:
            b0, b1, b2, _, a1, a2 = row
            P, u, c = ([[-a1, 1.0], [-a2, 0.0]],
                       [b1 - a1 * b0, b2 - a2 * b0], [1.0, 0.0])
        P, u, c = np.asarray(P), np.asarray(u), np.asarray(c)
        s, y = np.zeros((cur.shape[0], 2)), np.empty_like(cur)
        for n in range(cur.shape[1]):
            y[:, n] = b0 * cur[:, n] + s @ c
            s = s @ P.T + np.outer(cur[:, n], u)
        out.append(s)
        cur = y
    return np.stack(out, 1)


def test_sosfilt_against_the_jax_package_with_states():
    """Config 3's EQ on 4 channels with a ragged tail: outputs against the
    JAX package's scan, states (the same realization) against a float64
    recurrence and against the JAX package's.  The JAX package's states
    are the less accurate here (they fall below the float64 floor, most
    in the first section, whose pole sits nearest the unit circle), hence
    the lower floor between the two."""
    x = _x(4, 8192 + 300, 12)
    y, zf = piir.sosfilt(EQ, torch.from_numpy(x), block_size=1024,
                         return_zf=True)
    ry, rzf = riir.sosfilt(EQ, x, block_size=1024, return_zf=True)
    assert zf.shape == (4, 8, 2)
    assert snr_db(np.asarray(ry), y.numpy()) >= VS_JAX_DB
    assert snr_db(_states_f64(EQ, x), zf.numpy()) >= EQ_DB
    assert snr_db(np.asarray(rzf), zf.numpy()) >= STATES_VS_JAX_DB


@pytest.mark.parametrize("design", ["eq", "butter7"])
@pytest.mark.parametrize("cuts", [(2048,), (1024, 5120), (512, 3584)])
def test_split_streams_are_bitwise_one_shot(design, cuts):
    """2-way and 3-way splits at multiples of the block, states carried:
    the joined outputs and the final states equal one shot bit for bit
    (the last piece ragged)."""
    sos = EQ if design == "eq" else BUTTER7
    x = torch.from_numpy(_x(3, 6 * 1024 + 77, 15))
    one, zf = piir.sosfilt(sos, x, block_size=512, return_zf=True)
    parts, zi = [], None
    for a, b in zip((0,) + cuts, cuts + (x.shape[1],)):
        y, zi = piir.sosfilt(sos, x[:, a:b], zi=zi, block_size=512,
                             return_zf=True)
        parts.append(y)
    assert torch.equal(torch.cat(parts, -1), one)
    assert torch.equal(zi, zf)


def test_block_size_invariance():
    x = torch.from_numpy(_x(2, 16384, 17))
    y1 = piir.sosfilt(EQ, x, block_size=256)
    y2 = piir.sosfilt(EQ, x, block_size=1024)
    assert snr_db(y1.numpy(), y2.numpy()) >= EQ_DB


@pytest.mark.parametrize("design,floor", [("eq", EQ_DB),
                                          ("butter7", REAL_POLE_DB)])
def test_a_jax_state_resumes_in_the_port(design, floor):
    """The JAX package filters the first half and returns its states; the
    port continues from them: the second half against scipy float64 run
    over the whole signal."""
    sos = EQ if design == "eq" else BUTTER7
    x = _x(2, 8192, 18)
    _, zf = riir.sosfilt(sos, x[:, :4096], block_size=1024, return_zf=True)
    y = piir.sosfilt(sos, torch.from_numpy(x[:, 4096:]),
                     zi=torch.from_numpy(np.array(zf)), block_size=1024)
    ref = ss.sosfilt(sos, x.astype(np.float64), axis=-1)[:, 4096:]
    assert snr_db(ref, y.numpy()) >= floor


def test_apply_section_state_at_any_index_is_the_prefix_state():
    """``apply_section(…, zf_index=k)`` gives bitwise the state a call on
    the first k + 1 samples returns, for each realization (the zero-state
    scan of a sample reads only the samples before it)."""
    x = torch.from_numpy(_x(2, 3000, 19))
    for sos in (EQ[:1], BUTTER7[-1:]):
        kinds, params = piir.sos_plan(sos)
        s0 = torch.from_numpy(_x(2, 2, 20))
        for k in (0, 700, 1023, 2999):
            _, zf = piir.apply_section(kinds[0], params[0], x, s0, 1024,
                                       zf_index=k)
            _, zpre = piir.sosfilt(sos, x[:, :k + 1], zi=s0[:, None],
                                   block_size=1024, return_zf=True)
            assert torch.equal(zf, zpre[:, 0])


def test_shapes_dtypes_and_an_empty_signal():
    x = torch.from_numpy(_x(6, 900, 21)).reshape(2, 3, 900)
    y, zf = piir.sosfilt(EQ, x.double(), block_size=256, return_zf=True)
    assert y.dtype == torch.float64 and y.shape == (2, 3, 900)
    assert zf.dtype == torch.float32 and zf.shape == (2, 3, 8, 2)
    y1 = piir.sosfilt(EQ, x[0, 0], block_size=256)
    assert torch.equal(y1, y[0, 0].float())
    zi = torch.ones((3, 8, 2))
    y0, z0 = piir.sosfilt(EQ, torch.zeros((3, 0)), zi=zi, return_zf=True)
    assert y0.shape == (3, 0) and torch.equal(z0, zi)


@pytest.mark.parametrize("which", ["lfilter_iir", "lfilter_fir",
                                   "filtfilt_iir", "filtfilt_fir",
                                   "sosfiltfilt"])
def test_front_doors_match_the_jax_package(which):
    x = _x(2, 6000, 22)
    b, a = ss.butter(4, 0.25)
    taps = ss.firwin(63, 0.3)
    xt = torch.from_numpy(x)
    if which == "lfilter_iir":
        y = piir.lfilter(b, a, xt, block_size=1024)
        ref = riir.lfilter(b, a, x, block_size=1024)
    elif which == "lfilter_fir":
        y = piir.lfilter(taps, [2.0], xt)
        ref = riir.lfilter(taps, [2.0], x)
    elif which == "filtfilt_iir":
        y = piir.filtfilt(b, a, xt, block_size=1024)
        ref = riir.filtfilt(b, a, x, block_size=1024)
    elif which == "filtfilt_fir":
        y = piir.filtfilt(taps, [1.0], xt)
        ref = riir.filtfilt(taps, [1.0], x)
    else:
        y = piir.sosfiltfilt(EQ, xt, block_size=1024)
        ref = riir.sosfiltfilt(EQ, x, block_size=1024)
    assert y.shape == x.shape
    assert snr_db(np.asarray(ref), y.numpy()) >= VS_JAX_DB


def test_lfilter_carries_states_like_sosfilt():
    b, a = ss.cheby1(4, 1.0, 0.3)
    x = torch.from_numpy(_x(2, 4096, 23))
    y, zf = piir.lfilter(b, a, x, block_size=1024, return_zf=True)
    y2, zf2 = piir.sosfilt(piir.tf2sos(b, a), x, block_size=1024,
                           return_zf=True)
    assert torch.equal(y, y2) and torch.equal(zf, zf2)
    ref = ss.lfilter(b, a, x.double().numpy(), axis=-1)
    assert snr_db(ref, y.numpy()) >= REAL_POLE_DB

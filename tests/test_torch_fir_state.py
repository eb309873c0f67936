"""The streaming history of ``fir_filter``'s default engine: ``zi`` sized
by ``fir_state_len(ntaps, None, "auto")`` is the history that
``fir_filter(method="auto")`` runs with (block2 up to 2048 taps, else ols),
so a stream resumes from it bit for bit; a longer ``zi`` is taken by its
last samples; the one-shot output agrees with the JAX package's
``fir_filter`` on the CPU (whose "auto" is direct up to 128 taps, else
ols)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llzlab_tpu.ops import fir as rfir
from llzlab_tpu_torch.ops import fir as pfir
from tests.conftest import snr_db

#: tap counts on both sides of every engine boundary: 128 (block 128),
#: 129 (block 256), the 2048-tap limit of "auto"'s block2
NTAPS = [1, 2, 127, 128, 129, 255, 1024, 2048, 2049, 4096]
#: the floor of tests/test_torch_fir_engines.py:173 against the JAX package
VS_REF_DB = 120.0
CHANNELS = 2


def _taps(ntaps: int) -> np.ndarray:
    return np.random.default_rng(ntaps).standard_normal(ntaps) / np.sqrt(
        ntaps)


def _hop(ntaps: int) -> int:
    """The grid a stream splits on: the block, or the overlap-save hop."""
    if pfir.resolve_method("auto", ntaps) == "block2":
        return pfir.block2_block(ntaps)
    return pfir.ols_hop(ntaps, pfir.default_nfft(ntaps))


def _signal(ntaps: int):
    """A few thousand samples on the block grid, at least six of its
    steps."""
    hop = _hop(ntaps)
    n = max(6, -(-3000 // hop))
    return np.random.default_rng(100 + ntaps).standard_normal(
        (CHANNELS, n * hop)).astype(np.float32), hop


@pytest.mark.parametrize("ntaps", NTAPS)
def test_auto_state_length_is_the_resolved_engines(ntaps):
    engine = pfir.resolve_method("auto", ntaps)
    assert pfir.fir_state_len(ntaps, None, "auto") == \
        pfir.fir_state_len(ntaps, None, engine)
    assert engine == ("block2" if ntaps <= 2048 else "ols")
    x, _ = _signal(ntaps)
    _, zf = pfir.fir_filter(torch.from_numpy(x), _taps(ntaps),
                            return_zf=True)
    assert zf.shape == (CHANNELS, pfir.fir_state_len(ntaps, None, "auto"))


@pytest.fixture
def one_thread():
    """The CPU's libraries on one thread.  MKL splits a call over its
    threads by the call's batch, so that on several threads an FFT of a
    few frames takes another sum order than the same frames in a longer
    batch: there ols streamed equals one shot only on one thread (block2
    on several too).  A product of two rows (one block of two channels)
    takes another order on one thread as well, so every piece below holds
    two or more steps of the grid."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("ntaps", NTAPS)
def test_auto_streams_from_its_state_bitwise(ntaps, one_thread):
    """Two and three pieces on the engine's grid, the first from a zeroed
    ``zi`` of ``fir_state_len(ntaps, None, "auto")`` samples, equal one
    shot bit for bit."""
    taps = _taps(ntaps)
    x, hop = _signal(ntaps)
    n = x.shape[-1] // hop
    xt = torch.from_numpy(x)
    hlen = pfir.fir_state_len(ntaps, None, "auto")
    one = pfir.fir_filter(xt, taps)
    for cuts in ([n - 2], [2, n - 2]):
        edges = [0] + [c * hop for c in cuts] + [x.shape[-1]]
        st = torch.zeros((CHANNELS, hlen))
        pieces = []
        for a, b in zip(edges, edges[1:]):
            y, st = pfir.fir_filter(xt[:, a:b], taps, zi=st, return_zf=True)
            assert st.shape == (CHANNELS, hlen)
            pieces.append(y)
        assert torch.equal(torch.cat(pieces, -1), one), cuts


@pytest.mark.parametrize("ntaps", NTAPS)
def test_a_longer_zi_is_taken_by_its_last_samples(ntaps):
    taps = _taps(ntaps)
    x, _ = _signal(ntaps)
    hlen = pfir.fir_state_len(ntaps, None, "auto")
    rng = np.random.default_rng(7)
    zi = torch.from_numpy(rng.standard_normal(
        (CHANNELS, hlen + 37)).astype(np.float32))
    xt = torch.from_numpy(x)
    y, zf = pfir.fir_filter(xt, taps, zi=zi, return_zf=True)
    want, zf_want = pfir.fir_filter(xt, taps, zi=zi[:, 37:], return_zf=True)
    assert torch.equal(y, want) and torch.equal(zf, zf_want)


@pytest.mark.parametrize("ntaps", NTAPS)
def test_auto_one_shot_agrees_with_the_jax_package(ntaps):
    taps = _taps(ntaps)
    x, _ = _signal(ntaps)
    ref = np.asarray(rfir.fir_filter(jnp.asarray(x), taps))
    got = pfir.fir_filter(torch.from_numpy(x), taps).numpy()
    assert got.shape == ref.shape
    assert snr_db(ref, got) >= VS_REF_DB

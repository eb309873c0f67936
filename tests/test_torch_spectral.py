"""The port's ``ops/spectral.py`` against the JAX package's on the CPU, at
small shapes: framing and overlap-add exactly, STFT / iSTFT, the frame-free
engines and their host tables, and the inputs where the JAX package
returns a wrong result and the port raises.  Also ``precision_scope``."""

import numpy as np
import pytest
import torch

from llzlab_tpu.ops import spectral as rsp
from llzlab_tpu_torch.ops import spectral as psp
from llzlab_tpu_torch.ops import transform as ptf
from llzlab_tpu_torch.runtime import platform
from tests.conftest import snr_db

N_FFT, HOP = 256, 64
#: STFT against the JAX package's: two f32 FFT libraries (pocketfft in
#: both, but XLA's and PyTorch's builds, and the window multiply fused
#: differently), 110 dB; iSTFT adds the envelope division, 130 dB (both
#: the floors the port is held to)
STFT_DB, ISTFT_DB = 110.0, 130.0
#: the dense-table engines: one f32 product here against the JAX package's
#: per-hop-chunk einsums, another sum order of the same f32 tables
ENGINE_DB = 120.0
#: the first and last n_fft - hop samples of an iSTFT divide by the
#: window-square envelope's taper, which amplifies any f32 rounding by up
#: to 40 dB: the JAX package's own round-trip claim holds away from them
OV = N_FFT - HOP
#: iSTFT against the JAX package's over every sample, edges included (these
#: inputs read 108.2 dB for "auto", 123.0 for "wdft")
WHOLE_DB = 90.0


def _snr(ref, y) -> float:
    """snr_db for real or complex arrays."""
    ref = np.asarray(ref).astype(np.complex128)
    perr = np.sum(np.abs(ref - np.asarray(y).astype(np.complex128)) ** 2)
    if perr == 0.0:
        return float("inf")
    return 10.0 * np.log10(np.sum(np.abs(ref) ** 2) / perr)


def _x(seed, c=2, t=4096):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 4096), (512, 128, 4200),
                                         (8, 2, 9)])
def test_frame_and_overlap_add_equal_the_reference(n_fft, hop, t):
    x = _x(1, 3, t)
    got = psp.frame(torch.from_numpy(x), n_fft, hop)
    ref = np.asarray(rsp.frame(x, n_fft, hop))
    np.testing.assert_array_equal(got.numpy(), ref)
    frames = np.random.default_rng(2).standard_normal(ref.shape).astype(
        np.float32)
    np.testing.assert_array_equal(
        psp.overlap_add(torch.from_numpy(frames), hop).numpy(),
        np.asarray(rsp.overlap_add(frames, hop)))


@pytest.mark.parametrize("method", ["auto", "wdft"])
def test_stft_and_istft_match_the_reference(method):
    x = _x(3)
    spec = psp.stft(torch.from_numpy(x), n_fft=N_FFT, hop=HOP, method=method)
    ref = np.asarray(rsp.stft(x, n_fft=N_FFT, hop=HOP, method=method))
    assert spec.dtype == torch.complex64 and spec.shape == ref.shape
    assert _snr(ref, spec.numpy()) >= STFT_DB
    # both inverses of the same spectrum
    y = psp.istft(torch.from_numpy(np.array(ref)), n_fft=N_FFT, hop=HOP,
                  method=method, length=x.shape[-1])
    ref_y = np.asarray(rsp.istft(ref, n_fft=N_FFT, hop=HOP, method=method,
                                 length=x.shape[-1]))
    assert y.shape == ref_y.shape == x.shape
    assert snr_db(ref_y[:, OV:-OV], y.numpy()[:, OV:-OV]) >= ISTFT_DB
    assert snr_db(ref_y, y.numpy()) >= WHOLE_DB
    # and the port's round trip reconstructs the interior
    y = psp.istft(spec, n_fft=N_FFT, hop=HOP, method=method)
    assert snr_db(x[:, OV:-OV], y.numpy()[:, OV:-OV]) >= ISTFT_DB


@pytest.mark.parametrize("inverse", [False, True])
def test_wdft_tables_are_bit_equal(inverse):
    for a, b in zip(psp._wdft_tables(N_FFT, HOP, "hann", inverse),
                    rsp._wdft_tables(N_FFT, HOP, "hann", inverse)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_cwola_tables_are_bit_equal():
    gain = np.linspace(1.0, 0.25, N_FFT // 2 + 1).astype(np.float64)
    a = psp._cwola_tables(N_FFT, HOP, "hamming", gain.tobytes())
    b = rsp._cwola_tables(N_FFT, HOP, "hamming", gain.tobytes())
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_frame_free_engines_match_the_reference():
    x = _x(4, 3)
    xt = torch.from_numpy(x)
    spec = psp.windowed_rdft(xt, N_FFT, HOP)
    ref = np.asarray(rsp.windowed_rdft(x, N_FFT, HOP))
    assert spec.shape == ref.shape
    assert _snr(ref, spec.numpy()) >= ENGINE_DB
    y = psp.windowed_irdft_ola(torch.from_numpy(np.array(ref)), N_FFT, HOP)
    ref_y = np.asarray(rsp.windowed_irdft_ola(ref, N_FFT, HOP))
    assert y.shape == ref_y.shape
    assert snr_db(ref_y, y.numpy()) >= ENGINE_DB
    nf = psp.stft_num_frames(x.shape[-1], N_FFT, HOP)
    mask = (np.arange(nf) >= 2).astype(np.float32)
    gain = np.linspace(1.5, 0.1, N_FFT // 2 + 1)
    got = psp.composed_wola(xt, torch.from_numpy(mask), N_FFT, HOP, "hann",
                            gain)
    ref_c = np.asarray(rsp.composed_wola(x, mask, N_FFT, HOP, "hann", gain))
    assert got.shape == ref_c.shape
    assert snr_db(ref_c, got.numpy()) >= ENGINE_DB


@pytest.mark.parametrize("what", ["windowed_rdft", "windowed_irdft_ola",
                                  "composed_wola", "stft"])
def test_odd_n_fft_raises_where_the_reference_is_wrong(what):
    """The JAX package's dense tables assume an even n_fft and return a
    wrong result for an odd one (about 15 dB off at n_fft = 9); the port
    raises."""
    n, hop = 9, 3
    x = torch.zeros((1, 27))
    calls = {
        "windowed_rdft": lambda: psp.windowed_rdft(x, n, hop),
        "windowed_irdft_ola": lambda: psp.windowed_irdft_ola(
            torch.zeros((1, 7, 5), dtype=torch.complex64), n, hop),
        "composed_wola": lambda: psp.composed_wola(
            x, torch.ones(7), n, hop, "hann", np.ones(5)),
        "stft": lambda: psp.stft(x, n_fft=n, hop=hop, method="wdft"),
    }
    with pytest.raises(ValueError, match="even n_fft"):
        calls[what]()


def test_short_signal_and_bad_hop_raise():
    x = torch.zeros((2, N_FFT - 1))
    for fn in (lambda: psp.frame(x, N_FFT, HOP),
               lambda: psp.windowed_rdft(x, N_FFT, HOP),
               lambda: psp.stft(x, n_fft=N_FFT, hop=HOP),
               lambda: psp.composed_wola(x, torch.ones(1), N_FFT, HOP,
                                         "hann", np.ones(N_FFT // 2 + 1))):
        with pytest.raises(ValueError, match="shorter than one frame"):
            fn()
    with pytest.raises(ValueError, match="must divide"):
        psp.frame(torch.zeros(1024), N_FFT, 60)


def test_precision_scope_pins_the_kernels_mode(monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "high")
    assert platform.kernel_mode() == "high"
    assert ptf.precision_scope is platform.precision_scope
    with ptf.precision_scope("highest"):
        assert ptf.matmul_precision_name() == "highest"
        assert platform.kernel_mode() == "highest"
        with ptf.precision_scope(None):
            assert platform.kernel_mode() == "highest"
        with ptf.precision_scope("default"):
            assert platform.kernel_mode() == "high"
        assert platform.kernel_mode() == "highest"
    assert platform.kernel_mode() == "high"
    with pytest.raises(ValueError, match="unknown precision"):
        with ptf.precision_scope("fast"):
            pass
    assert ptf.matmul_precision_name() == "high"

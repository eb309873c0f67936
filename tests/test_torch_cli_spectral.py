"""The port's ``stft`` and ``channelizer`` tools with ``--cpu`` against the
JAX package's tools on small inputs, the channelizer tool on a 2-rank CPU
mesh and against ``Channelizer.step``, and WAV files of 256 float32
channels (config 4's channel count)."""

import struct

import numpy as np
import pytest
import torch

from llzlab_tpu.cli import channelizer as rcz_cli
from llzlab_tpu.cli import stft as rstft_cli
from llzlab_tpu.io import wav as rwav
from llzlab_tpu_torch.chains.channelizer import Channelizer
from llzlab_tpu_torch.cli import channelizer as pcz_cli
from llzlab_tpu_torch.cli import stft as pstft_cli
from llzlab_tpu_torch.io import wav as pwav
from llzlab_tpu_torch.ops.fir import firwin
from llzlab_tpu_torch.pipeline import Chain, SpectralGainStage
from tests.conftest import snr_db

N_FFT, HOP, T = 256, 64, 12000
LAT = N_FFT - HOP
#: the port's tool against the JAX tool: two f32 computations of the same
#: WOLA, held on the interior as the stage tests hold them
#: (tests/test_torch_spectral_stage.py); against the port's own stage run
#: in one shot, the streaming floor at every sample
VS_TOOL_DB, VS_STAGE_DB = 120.0, 140.0
#: channelizer spectra: the port's tool against the JAX tool (two f32 ols
#: engines and polyphase products), and sharded against one rank (the
#: JAX package's sharded floor, tests/parallel/test_channelizer_sharded.py)
VS_CZ_TOOL_DB, SHARDED_DB = 120.0, 140.0
#: the channelizer tool's small shape: 129 taps and 64-point frames give a
#: block_multiple of 10 240 input samples
CZ = ["--fir-taps", "129", "--fft", "64", "--seconds", "0.5"]


def _wav(path, c, t, seed, rate=48000):
    x = 0.25 * np.random.default_rng(seed).standard_normal((c, t))
    x = x.astype(np.float32)
    pwav.write_wav(str(path), x, rate)
    return x


def _snr(ref, y) -> float:
    ref = np.asarray(ref).astype(np.complex128)
    perr = np.sum(np.abs(ref - np.asarray(y).astype(np.complex128)) ** 2)
    if perr == 0.0:
        return float("inf")
    return 10.0 * np.log10(np.sum(np.abs(ref) ** 2) / perr)


@pytest.mark.parametrize("extra", [["--gain-db", "-6", "--notch", "1000",
                                    "2000"], ["--window", "hamming"]])
def test_stft_tool_matches_the_reference_tool_and_the_stage(tmp_path, extra):
    x = _wav(tmp_path / "in.wav", 2, T, 7)
    args = ["--n-fft", str(N_FFT), "--hop", str(HOP), "--cpu",
            "--block-seconds", "0.05"] + extra
    out, _ = pstft_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                             str(tmp_path / "p.wav")] + args)
    rstft_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                    str(tmp_path / "r.wav")] + args)
    y, rate = pwav.read_wav(out)
    ref, _ = rwav.read_wav(str(tmp_path / "r.wav"))
    assert rate == 48000 and y.shape == ref.shape == x.shape
    # the stage's latency: the output leads with n_fft - hop zeros
    np.testing.assert_array_equal(y[:, :LAT], 0.0)
    lo, hi = LAT + N_FFT, T - N_FFT
    assert snr_db(ref[:, lo:hi], y[:, lo:hi]) >= VS_TOOL_DB
    # the tool's blocks against one apply of the same stage (the tool pads
    # its last block with zeros, as the one shot here)
    gain = np.full(N_FFT // 2 + 1, 1.0, np.float32)
    if "--gain-db" in extra:
        gain[:] = 10.0 ** (-6 / 20)
        k = np.arange(N_FFT // 2 + 1) * 48000 / N_FFT
        gain[(k >= 1000) & (k <= 2000)] = 0.0
    window = "hamming" if "hamming" in extra else "hann"
    stage = SpectralGainStage(gain, n_fft=N_FFT, hop=HOP, window=window)
    t_pad = -(-T // 2368) * 2368
    one = Chain([stage])(torch.from_numpy(
        np.pad(x, ((0, 0), (0, t_pad - T))))).numpy()[:, :T]
    assert snr_db(one[:, LAT:], y[:, LAT:]) >= VS_STAGE_DB


def _npz(path):
    with np.load(path) as z:
        return z["spectra"], int(z["rate"]), int(z["fft_n"])


@pytest.mark.parametrize("method", ["ols", "direct"])
def test_channelizer_tool_matches_the_reference_tool(tmp_path, method):
    common = ["--synth", "3", "--fir-method", method] + CZ
    pcz_cli.main(["-o", str(tmp_path / "p.npz"), "--cpu"] + common)
    pcz_cli.main(["-o", str(tmp_path / "p2.npz"), "--cpu", "--mesh-time",
                  "2"] + common)
    # the JAX tool on one CPU device (the suite's process has eight)
    rcz_cli.main(["-o", str(tmp_path / "r.npz"), "--cpu", "--mesh-channel",
                  "1", "--mesh-time", "1"] + common)
    spec, rate, fft_n = _npz(tmp_path / "p.npz")
    spec2, _, _ = _npz(tmp_path / "p2.npz")
    ref, rate_r, fft_r = _npz(tmp_path / "r.npz")
    assert (rate, fft_n) == (rate_r, fft_r) == (44100, 64)
    assert spec.shape == spec2.shape == ref.shape and spec.shape[0] == 3
    assert _snr(ref, spec) >= VS_CZ_TOOL_DB
    assert _snr(spec, spec2) >= SHARDED_DB
    # the tool's input is the JAX tool's noise: the same channels through
    # Channelizer.step give the same spectra
    x = np.random.default_rng(0).standard_normal((3, 24000)).astype(
        np.float32)
    ch = Channelizer(fir_taps=firwin(129, 0.4, window="hamming"), fft_n=64,
                     fir_method=method, device="cpu")
    t_use = 24000 // ch.block_multiple() * ch.block_multiple()
    got, _ = ch.step(torch.from_numpy(x[:, :t_use]), ch.init_state(3))
    np.testing.assert_array_equal(got.numpy(), spec)


def test_channelizer_tool_rejects_what_the_port_has_not(tmp_path, capsys):
    # --mesh-channel 2 --mesh-time 2 against the JAX tool on a (2, 2) mesh;
    # 3 channels are padded to 4, as there
    common = ["--synth", "3", "--fir-method", "ols", "--mesh-channel", "2",
              "--mesh-time", "2"] + CZ[:-1] + ["1.0"]
    pcz_cli.main(["-o", str(tmp_path / "p.npz"), "--cpu"] + common)
    rcz_cli.main(["-o", str(tmp_path / "r.npz"), "--cpu"] + common)
    spec, _, _ = _npz(tmp_path / "p.npz")
    ref, _, _ = _npz(tmp_path / "r.npz")
    assert spec.shape == ref.shape and spec.shape[0] == 4
    assert _snr(ref, spec) >= VS_CZ_TOOL_DB
    np.testing.assert_array_equal(spec[3], 0.0)
    with pytest.raises(SystemExit):
        pcz_cli.main(["-o", str(tmp_path / "o.npz"), "--cpu", "--synth",
                      "2", "--fir-taps", "129", "--fft", "64", "--seconds",
                      "0.1"])
    assert "input too short" in capsys.readouterr().err
    assert not (tmp_path / "o.npz").exists()


def test_channelizer_tool_reads_a_wav_and_needs_a_card(tmp_path,
                                                       monkeypatch):
    x = _wav(tmp_path / "in.wav", 2, 24000, 8)
    pcz_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                  str(tmp_path / "p.npz"), "--cpu", "--fir-taps", "129",
                  "--fft", "64"])
    spec, rate, _ = _npz(tmp_path / "p.npz")
    ch = Channelizer(fir_taps=firwin(129, 0.4, window="hamming"), fft_n=64,
                     fir_method="ols", device="cpu")
    got, _ = ch.step(torch.from_numpy(x[:, :20480]), ch.init_state(2))
    np.testing.assert_array_equal(got.numpy(), spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((pcz_cli.main, ["-i", str(tmp_path / "in.wav"),
                                       "-o", str(tmp_path / "q.npz")]),
                       (pstft_cli.main, ["-i", str(tmp_path / "in.wav"),
                                         "-o", str(tmp_path / "q.wav")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_wav_round_trips_256_float32_channels(tmp_path):
    """Config 4's 256 channels: the port's file read back by both packages,
    and a WAVE_FORMAT_EXTENSIBLE file (as other tools write one with this
    many channels) read by both."""
    x = np.random.default_rng(9).standard_normal((256, 300)).astype(
        np.float32)
    pwav.write_wav(str(tmp_path / "p.wav"), x, 48000)
    for read in (pwav.read_wav, rwav.read_wav):
        y, rate = read(str(tmp_path / "p.wav"))
        assert rate == 48000 and y.dtype == np.float32
        np.testing.assert_array_equal(y, x)
    info = pwav.wav_info(str(tmp_path / "p.wav"))
    assert (info.channels, info.bits, info.frames) == (256, 32, 300)
    # WAVE_FORMAT_EXTENSIBLE: tag 0xFFFE, the IEEE-float subformat GUID
    payload = np.ascontiguousarray(x.T).astype("<f4").tobytes()
    guid = struct.pack("<H", 3) + bytes.fromhex("000000001000800000aa00389b71")
    fmt = struct.pack("<HHIIHH", 0xFFFE, 256, 48000, 48000 * 1024, 1024, 32)
    fmt += struct.pack("<HHI", 22, 32, 0) + guid
    riff = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    riff += b"data" + struct.pack("<I", len(payload)) + payload
    (tmp_path / "e.wav").write_bytes(b"RIFF" + struct.pack("<I", len(riff))
                                     + riff)
    for read in (pwav.read_wav, rwav.read_wav):
        y, rate = read(str(tmp_path / "e.wav"))
        assert rate == 48000
        np.testing.assert_array_equal(y, x)

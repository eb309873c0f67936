"""The port's ``iir`` tool with ``--cpu`` against the JAX package's tool on
a small WAV (``--eq``, ``--butter``, ``--cheby1``), ``SOSStage`` streaming
against one shot, the tool's checkpoint/resume, and a checkpoint of the JAX
tool resumed by the port's."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as ss
import torch

from llzlab_tpu.cli import iir as riir_cli
from llzlab_tpu.io import wav as rwav
from llzlab_tpu_torch.cli import iir as piir_cli
from llzlab_tpu_torch.io import wav as pwav
from llzlab_tpu_torch.ops.iir import butter_sos, peaking_eq_sos
from llzlab_tpu_torch.pipeline import Chain, SOSStage
from tests.conftest import snr_db

#: two float32 scans of the same sections (tests/ops/test_iir.py:120)
VS_TOOL_DB = 120.0
#: against scipy float64: the EQ's floor, and that of a real-pole design
#: (tests/ops/test_iir.py:64,71)
VS_SCIPY_DB = {"eq": 120.0, "butter": 100.0, "cheby1": 100.0}
TOOL_ARGS = {
    "eq": ["--eq", "100:3", "400:-2", "1600:5", "6400:-4"],
    "butter": ["--butter", "5", "--cutoff", "0.3"],
    "cheby1": ["--cheby1", "4", "--ripple", "0.5", "--cutoff", "0.2", "0.5",
               "--kind", "bandpass"],
}
ROOT = Path(__file__).resolve().parent.parent


def _wav(path, c, t, seed, rate=48000):
    x = 0.25 * np.random.default_rng(seed).standard_normal((c, t))
    x = x.astype(np.float32)
    pwav.write_wav(str(path), x, rate)
    return x


def _sos(design):
    if design == "eq":
        return peaking_eq_sos([100, 400, 1600, 6400], [3, -2, 5, -4],
                              48000.0)
    if design == "butter":
        return butter_sos(5, 0.3)
    return ss.cheby1(4, 0.5, [0.2, 0.5], "bandpass", output="sos")


@pytest.mark.parametrize("design", list(TOOL_ARGS))
def test_iir_tool_matches_the_reference_tool_and_scipy(tmp_path, design):
    x = _wav(tmp_path / "in.wav", 2, 20000, 1)
    args = TOOL_ARGS[design] + ["--cpu", "--block-seconds", "0.1",
                                "--block-size", "1024"]
    piir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "p.wav")] + args)
    riir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "r.wav")] + args)
    y, rate = pwav.read_wav(str(tmp_path / "p.wav"))
    ref, _ = rwav.read_wav(str(tmp_path / "r.wav"))
    assert rate == 48000 and y.shape == x.shape == ref.shape
    assert snr_db(ref, y) >= VS_TOOL_DB
    golden = ss.sosfilt(_sos(design), x.astype(np.float64), axis=-1)
    assert snr_db(golden, y) >= VS_SCIPY_DB[design]


def test_sos_stage_streams_bitwise_one_shot():
    sos = butter_sos(5, 0.3)
    stage = SOSStage(sos, block_size=512)
    chain = Chain([stage])
    assert chain.block_multiple == 512
    st = stage.init_state((3,), device="cpu")
    assert st.shape == (3, 3, 2) and st.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 5 * 512 + 40)).astype(np.float32))
    one = chain(x)
    pieces = [x[:, :1024], x[:, 1024:1536], x[:, 1536:]]
    assert torch.equal(torch.cat(list(chain.stream(pieces)), -1), one)


def test_checkpoint_resume_equals_one_run_bitwise(tmp_path):
    x = _wav(tmp_path / "in.wav", 2, 24000, 3)
    common = TOOL_ARGS["eq"] + ["--cpu", "--block-seconds", "0.1",
                                "--block-size", "1024"]
    piir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "one.wav")] + common)
    blk = int(0.1 * 48000) // 1024 * 1024
    pwav.write_wav(str(tmp_path / "head.wav"), x[:, :2 * blk], 48000)
    ck = str(tmp_path / "ck.npz")
    piir_cli.main(["-i", str(tmp_path / "head.wav"), "-o",
                   str(tmp_path / "a.wav"), "--checkpoint", ck] + common)
    piir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "b.wav"), "--checkpoint", ck, "--resume"]
                  + common)
    one, _ = pwav.read_wav(str(tmp_path / "one.wav"))
    a, _ = pwav.read_wav(str(tmp_path / "a.wav"))
    b, _ = pwav.read_wav(str(tmp_path / "b.wav"))
    np.testing.assert_array_equal(np.concatenate([a, b], -1), one)


@pytest.mark.parametrize("design", ["eq", "butter"])
def test_a_checkpoint_of_the_reference_tool_resumes_in_the_port(tmp_path,
                                                                design):
    """The same file format and the same ``(…, ns, 2)`` scan states: the
    JAX tool filters the first blocks, the port's tool resumes from its
    checkpoint; against the port's own run of the whole file, at the
    floor of two float32 scans (the carried states differ in their last
    bits)."""
    x = _wav(tmp_path / "in.wav", 2, 24000, 4)
    common = TOOL_ARGS[design] + ["--cpu", "--block-seconds", "0.1",
                                  "--block-size", "1024"]
    blk = int(0.1 * 48000) // 1024 * 1024
    pwav.write_wav(str(tmp_path / "head.wav"), x[:, :3 * blk], 48000)
    ck = str(tmp_path / "ck.npz")
    riir_cli.main(["-i", str(tmp_path / "head.wav"), "-o",
                   str(tmp_path / "a.wav"), "--checkpoint", ck] + common)
    piir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "b.wav"), "--checkpoint", ck, "--resume"]
                  + common)
    piir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "one.wav")] + common)
    b, _ = pwav.read_wav(str(tmp_path / "b.wav"))
    one, _ = pwav.read_wav(str(tmp_path / "one.wav"))
    assert b.shape == (2, x.shape[1] - 3 * blk)
    assert snr_db(one[:, 3 * blk:], b) >= VS_TOOL_DB


def test_the_tool_needs_a_card_without_cpu(tmp_path, monkeypatch):
    _wav(tmp_path / "in.wav", 1, 4800, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        piir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                       str(tmp_path / "o.wav"), "--butter", "4"])
    assert not (tmp_path / "o.wav").exists()


def test_the_tool_runs_as_a_module(tmp_path):
    _wav(tmp_path / "in.wav", 1, 4800, 6)
    subprocess.run(
        [sys.executable, "-m", "llzlab_tpu_torch.cli.iir", "-i",
         str(tmp_path / "in.wav"), "-o", str(tmp_path / "o.wav"), "--cpu",
         "--eq", "1000:6"], check=True, cwd=ROOT, timeout=120,
        capture_output=True)
    y, rate = pwav.read_wav(str(tmp_path / "o.wav"))
    assert rate == 48000 and y.shape == (1, 4800)

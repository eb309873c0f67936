"""The port's ``fir`` and ``resample`` tools with ``--cpu`` against the JAX
package's tools on a small WAV, checkpoint/resume, a checkpoint of the JAX
tool resumed by the port's, and the WAV and metrics modules against the
JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as ss
import torch

from llzlab_tpu.cli import fir as rfir_cli
from llzlab_tpu.cli import resample as rrs_cli
from llzlab_tpu.io import wav as rwav
from llzlab_tpu.utils import metrics as rmetrics
from llzlab_tpu_torch.cli import fir as pfir_cli
from llzlab_tpu_torch.cli import resample as prs_cli
from llzlab_tpu_torch.io import wav as pwav
from llzlab_tpu_torch.ops.fir import firwin
from llzlab_tpu_torch.pipeline import FIRStage, ResampleStage
from llzlab_tpu_torch.utils import metrics as pmetrics
from tests.conftest import snr_db

#: port tool against the JAX tool, both f32 on the CPU: the port's "auto"
#: is block2 (its plain version), the JAX tool's on
#: the CPU is ols; two f32 engines, each > 130 dB from float64
VS_TOOL_DB = 125.0
#: resampler tools: the same polyphase product in another library's order
VS_RS_TOOL_DB = 125.0
#: against scipy float64 (the JAX package's chain floor at "highest")
VS_SCIPY_DB = 110.0
ROOT = Path(__file__).resolve().parent.parent


def _wav(path, c, t, seed, rate=48000):
    x = 0.25 * np.random.default_rng(seed).standard_normal((c, t))
    x = x.astype(np.float32)
    pwav.write_wav(str(path), x, rate)
    return x


def test_fir_tool_matches_the_reference_tool_and_scipy(tmp_path):
    x = _wav(tmp_path / "in.wav", 1, 30000, 1)
    args = ["--taps", "255", "--cutoff", "0.3", "--cpu",
            "--block-seconds", "0.25"]
    pfir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "p.wav")] + args)
    rfir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "r.wav")] + args)
    y, rate = pwav.read_wav(str(tmp_path / "p.wav"))
    ref, _ = rwav.read_wav(str(tmp_path / "r.wav"))
    assert rate == 48000 and y.shape == x.shape == ref.shape
    assert snr_db(ref, y) >= VS_TOOL_DB
    golden = ss.lfilter(firwin(255, 0.3), [1.0], x.astype(np.float64), -1)
    assert snr_db(golden, y) >= VS_SCIPY_DB


def test_resample_tool_matches_the_reference_tool_and_upfirdn(tmp_path):
    x = _wav(tmp_path / "in.wav", 3, 20000, 2)
    args = ["--rate", "44100", "--cpu", "--block-seconds", "0.1"]
    prs_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                  str(tmp_path / "p.wav")] + args)
    rrs_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                  str(tmp_path / "r.wav")] + args)
    y, rate = pwav.read_wav(str(tmp_path / "p.wav"))
    ref, _ = rwav.read_wav(str(tmp_path / "r.wav"))
    assert rate == 44100 and y.shape == ref.shape == (3, 18375)
    assert snr_db(ref, y) >= VS_RS_TOOL_DB
    from llzlab_tpu_torch.ops.resample import resample_taps
    golden = ss.upfirdn(resample_taps(147, 160, 64), x.astype(np.float64),
                        147, 160, axis=-1)
    assert snr_db(golden[:, :y.shape[1]], y) >= VS_SCIPY_DB


@pytest.mark.parametrize("tool,extra", [
    ("fir", ["--taps", "255", "--cutoff", "0.3"]),
    ("fir", ["--taps", "255", "--cutoff", "0.3", "--method", "ols"]),
    ("resample", ["--rate", "44100"]),
])
def test_checkpoint_resume_equals_one_run_bitwise(tmp_path, tool, extra):
    """The first blocks into a checkpoint, then the whole file resumed from
    it: the two outputs, joined, are bitwise the output of one run."""
    main = pfir_cli.main if tool == "fir" else prs_cli.main
    x = _wav(tmp_path / "in.wav", 2, 24000, 3)
    common = ["--cpu", "--block-seconds", "0.1"] + extra
    main(["-i", str(tmp_path / "in.wav"), "-o", str(tmp_path / "one.wav")]
         + common)
    one, _ = pwav.read_wav(str(tmp_path / "one.wav"))
    # the first two blocks alone, with a checkpoint after each
    if tool == "resample":
        m = ResampleStage(147, 160).block_multiple
    else:
        m = FIRStage(firwin(255, 0.3), method=extra[-1] if "ols" in extra
                     else "auto").block_multiple
    blk = int(0.1 * 48000) // m * m
    pwav.write_wav(str(tmp_path / "head.wav"), x[:, :2 * blk], 48000)
    ck = str(tmp_path / "ck.npz")
    main(["-i", str(tmp_path / "head.wav"), "-o", str(tmp_path / "a.wav"),
          "--checkpoint", ck] + common)
    main(["-i", str(tmp_path / "in.wav"), "-o", str(tmp_path / "b.wav"),
          "--checkpoint", ck, "--resume"] + common)
    a, _ = pwav.read_wav(str(tmp_path / "a.wav"))
    b, _ = pwav.read_wav(str(tmp_path / "b.wav"))
    np.testing.assert_array_equal(np.concatenate([a, b], -1), one)


def test_a_checkpoint_of_the_reference_tool_resumes_in_the_port(tmp_path):
    """Same file format and state layout: the JAX tool filters the first
    blocks (ols, as on its CPU), the port's tool resumes from its
    checkpoint; against the port's own run at the tool floor."""
    x = _wav(tmp_path / "in.wav", 1, 24000, 4)
    common = ["--taps", "255", "--cutoff", "0.3", "--method", "ols",
              "--cpu", "--block-seconds", "0.1"]
    m = FIRStage(firwin(255, 0.3), method="ols").block_multiple
    blk = int(0.1 * 48000) // m * m
    pwav.write_wav(str(tmp_path / "head.wav"), x[:, :3 * blk], 48000)
    ck = str(tmp_path / "ck.npz")
    rfir_cli.main(["-i", str(tmp_path / "head.wav"), "-o",
                   str(tmp_path / "a.wav"), "--checkpoint", ck] + common)
    pfir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "b.wav"), "--checkpoint", ck, "--resume"]
                  + common)
    pfir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                   str(tmp_path / "one.wav")] + common)
    b, _ = pwav.read_wav(str(tmp_path / "b.wav"))
    one, _ = pwav.read_wav(str(tmp_path / "one.wav"))
    assert b.shape == (1, x.shape[1] - 3 * blk)
    np.testing.assert_array_equal(b, one[:, 3 * blk:])


def test_the_tool_needs_a_card_without_cpu(tmp_path, monkeypatch):
    _wav(tmp_path / "in.wav", 1, 4800, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfir_cli.main(["-i", str(tmp_path / "in.wav"), "-o",
                       str(tmp_path / "o.wav"), "--taps", "129"])
    assert not (tmp_path / "o.wav").exists()


def test_tools_run_as_modules(tmp_path):
    _wav(tmp_path / "in.wav", 1, 4800, 6)
    for tool, extra in (("fir", ["--taps", "129"]),
                        ("resample", ["--rate", "16000"])):
        subprocess.run(
            [sys.executable, "-m", f"llzlab_tpu_torch.cli.{tool}", "-i",
             str(tmp_path / "in.wav"), "-o", str(tmp_path / f"{tool}.wav"),
             "--cpu", "--metrics", str(tmp_path / "m.jsonl")] + extra,
            check=True, cwd=ROOT, timeout=120, capture_output=True)
    assert pwav.wav_info(str(tmp_path / "resample.wav")).sample_rate == 16000
    events = [json.loads(line) for line in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["start", "done"] * 2


@pytest.mark.parametrize("fmt,bits", [("float", 32), ("pcm", 16),
                                      ("pcm", 24), ("pcm", 32)])
def test_wav_bytes_and_samples_equal_the_reference(tmp_path, fmt, bits):
    x = 0.5 * np.random.default_rng(bits).standard_normal((3, 1001))
    pwav.write_wav(str(tmp_path / "p.wav"), x, 44100, bits=bits, fmt=fmt)
    rwav.write_wav(str(tmp_path / "r.wav"), x, 44100, bits=bits, fmt=fmt)
    assert (tmp_path / "p.wav").read_bytes() == \
        (tmp_path / "r.wav").read_bytes()
    yp, rp = pwav.read_wav(str(tmp_path / "p.wav"))
    yr, rr = rwav.read_wav(str(tmp_path / "p.wav"))
    assert rp == rr == 44100
    np.testing.assert_array_equal(yp, yr)
    assert pwav.wav_info(str(tmp_path / "p.wav")) == \
        pwav.WavInfo(**vars(rwav.wav_info(str(tmp_path / "p.wav"))))


def test_metrics_equal_the_reference(tmp_path):
    cfg = {"tool": "fir", "blk": 95232, "rate": 48000}
    assert pmetrics.config_hash(cfg) == rmetrics.config_hash(cfg)
    log = pmetrics.MetricsLogger(str(tmp_path / "m.jsonl"), run="r",
                                 echo=False)
    rec = log.stage("fir", 480000, 0.5)
    assert rec["msps"] == 0.96 and rec["kind"] == "stage"
    line = json.loads((tmp_path / "m.jsonl").read_text())
    assert line["stage"] == "fir" and line["run"] == "r"

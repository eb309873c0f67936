"""The port's matrix-product biquad engine (``sosfilt_matmul``) on the CPU
at the JAX package's floors (tests/ops/test_iir_matmul.py), against the
JAX package's ``sosfilt_matmul`` on the same seeded input (outputs and
states, a JAX state resumed), its states against the scan engine's, and
``sosfilt_auto``: the scan engine on a CPU
tensor, the engine matrix of a card read from its artifact
(``LLZ_CALIB_DIR``), and the packaged artifact of the H100."""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import scipy.signal as ss
import torch

import llzlab_tpu_torch
from llzlab_tpu.ops import iir_matmul as riir_matmul
from llzlab_tpu_torch.ops import iir as piir
from llzlab_tpu_torch.ops import iir_select
from llzlab_tpu_torch.ops.iir_matmul import sosfilt_matmul
from tests.conftest import snr_db

EQ = piir.peaking_eq_sos([100, 200, 400, 800, 1600, 3200, 6400, 12800],
                         [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0)
BUTTER7 = piir.butter_sos(7, 0.3)
#: against scipy float64 (tests/ops/test_iir_matmul.py:36), a streamed
#: split against one shot (:57)
VS_SCIPY_DB, SPLIT_DB = 110.0, 130.0
#: two float32 engines of the same design against each other
#: (tests/ops/test_iir.py:120)
VS_JAX_DB = 120.0
#: config 3's block in the iir tool: 2 s at 48 kHz in whole scan blocks
CONFIG3_CHANNELS, CONFIG3_BLOCK = 64, (2 * 48000 // 4096) * 4096


@pytest.fixture(scope="module")
def x():
    return torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 24000)).astype(np.float32))


def _ref(sos, x):
    return ss.sosfilt(sos, x.double().numpy(), axis=-1)


@pytest.mark.parametrize("design,L", [("eq", 254), ("eq", 128),
                                      ("butter7", 254), ("butter7", 256)])
def test_against_scipy_float64(x, design, L):
    sos = EQ if design == "eq" else BUTTER7
    y = sosfilt_matmul(sos, x, block_size=L)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert snr_db(_ref(sos, x), y.numpy()) > VS_SCIPY_DB


def test_ragged_tail_and_its_state():
    """1000 samples (not a multiple of L): the output, and the state at
    the last sample against the scan engine's."""
    xr = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 1000)).astype(np.float32))
    for sos in (EQ, BUTTER7):
        y, zf = sosfilt_matmul(sos, xr, return_zf=True)
        _, zs = piir.sosfilt(sos, xr, block_size=1024, return_zf=True)
        assert y.shape == (2, 1000)
        assert snr_db(_ref(sos, xr), y.numpy()) > VS_SCIPY_DB
        assert snr_db(zs.numpy(), zf.numpy()) > VS_SCIPY_DB


@pytest.mark.parametrize("design", ["eq", "butter7"])
@pytest.mark.parametrize("t,L", [(5000, 254), (4096 + 300, 128)])
def test_against_the_jax_package_with_states(design, t, L):
    """The same seeded numpy input through the JAX package's
    ``sosfilt_matmul`` and the port's, a ragged tail included: outputs
    and final states (the same realization)."""
    sos = EQ if design == "eq" else BUTTER7
    xn = np.random.default_rng(21).standard_normal((3, t)).astype(
        np.float32)
    ry, rzf = riir_matmul.sosfilt_matmul(sos, xn, block_size=L,
                                         return_zf=True)
    y, zf = sosfilt_matmul(sos, torch.from_numpy(xn), block_size=L,
                           return_zf=True)
    assert y.shape == xn.shape and zf.shape == (3, len(sos), 2)
    assert snr_db(np.asarray(ry), y.numpy()) >= VS_JAX_DB
    assert snr_db(np.asarray(rzf), zf.numpy()) >= VS_JAX_DB


@pytest.mark.parametrize("design", ["eq", "butter7"])
def test_a_jax_matmul_state_resumes_in_the_port(design):
    """The JAX package's matrix engine filters the first 2000 samples and
    returns its states; the port's matrix engine continues from them: the
    rest against scipy float64 run over the whole signal."""
    sos = EQ if design == "eq" else BUTTER7
    xn = np.random.default_rng(22).standard_normal((2, 5000)).astype(
        np.float32)
    _, rzf = riir_matmul.sosfilt_matmul(sos, xn[:, :2000], return_zf=True)
    y = sosfilt_matmul(sos, torch.from_numpy(xn[:, 2000:]),
                       zi=torch.from_numpy(np.array(rzf)))
    ref = ss.sosfilt(sos, xn.astype(np.float64), axis=-1)[:, 2000:]
    assert snr_db(ref, y.numpy()) > VS_SCIPY_DB


@pytest.mark.parametrize("design", ["eq", "butter7"])
def test_streaming_split(x, design):
    sos = EQ if design == "eq" else BUTTER7
    full = sosfilt_matmul(sos, x)
    ya, zf = sosfilt_matmul(sos, x[:, :12001], zi=torch.zeros((4, len(sos),
                                                               2)),
                            return_zf=True)
    yb = sosfilt_matmul(sos, x[:, 12001:], zi=zf)
    assert snr_db(full.numpy(), torch.cat([ya, yb], -1).numpy()) > SPLIT_DB


@pytest.mark.parametrize("first", ["scan", "matmul"])
def test_states_interchange_with_the_scan_engine(x, first):
    engines = {"scan": lambda *a, **k: piir.sosfilt(*a, block_size=1024,
                                                    **k),
               "matmul": sosfilt_matmul}
    second = "matmul" if first == "scan" else "scan"
    ya, zf = engines[first](EQ, x[:, :12288], return_zf=True)
    yb = engines[second](EQ, x[:, 12288:], zi=zf)
    assert snr_db(_ref(EQ, x), torch.cat([ya, yb], -1).numpy()) > VS_SCIPY_DB


def test_precision_names():
    """Every name runs the same fp32 product; an unknown one raises."""
    xs = torch.ones((1, 600))
    y = sosfilt_matmul(EQ, xs, precision="highest")
    assert torch.equal(sosfilt_matmul(EQ, xs, precision="high"), y)
    assert torch.equal(sosfilt_matmul(EQ, xs), y)
    with pytest.raises(ValueError, match="unknown precision"):
        sosfilt_matmul(EQ, xs, precision="bf16")


def test_auto_on_the_cpu_is_the_scan_engine(x):
    for need in (80.0, 120.0):
        assert iir_select.select_engine("cpu", min_snr_db=need) == (
            "scan", "f32")
        assert torch.equal(iir_select.sosfilt_auto(EQ, x, min_snr_db=need),
                           piir.sosfilt(EQ, x))
    ya, zf = iir_select.sosfilt_auto(EQ, x[:, :8192], bit_exact_carry=True,
                                     return_zf=True, block_size=4096)
    yb = iir_select.sosfilt_auto(EQ, x[:, 8192:], bit_exact_carry=True,
                                 zi=zf, block_size=4096)
    assert torch.equal(torch.cat([ya, yb], -1), piir.sosfilt(EQ, x))


def test_unreachable_snr_raises(x):
    with pytest.raises(ValueError, match="exceeds every engine"):
        iir_select.sosfilt_auto(EQ, x, min_snr_db=200.0)


def test_an_artifact_overrides_the_fallback(tmp_path, monkeypatch):
    """A card's artifact (here a made-up card through ``LLZ_CALIB_DIR``)
    sets the matrix: floors are its SNRs less the margin, and the fastest
    row meeting a floor is chosen on a CUDA device."""
    monkeypatch.setenv("LLZ_CALIB_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Made-up GPU 9000")
    iir_select.load_engine_matrix.cache_clear()
    path = iir_select.calib_path("Made-up GPU 9000")
    assert path == str(tmp_path / "made-up-gpu-9000.json")
    with open(path, "w") as f:
        json.dump({"device_kind": "Made-up GPU 9000", "measured": [
            {"engine": "matmul", "precision": "high", "msps": 9000.0,
             "snr": 91.0},
            {"engine": "scan", "precision": "f32", "msps": 250.0,
             "snr": 136.0}]}, f)
    try:
        m = iir_select.load_engine_matrix("Made-up GPU 9000")
        assert m == {("matmul", "high"): (9000.0, 91.0 - 10.0),
                     ("scan", "f32"): (250.0, 136.0 - 10.0)}
        assert iir_select.select_engine("cuda", min_snr_db=80.0) == (
            "matmul", "high")
        assert iir_select.select_engine("cuda", min_snr_db=100.0) == (
            "scan", "f32")
        assert iir_select.select_engine("cuda", min_snr_db=80.0,
                                        bit_exact_carry=True) == ("scan",
                                                                  "f32")
        with pytest.raises(ValueError, match="exceeds every engine"):
            iir_select.select_engine("cuda", min_snr_db=130.0)
    finally:
        iir_select.load_engine_matrix.cache_clear()


def test_a_card_without_an_artifact_takes_the_fallback(tmp_path,
                                                       monkeypatch):
    """The fallback keeps the JAX package's floors and only a rank order:
    no rate measured on another device stands in for the card's."""
    monkeypatch.setenv("LLZ_CALIB_DIR", str(tmp_path))
    iir_select.load_engine_matrix.cache_clear()
    try:
        m = iir_select.load_engine_matrix("Made-up GPU 9001")
        assert {k: v[1] for k, v in m.items()} == {
            ("matmul", "high"): 75.0, ("matmul", "highest"): 125.0,
            ("scan", "f32"): 125.0}
        assert sorted(v[0] for v in m.values()) == [1.0, 2.0, 3.0]
    finally:
        iir_select.load_engine_matrix.cache_clear()


def _calibration_script():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "calibrate_iir_torch.py")
    spec = importlib.util.spec_from_file_location("calibrate_iir_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_packaged_card_artifact_records_config_3():
    """The packaged artifacts were measured by
    ``scripts/calibrate_iir_torch.py`` on config 3's EQ at the iir tool's
    block, with the script's own repetitions, run length and seed, and
    every row's run-to-run spread under its 10 % gate."""
    script = _calibration_script()
    assert script.MAX_SPREAD_PCT == 10.0
    calib = os.path.join(os.path.dirname(llzlab_tpu_torch.__file__),
                         "calib")
    arts = sorted(glob.glob(os.path.join(calib, "*.json")))
    assert any(os.path.basename(p) == "nvidia-h100-80gb-hbm3.json"
               for p in arts)
    for path in arts:
        with open(path) as f:
            art = json.load(f)
        assert iir_select.calib_path(art["device_kind"]) == path
        assert art["workload"] == ("8-section peaking-EQ cascade, "
                                   f"{art['channels']}ch x {art['block']}")
        assert (art["channels"], art["block"]) == (CONFIG3_CHANNELS,
                                                   CONFIG3_BLOCK)
        assert art["power_limit"].endswith("W")
        assert (art["seed"], art["reps"], art["min_seconds"],
                art["max_spread_pct"]) == (script.SEED, script.REPS,
                                           script.MIN_SECONDS,
                                           script.MAX_SPREAD_PCT)
        assert {(r["engine"], r["precision"]) for r in art["measured"]} == {
            ("scan", "f32"), ("matmul", "highest"), ("matmul", "high")}
        for row in art["measured"]:
            assert row["spread_pct"] < script.MAX_SPREAD_PCT, (path, row)
            assert row["scan_iters"] >= 1 and row["msps"] > 0
            assert row["snr"] > VS_SCIPY_DB

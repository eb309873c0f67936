"""The least work of the channelizer, by the worked numbers."""

import pytest

from portbench import core, roofline

CFG = core.Cell("chan1024.bulk").cfg
PK = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_flop_and_bytes_per_input_sample():
    assert roofline.fir_ols_flop_per_sample(1024) == pytest.approx(
        83.97, abs=0.01)
    assert roofline.fir_direct_flop_per_sample(1024) == 2048
    assert roofline.resample_flop_per_sample(147, 160, 64) == \
        pytest.approx(117.6)
    assert roofline.frames_flop_per_sample(147, 160, 2048) == \
        pytest.approx(25.27, abs=0.01)
    assert roofline.channelizer_bytes_per_sample(147, 160, 2048) == \
        pytest.approx(7.68, abs=0.005)


def test_least_time_of_a_step_and_its_bound():
    s = 1024 * 1310720
    t_high, b_high = roofline.channelizer_least_s(CFG, "high", PK, s)
    t_top, b_top = roofline.channelizer_least_s(CFG, "highest", PK, s)
    # at high the bytes bound: 7.68 B over 3.35 TB/s
    assert b_high == "bytes" and t_high == pytest.approx(
        s * 7.6786 / 3.35e12, rel=1e-4)
    # at highest every FLOP runs at the fp32 rate: about 227 a sample
    assert b_top == "compute" and t_top == pytest.approx(
        s * (83.975 + 117.6 + 25.266) / 67e12, rel=1e-4)


def test_an_unknown_card_has_no_peaks():
    assert roofline.peaks("cpu") is None

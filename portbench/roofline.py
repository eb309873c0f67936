"""The least work of a configuration's chain, per input sample, and the
least time it takes on a card at the published peaks (``peaks.json``).

The counts are those of the cheapest correct implementation, not of the
program's kernels, so that no later implementation can read above 100 %:

* FIR: the lesser time of direct form (``2 * ntaps`` FLOP a sample at the
  precision's product rate) and overlap-save at ``nfft`` = the next power
  of two >= ``4 * ntaps`` (two real FFTs of ``2.5 nfft log2 nfft`` and
  6 FLOP a bin of the product, per hop of ``nfft - ntaps + 1`` samples,
  at the fp32 rate);
* resampler: ``2 * taps_per_phase`` FLOP an output, ``up / down`` outputs
  an input sample, at the product rate;
* frames: one rFFT of ``2.5 N log2 N`` FLOP a frame of ``N`` output
  samples, at the fp32 rate;
* bytes: each input sample read once (float32) and each complex64 bin of
  the frames written once.

Product rates: fp32 at "highest"; three bf16 passes at "high"."""

from __future__ import annotations

import json
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(device_name: str):
    """The card's published peaks, or None for a card not in the table."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(device_name)


def product_tflops(pk: dict, precision: str) -> float:
    return {"highest": pk["fp32_tflops"],
            "high": pk["bf16_tflops"] / 3.0}[precision]


def fir_ols_flop_per_sample(ntaps: int) -> float:
    nfft = 1 << math.ceil(math.log2(4 * ntaps))
    per_hop = 2 * 2.5 * nfft * math.log2(nfft) + 6 * (nfft // 2 + 1)
    return per_hop / (nfft - ntaps + 1)


def fir_direct_flop_per_sample(ntaps: int) -> float:
    return 2.0 * ntaps


def resample_flop_per_sample(up: int, down: int, taps_per_phase: int):
    return 2.0 * taps_per_phase * up / down


def frames_flop_per_sample(up: int, down: int, n: int) -> float:
    return 2.5 * math.log2(n) * up / down


def channelizer_bytes_per_sample(up: int, down: int, n: int) -> float:
    return 4.0 + (up / down) / n * (n // 2 + 1) * 8.0


def channelizer_least_s(cfg: dict, precision: str, pk: dict,
                        samples: float):
    """``(seconds, "compute" | "bytes")``: the least time of the
    channelizer's work on ``samples`` input samples, and which bound sets
    it."""
    from portbench.design import ratio

    up, down = ratio(cfg)
    ntaps = cfg["fir"]["numtaps"]
    fp32 = pk["fp32_tflops"] * 1e12
    prod = product_tflops(pk, precision) * 1e12
    fir = min(fir_direct_flop_per_sample(ntaps) / prod,
              fir_ols_flop_per_sample(ntaps) / fp32)
    rs = resample_flop_per_sample(up, down,
                                  cfg["resample"]["taps_per_phase"]) / prod
    fr = frames_flop_per_sample(up, down, cfg["fft_n"]) / fp32
    compute = (fir + rs + fr) * samples
    moved = channelizer_bytes_per_sample(up, down, cfg["fft_n"]) * samples \
        / (pk["hbm_tbps"] * 1e12)
    return (compute, "compute") if compute >= moved else (moved, "bytes")

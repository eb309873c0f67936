"""The least time of the STFT → per-bin gain → iSTFT chain on a card, at
the published peaks (``peaks.json``).  The counts are the configuration's
work, not the program's passes, so that any later engine (a fused kernel,
another FFT) reads against the same yardstick and none can read above
100 %:

* bytes: each input sample read once and each output sample written once,
  float32: 8 B a sample;
* operations: a frame a hop; per frame two real FFTs of ``2.5 N log2 N``
  FLOP (the ``roofline.py`` convention), the analysis window's ``N``
  products, the gain's ``2 (N/2 + 1)`` (a real gain on a complex bin),
  the synthesis window's ``N`` and the overlap-add's ``N`` sums, at the
  fp32 rate.  The envelope's division is left out: in a stream's interior
  the envelope is periodic in the hop and folds into the synthesis window.

At the cell's step (256 × 95 744 samples, 47 872 frames of 2048):
5.785 GFLOP, 86.3 µs at 67 TFLOP/s; 196.1 MB, 58.5 µs at 3.35 TB/s."""

from __future__ import annotations

import math

BYTES_PER_SAMPLE = 8.0


def flop_per_frame(n_fft: int) -> float:
    """The chain's least operations a frame of ``n_fft``."""
    ffts = 2 * 2.5 * n_fft * math.log2(n_fft)
    return ffts + n_fft + 2 * (n_fft // 2 + 1) + n_fft + n_fft


def chain_least_s(cfg: dict, pk: dict, samples: float):
    """``(seconds, "compute" | "bytes")``: the least time of the chain over
    ``samples`` input samples (every channel), and which bound sets it."""
    st = cfg["stft"]
    frames = samples / st["hop"]
    compute = flop_per_frame(st["n_fft"]) * frames / (
        pk["fp32_tflops"] * 1e12)
    moved = BYTES_PER_SAMPLE * samples / (pk["hbm_tbps"] * 1e12)
    return (compute, "compute") if compute >= moved else (moved, "bytes")

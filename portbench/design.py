"""The benchmark's own filter designs, in NumPy and SciPy, from a
configuration's widths.  The same taps go to the program and to the
reference, so neither side's design code is under test."""

from __future__ import annotations

import math

import numpy as np
from scipy import signal


def fir_taps(cfg: dict) -> np.ndarray:
    """The configuration's FIR: ``numtaps`` taps, a windowed lowpass at
    ``cutoff`` (a fraction of Nyquist), float64."""
    fir = cfg["fir"]
    return signal.firwin(fir["numtaps"], fir["cutoff"],
                         window=fir["window"]).astype(np.float64)


def ratio(cfg: dict) -> tuple:
    """The resampler's ``(up, down)`` in lowest terms."""
    rs = cfg["resample"]
    g = math.gcd(rs["up"], rs["down"])
    return rs["up"] // g, rs["down"] // g


def resample_taps(cfg: dict) -> np.ndarray:
    """The polyphase prototype: ``up · taps_per_phase`` taps of a Kaiser
    lowpass with passband gain ``up``, its -6 dB point half a transition
    width below the tighter Nyquist, so that the full stopband lies at the
    fold frequency (the design the program's ``resample_taps`` makes by
    default, written again here)."""
    up, down = ratio(cfg)
    beta = float(cfg["resample"]["kaiser_beta"])
    n = up * cfg["resample"]["taps_per_phase"]
    cutoff = 1.0 / max(up, down)
    atten = beta / 0.1102 + 8.7  # the Kaiser beta formula, inverted
    trans = (atten - 7.95) / (2.285 * n) / np.pi
    cutoff = max(cutoff - trans / 2.0, cutoff * 0.5)
    h = signal.firwin(n, cutoff, window=("kaiser", beta))
    return (h * up).astype(np.float64)

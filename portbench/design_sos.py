"""The benchmark's own IIR design, in float64 NumPy, from a
configuration's ``iir`` group: peaking sections from the RBJ Audio EQ
Cookbook (R. Bristow-Johnson), one a centre frequency.  The same ``sos``
goes to the program and to the reference, so neither side's design code
is under test."""

from __future__ import annotations

import numpy as np


def peaking(f0: float, gain_db: float, q: float, fs: float) -> np.ndarray:
    """One cookbook peaking biquad as a ``[b0 b1 b2 1 a1 a2]`` row."""
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * f0 / fs
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    b = np.array([1.0 + alpha * a, -2.0 * cw, 1.0 - alpha * a])
    den = np.array([1.0 + alpha / a, -2.0 * cw, 1.0 - alpha / a])
    return np.concatenate([b, den]) / den[0]


def eq_sos(cfg: dict) -> np.ndarray:
    """The configuration's EQ, ``(sections, 6)`` float64."""
    iir = cfg["iir"]
    if iir["kind"] != "peaking_eq":
        raise ValueError(f"no design for an IIR of kind {iir['kind']!r}")
    return np.stack([peaking(float(f), float(g), float(iir["q"]),
                             float(iir["sample_rate"]))
                     for f, g in zip(iir["freqs"], iir["gains_db"])])

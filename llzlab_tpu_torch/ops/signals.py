"""Test-signal generators: tones, chirps, pulses, noise (port of
``llzlab_tpu/ops/signals.py``, copied so that the port never imports the
JAX package; the outputs are bitwise its outputs).

Host-side float64 numpy: these make inputs for the chains and their
goldens, they are not hot ops.  Semantics match scipy.signal where a
counterpart exists (chirp, square, sawtooth, gausspulse).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "tone",
    "multitone",
    "chirp",
    "square",
    "sawtooth",
    "gausspulse",
    "white_noise",
    "pink_noise",
    "noisy_tones",
]


def tone(freq: float, seconds: float, fs: float, *, amp: float = 1.0,
         phase: float = 0.0) -> np.ndarray:
    """A single sinusoid ``amp·sin(2πf·t + phase)``."""
    t = np.arange(int(round(seconds * fs)), dtype=np.float64) / fs
    return amp * np.sin(2.0 * np.pi * freq * t + phase)


def multitone(freqs: Sequence[float], seconds: float, fs: float,
              *, amps: Optional[Sequence[float]] = None) -> np.ndarray:
    """Sum of sinusoids (equal amplitudes unless given)."""
    freqs = list(freqs)
    if amps is None:
        amps = [1.0 / max(len(freqs), 1)] * len(freqs)
    out = np.zeros(int(round(seconds * fs)), dtype=np.float64)
    for f, a in zip(freqs, amps):
        out += tone(f, seconds, fs, amp=a)
    return out


def chirp(t, f0: float, t1: float, f1: float, method: str = "linear",
          phi: float = 0.0) -> np.ndarray:
    """Frequency-swept cosine (scipy.signal.chirp semantics).

    ``method``: "linear" | "quadratic" | "logarithmic" | "hyperbolic".
    ``phi`` in degrees.
    """
    t = np.asarray(t, dtype=np.float64)
    method = method.lower()
    if method in ("linear", "lin", "li"):
        beta = (f1 - f0) / t1
        phase = 2.0 * np.pi * (f0 * t + 0.5 * beta * t * t)
    elif method in ("quadratic", "quad", "q"):
        beta = (f1 - f0) / (t1 * t1)
        phase = 2.0 * np.pi * (f0 * t + beta * t**3 / 3.0)
    elif method in ("logarithmic", "log", "lo"):
        if f0 * f1 <= 0:
            raise ValueError("logarithmic chirp needs f0, f1 of equal sign")
        if f0 == f1:
            phase = 2.0 * np.pi * f0 * t
        else:
            beta = t1 / np.log(f1 / f0)
            phase = 2.0 * np.pi * beta * f0 * ((f1 / f0) ** (t / t1) - 1.0)
    elif method in ("hyperbolic", "hyp"):
        if f0 == 0 or f1 == 0:
            raise ValueError("hyperbolic chirp needs nonzero f0, f1")
        if f0 == f1:
            phase = 2.0 * np.pi * f0 * t
        else:
            sing = -f1 * t1 / (f0 - f1)
            phase = 2.0 * np.pi * (-sing * f0) * np.log(np.abs(1.0 - t / sing))
    else:
        raise ValueError(f"unknown chirp method {method!r}")
    return np.cos(phase + np.pi * phi / 180.0)


def square(t, duty: float = 0.5) -> np.ndarray:
    """Square wave of period 2π (scipy.signal.square semantics)."""
    t = np.asarray(t, dtype=np.float64)
    frac = np.mod(t, 2.0 * np.pi) / (2.0 * np.pi)
    return np.where(frac < duty, 1.0, -1.0)


def sawtooth(t, width: float = 1.0) -> np.ndarray:
    """Sawtooth/triangle wave of period 2π (scipy.signal.sawtooth)."""
    t = np.asarray(t, dtype=np.float64)
    frac = np.mod(t, 2.0 * np.pi) / (2.0 * np.pi)
    rising = frac < width
    up = 2.0 * frac / width - 1.0 if width > 0 else np.zeros_like(frac)
    down = (1.0 - 2.0 * (frac - width) / (1.0 - width)
            if width < 1.0 else np.ones_like(frac))
    return np.where(rising, up, down)


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5,
               bwr: float = -6.0) -> np.ndarray:
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse semantics)."""
    if fc <= 0 or bw <= 0 or bwr >= 0:
        raise ValueError("need fc > 0, bw > 0, bwr < 0")
    t = np.asarray(t, dtype=np.float64)
    ref = 10.0 ** (bwr / 20.0)
    a = -((np.pi * fc * bw) ** 2) / (4.0 * np.log(ref))
    return np.exp(-a * t * t) * np.cos(2.0 * np.pi * fc * t)


def white_noise(n: int, *, seed: int = 0, amp: float = 1.0) -> np.ndarray:
    """Gaussian white noise, unit (·amp) standard deviation."""
    return amp * np.random.default_rng(seed).standard_normal(n)


def pink_noise(n: int, *, seed: int = 0) -> np.ndarray:
    """1/f ("pink") noise via spectral shaping, unit standard deviation."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(n // 2 + 1)
    f = np.arange(n // 2 + 1, dtype=np.float64)
    f[0] = 1.0
    spec /= np.sqrt(f)
    spec[0] = 0.0
    x = np.fft.irfft(spec, n)
    return x / np.std(x)


def noisy_tones(freqs: Sequence[float], seconds: float, fs: float,
                *, snr_db: float = 40.0, seed: int = 0) -> np.ndarray:
    """The survey's standard test vector: tones + calibrated white noise
    (SURVEY.md §4.2 "noise+tones")."""
    sig = multitone(freqs, seconds, fs)
    p_sig = np.mean(sig**2)
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return sig + white_noise(len(sig), seed=seed, amp=np.sqrt(p_noise))

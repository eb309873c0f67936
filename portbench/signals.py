"""Inputs made from ``--seed``: the same seed gives the same inputs, on
the program's side and again on the reference's."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one named input of a run's seed."""
    key = ":".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def noise_block(seed: int, index: int, channels: int, samples: int,
                device) -> torch.Tensor:
    """Super-block ``index`` of a multichannel stream: unit Gaussian noise,
    float32, made on ``device`` by one generator call."""
    gen = torch.Generator(device=device).manual_seed(
        derive(seed, "block", index))
    return torch.randn((channels, samples), generator=gen, device=device,
                       dtype=torch.float32)


def audio(seed: int, samples: int) -> np.ndarray:
    """A single-channel float32 signal in host memory: unit Gaussian noise
    plus three tones (at 0.02, 0.2 and 0.6 of Nyquist, inside and outside
    the passband) with phases drawn from the seed."""
    rng = np.random.default_rng(derive(seed, "audio"))
    n = np.arange(samples)
    x = rng.standard_normal(samples)
    for f, phase in zip((0.02, 0.2, 0.6), rng.uniform(0, 2 * np.pi, 3)):
        x += np.sin(np.pi * f * n + phase)
    return x.astype(np.float32)


def sample_mask(seed: int, what: str, n: int, every: int) -> np.ndarray:
    """Which of ``n`` indices a run keeps for its check: about one in
    ``every``, drawn from the seed."""
    rng = np.random.default_rng(derive(seed, "keep", what))
    return rng.integers(0, every, n) == 0

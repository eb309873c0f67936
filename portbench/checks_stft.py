"""What decides ``correct`` in a stream of the spectral-gain chain in
blocks (``drivers/spectral_block.py``): the gain and the input blocks,
made from the seed; which outputs a run keeps; the plain reference's
outputs for them (``reference_stft.py``); and the number compared.  The
control (``control_stft.py``) puts the reference, at a lower precision,
in the program's place and goes through the same comparison.

Step ``i`` takes input block ``i mod input_blocks``.  Its output holds
positions whose frames reach back ``2 (n_fft − hop)`` samples into the
step before and no further, so each kept step is worked out again,
exactly (no truncated lookback), as the last ``block`` samples of the
reference's stream over those samples and its own input: over its input
alone for step 0, the stream's start, with its leading zeros and the
frames before the start left out."""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference_stft, signals

#: the highest and lowest tone of the signals, in Hz (as ``checks_sos``)
TONES_HZ = (50.0, 16000.0)
#: the range of the per-bin gain, in dB
GAIN_DB = (-20.0, 6.0)
#: rows of the reference worked out at once (float64, ~0.6 GB a piece of
#: a step of 95 744 samples)
REF_ROWS = 32


def gain(cfg: dict, seed: int) -> np.ndarray:
    """The static per-bin gain, ``(n_fft // 2 + 1,)`` float32: drawn
    log-uniformly over :data:`GAIN_DB` from the seed."""
    bins = cfg["stft"]["n_fft"] // 2 + 1
    rng = np.random.default_rng(signals.derive(seed, "stft_gain"))
    return (10.0 ** (rng.uniform(*GAIN_DB, bins) / 20.0)).astype(np.float32)


def input_block(cfg: dict, seed: int, index: int, channels: int,
                samples: int, device) -> torch.Tensor:
    """Input block ``index``, ``(channels, samples)`` float32 made on
    ``device``: unit Gaussian noise (``signals.noise_block``) plus three
    tones a channel at frequencies drawn log-uniformly over
    :data:`TONES_HZ`, phases drawn too, the tones' time running on from
    block to block."""
    rng = np.random.default_rng(signals.derive(seed, "stft_tones"))
    f = np.exp(rng.uniform(*np.log(TONES_HZ), (channels, 3))) \
        / cfg["sample_rate"]
    phase = rng.uniform(0.0, 2.0 * np.pi, (channels, 3))
    n = index * samples + torch.arange(samples, dtype=torch.float64,
                                       device=device)
    x = signals.noise_block(seed, index, channels, samples,
                            device).to(torch.float64)
    for k in range(3):
        fk = torch.from_numpy(f[:, k:k + 1]).to(device)
        pk = torch.from_numpy(phase[:, k:k + 1]).to(device)
        x += torch.sin(2.0 * np.pi * fk * n + pk)
    return x.to(torch.float32)


def lookback(cfg: dict) -> int:
    """Samples of the step before that a step's output depends on."""
    return 2 * (cfg["stft"]["n_fft"] - cfg["stft"]["hop"])


def sampled(seed: int, wl: dict, channels: int) -> dict:
    """``{step: rows}``: every ``every``-th step among the first
    ``within`` after step 0 (which a run keeps whole), ``rows`` channels
    of each, drawn from the seed."""
    chk = wl["check"]
    rng = np.random.default_rng(signals.derive(seed, "keep", "stft_rows"))
    return {s: np.sort(rng.choice(channels, min(chk["rows"], channels),
                                  replace=False))
            for s in range(chk["every"], chk["within"], chk["every"])}


def kept_steps(seed: int, wl: dict, channels: int, last: int):
    """``[(step, rows or None)]`` that a run whose last step is ``last``
    keeps: step 0 whole, the sampled steps before ``last``, ``last``
    whole."""
    out = [(0, None)] if last > 0 else []
    out += [(s, r) for s, r in sampled(seed, wl, channels).items()
            if s < last]
    return out + [(last, None)]


class Reference:
    """The reference's outputs of kept steps, from the inputs made again
    from the seed on ``device``."""

    def __init__(self, cfg, wl, seed, channels, block, device):
        self.cfg, self.block = cfg, block
        self.gain = gain(cfg, seed)
        self.inputs = [input_block(cfg, seed, b, channels, block, device)
                       for b in range(wl["input_blocks"])]
        self.channels = channels
        if block < lookback(cfg):
            raise ValueError(f"a block of {block} samples is shorter than "
                             f"the lookback {lookback(cfg)}")

    def step(self, i: int, rows=None, rounding=None) -> torch.Tensor:
        """Step ``i``'s output of ``rows`` (None: every channel),
        ``(rows, block)`` float64 on the inputs' device; ``rounding`` as
        ``reference_stft.stream``'s."""
        st = self.cfg["stft"]
        n = len(self.inputs)
        rows = np.arange(self.channels) if rows is None else np.asarray(rows)
        out = []
        for a in range(0, len(rows), REF_ROWS):
            idx = torch.as_tensor(rows[a:a + REF_ROWS],
                                  device=self.inputs[0].device)
            ctx = self.inputs[i % n][idx]
            if i > 0:
                prev = self.inputs[(i - 1) % n][idx, -lookback(self.cfg):]
                ctx = torch.cat([prev, ctx], dim=-1)
            y = reference_stft.stream(ctx, self.gain, st["n_fft"], st["hop"],
                                      rounding)
            out.append(y[:, -self.block:])
        return torch.cat(out)


def block_err_max(ref: Reference, kept) -> float:
    """The worst relative L2 error of a kept step (all its kept rows)
    against the reference; ``kept`` is ``[(step, rows or None, (r,
    block))]``; infinite where a kept output has another shape."""
    worst = 0.0
    for i, rows, y in kept:
        want = ref.step(i, rows)
        got = torch.as_tensor(y)
        if got.shape != want.shape:
            return float("inf")
        d = got.to(want.device, torch.float64) - want
        worst = max(worst, float(d.norm() / want.norm()))
    return worst


def check(cfg, wl, seed, kept, channels, block, device) -> dict:
    """``block_err_max`` of a run's kept steps."""
    ref = Reference(cfg, wl, seed, channels, block, device)
    return {"block_err_max": block_err_max(ref, kept)}

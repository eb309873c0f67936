"""What decides ``correct`` in a live stream of the polyphase resampler
(``drivers/resample_stream.py``): the channels' signals (made from the
seed, in host memory), which blocks a run keeps (``checks_sos.kept_mask``,
as the EQ's stream), and the plain reference's outputs for them
(``reference_resample.py``).  The control
(``control_resample.py``) puts the reference, at a lower precision, in
the program's place and goes through the same comparison.

A block whose length is a multiple of ``down`` starts a group of outputs,
and its outputs depend on its own input and on the ``K − 1`` input
samples before it (``K`` taps a phase) and on nothing earlier, so each
kept block is worked out again, exactly, from its input behind those
samples (zeros before the stream starts)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import design, reference_resample, signals
from portbench.checks_sos import contexts

#: the highest and lowest tone of the signals, in Hz (as ``checks_sos``)
TONES_HZ = (50.0, 16000.0)
#: rows (channels of kept blocks) of the reference worked out at once: the
#: zero-stuffed input of a 4000-sample block takes 4.8 MB a row in float64
REF_ROWS = 32


def stream_signal(cfg: dict, wl: dict, seed: int,
                  channels: int) -> np.ndarray:
    """The signals a run of the cell cycles, ``(channels,
    signal_samples)`` float32 in host memory, a distinct one a channel:
    unit Gaussian noise plus three tones at frequencies drawn
    log-uniformly over ``TONES_HZ``, phases drawn too."""
    samples = wl["signal_samples"]
    rng = np.random.default_rng(signals.derive(seed, "resample_audio"))
    x = rng.standard_normal((channels, samples))
    f = np.exp(rng.uniform(*np.log(TONES_HZ), (channels, 3))) \
        / cfg["sample_rate"]
    phase = rng.uniform(0.0, 2.0 * np.pi, (channels, 3))
    n = np.arange(samples)
    for k in range(3):
        x += np.sin(2.0 * np.pi * f[:, k:k + 1] * n + phase[:, k:k + 1])
    return x.astype(np.float32)


def history(cfg: dict) -> int:
    """``K − 1``: input samples before a block that its outputs read."""
    return cfg["resample"]["taps_per_phase"] - 1


def reference_blocks(cfg, wl, sig, blocks, device,
                     rounding=None) -> torch.Tensor:
    """The reference's outputs of ``blocks`` of the stream that cycles
    ``sig``, ``(n, C, block · up / down)`` float64 on ``device``."""
    taps = design.resample_taps(cfg)
    up, down = design.ratio(cfg)
    hist = history(cfg)
    ctx = torch.from_numpy(contexts(sig, blocks, wl["block"], hist))
    n, c = ctx.shape[:2]
    rows = ctx.reshape(n * c, -1)
    out = []
    for a in range(0, n * c, REF_ROWS):
        part = rows[a:a + REF_ROWS].to(device)
        out.append(reference_resample.resample(
            part[:, hist:], taps, up, down, zi=part[:, :hist],
            rounding=rounding))
    return torch.cat(out).reshape(n, c, -1)


def block_err_max(cfg, wl, sig, kept, device) -> float:
    """The worst relative L2 error of a kept block (all its channels)
    against the reference; ``kept`` is ``[(block index, (C, out))]``;
    infinite where a kept block has another shape."""
    worst = 0.0
    step = max(1, REF_ROWS // sig.shape[0])
    for a in range(0, len(kept), step):
        part = kept[a:a + step]
        want = reference_blocks(cfg, wl, sig, [i for i, _ in part], device)
        got = [torch.as_tensor(np.asarray(y)) for _, y in part]
        if any(g.shape != want.shape[1:] for g in got):
            return float("inf")
        d = torch.stack(got).to(want.device, torch.float64) - want
        err = ((d ** 2).sum((1, 2)) / (want ** 2).sum((1, 2))).sqrt()
        worst = max(worst, float(err.max()))
    return worst


def check(cfg, wl, seed, kept, channels, device) -> dict:
    """``block_err_max`` of a run's kept blocks."""
    sig = stream_signal(cfg, wl, seed, channels)
    return {"block_err_max": block_err_max(cfg, wl, sig, kept, device)}

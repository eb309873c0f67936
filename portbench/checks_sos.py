"""What decides ``correct`` in a stream of a multichannel IIR cascade:
the channels' signals (made from the seed, in host memory), which blocks a
run keeps, and the plain reference's outputs for them
(``reference_sos.py``).  ``drivers/sos_stream.py`` adds the split
check, which runs the program; the control (``control_sos.py``)
puts the reference, at a lower precision, in the program's place.

A block's outputs depend on every sample before it, so each kept block is
worked out again from its own input behind the ``H`` samples before it
(zeros before the stream starts), with ``H`` from the design's largest
pole radius (``reference_sos.history_len``): the state that the cut
leaves out weighs under 1e-17 of the signal."""

from __future__ import annotations

import numpy as np
import torch

from portbench import design_sos, reference_sos, signals
from portbench.checks import stream_sampled

#: the highest and lowest tone of the signals, in Hz
TONES_HZ = (50.0, 16000.0)


def stream_signal(cfg: dict, wl: dict, seed: int,
                  channels: int) -> np.ndarray:
    """The signals a run of the cell cycles, ``(channels,
    signal_samples)`` float32 in host memory, a distinct one a channel:
    unit Gaussian noise plus three tones at frequencies drawn
    log-uniformly over ``TONES_HZ``, phases drawn too."""
    samples = wl["signal_samples"]
    rng = np.random.default_rng(signals.derive(seed, "eq_audio"))
    x = rng.standard_normal((channels, samples))
    f = np.exp(rng.uniform(*np.log(TONES_HZ), (channels, 3))) \
        / cfg["iir"]["sample_rate"]
    phase = rng.uniform(0.0, 2.0 * np.pi, (channels, 3))
    n = np.arange(samples)
    for k in range(3):
        x += np.sin(2.0 * np.pi * f[:, k:k + 1] * n + phase[:, k:k + 1])
    return x.astype(np.float32)


def stream_block(sig: np.ndarray, i: int, block: int) -> np.ndarray:
    """Block ``i`` of the stream that cycles ``sig (C, N)``, ``(C, block)``
    float32, contiguous: a copy of a slice, or gathered by index modulo
    ``N`` where the cycle wraps."""
    n = sig.shape[1]
    a = (i * block) % n
    if a + block <= n:
        return np.ascontiguousarray(sig[:, a:a + block])
    idx = (a + np.arange(block)) % n
    return sig[:, idx]


def kept_mask(seed: int, wl: dict) -> np.ndarray:
    """Which blocks of a stream a run keeps, as a boolean mask over the
    block index (taken modulo its length): the first ``check.first``
    whole and about one in ``check.every`` drawn from the seed; a run
    keeps its last block too."""
    mask = stream_sampled(seed, wl).copy()
    mask[:wl["check"]["first"]] = True
    return mask


def contexts(sig: np.ndarray, blocks, block: int, hist: int) -> np.ndarray:
    """``(n, C, hist + block)`` float32: each block of the cycled stream
    behind the ``hist`` samples before it (zeros before the stream
    starts)."""
    pos = np.asarray(blocks)[:, None] * block + np.arange(-hist, block)
    ctx = sig[:, pos % sig.shape[1]]  # (C, n, hist + block)
    ctx[:, pos < 0] = 0.0
    return ctx.transpose(1, 0, 2)


def reference_blocks(cfg, wl, sig, blocks, device,
                     rounding=None) -> torch.Tensor:
    """The reference's outputs of ``blocks`` of the stream that cycles
    ``sig``, ``(n, C, block)`` float64 on ``device``."""
    sos = design_sos.eq_sos(cfg)
    block = wl["block"]
    hist = reference_sos.history_len(sos)
    ctx = torch.from_numpy(contexts(sig, blocks, block, hist)).to(device)
    n, c = ctx.shape[:2]
    y, _ = reference_sos.sosfilt(sos, ctx.reshape(n * c, -1),
                                 rounding=rounding)
    return y[:, hist:].reshape(n, c, block)


def block_err_max(cfg, wl, sig, kept, device) -> float:
    """The worst relative L2 error of a kept block (all its channels)
    against the reference; ``kept`` is ``[(block index, (C, block))]``."""
    idx = [i for i, _ in kept]
    want = reference_blocks(cfg, wl, sig, idx, device)
    got = torch.stack([torch.as_tensor(np.asarray(y)) for _, y in kept])
    if got.shape != want.shape:
        return float("inf")
    d = got.to(want.device, torch.float64) - want
    err = ((d ** 2).sum((1, 2)) / (want ** 2).sum((1, 2))).sqrt()
    return float(err.max())

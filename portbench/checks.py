"""What decides ``correct``: which outputs of the timed path a run keeps
(drawn from the seed, and always the last step in full), the plain
reference's outputs for them, and the numbers compared.  The control
(``control.py``) puts the reference, at a lower precision, in the
program's place and goes through the same comparison.

A channelizer step's outputs depend on its own input and on the last
``H`` samples of the step before it, so each kept step is checked on its
own: its input super-block and the tail of the one before are made again
from the seed."""

from __future__ import annotations

import numpy as np
import torch

from portbench import design, reference, signals

#: rows of the reference computed at once (float64, a few GiB on a card)
REF_ROWS = 32


# ---------------------------------------------------------------- plans

def channelizer_sampled(seed: int, wl: dict, channels: int) -> dict:
    """``{step: rows}``: the ``slots`` steps among the first ``within``
    whose frames of ``rows`` channels a run keeps, drawn from the seed;
    the same count on every seed, so that no seed changes the memory."""
    chk = wl["check"]
    rng = np.random.default_rng(signals.derive(seed, "keep", "steps"))
    steps = np.sort(rng.choice(chk["within"], chk["slots"], replace=False))
    return {int(s): np.sort(rng.choice(channels, min(chk["rows"], channels),
                                       replace=False))
            for s in steps}


def stream_sampled(seed: int, wl: dict, n_max: int = 1 << 22):
    """Which blocks of a stream a run keeps, as a boolean mask over the
    block index (taken modulo its length)."""
    return signals.sample_mask(seed, "blocks", n_max, wl["check"]["every"])


# ---------------------------------------------------------- channelizer

class _Blocks:
    """The run's input super-blocks, made again on ``device``, a few at a
    time."""

    def __init__(self, seed, wl, channels, samples, device):
        self.args = (seed, channels, samples, device)
        self.n = wl["input_blocks"]
        self.cache = {}

    def __call__(self, step: int) -> torch.Tensor:
        b = step % self.n
        if b not in self.cache:
            if len(self.cache) >= 2:
                self.cache.pop(next(iter(self.cache)))
            seed, c, t, dev = self.args
            self.cache[b] = signals.noise_block(seed, b, c, t, dev)
        return self.cache[b]


def channelizer_reference(cfg, wl, seed, steps_rows, channels, samples,
                          device, rounding=None):
    """Yield ``(step, rows, frames)`` of the reference, REF_ROWS rows at a
    time, for each ``(step, rows)`` (``rows`` None: every channel)."""
    taps, rtaps = design.fir_taps(cfg), design.resample_taps(cfg)
    up, down = design.ratio(cfg)
    hist = reference.channelizer_history(taps, rtaps, up)
    blocks = _Blocks(seed, wl, channels, samples, device)
    for step, rows in steps_rows:
        rows = np.arange(channels) if rows is None else np.asarray(rows)
        for i in range(0, len(rows), REF_ROWS):
            sel = torch.as_tensor(rows[i:i + REF_ROWS], device=device)
            cur = blocks(step).index_select(0, sel)
            prev = blocks(step - 1).index_select(0, sel)[:, -hist:] \
                if step > 0 else torch.zeros_like(cur[:, :hist])
            ctx = torch.cat([prev, cur], dim=-1)
            yield step, rows[i:i + REF_ROWS], reference.channelizer(
                ctx, taps, rtaps, up, down, cfg["fft_n"], rounding)


def frame_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each frame's relative L2 error, ``(R, F)``."""
    d = got.to(want.device, torch.complex128) - want
    return ((d.abs() ** 2).sum(-1) / (want.abs() ** 2).sum(-1)).sqrt()


def check_channelizer(cfg, wl, seed, kept, channels, samples, device):
    """``{"frame_err_max": worst}`` over the kept frames: ``kept`` is
    ``[(step, rows or None, frames (R, F, bins))]``, the program's."""
    worst = 0.0
    got = {step: (rows, frames) for step, rows, frames in kept}
    for step, rows, want in channelizer_reference(
            cfg, wl, seed, [(s, r) for s, (r, _) in got.items()],
            channels, samples, device):
        kept_rows, frames = got[step]
        if kept_rows is None:
            part = frames[torch.as_tensor(rows, device=frames.device)]
        else:
            pos = np.searchsorted(kept_rows, rows)
            part = frames[torch.as_tensor(pos, device=frames.device)]
        if part.shape != want.shape:
            return {"frame_err_max": float("inf")}
        worst = max(worst, float(frame_errors(part, want).max()))
    return {"frame_err_max": worst}


# --------------------------------------------------------------- stream

def stream_contexts(sig: np.ndarray, blocks, block: int, ntaps: int):
    """``(n, ntaps - 1 + block)`` float64: each block of the cycled
    stream ``sig`` behind its history (zeros before the stream starts)."""
    idx = np.asarray(blocks)[:, None] * block + np.arange(
        -(ntaps - 1), block)[None, :]
    ctx = sig[idx % len(sig)].astype(np.float64)
    ctx[idx < 0] = 0.0
    return ctx


def stream_reference(cfg, wl, seed, blocks, rounding=None) -> np.ndarray:
    taps = design.fir_taps(cfg)
    sig = signals.audio(seed, wl["signal_samples"])
    ctx = torch.from_numpy(stream_contexts(sig, blocks, wl["block"],
                                           len(taps)))
    return reference.fir_valid(ctx, taps, rounding).numpy()


def check_stream(cfg, wl, seed, kept):
    """``{"block_err_max": worst}``: each kept block's relative L2 error
    against the reference; ``kept`` is ``[(block index, output)]``."""
    idx = [i for i, _ in kept]
    got = np.stack([np.asarray(y, np.float64).reshape(-1) for _, y in kept])
    want = stream_reference(cfg, wl, seed, idx)
    if got.shape != want.shape:
        return {"block_err_max": float("inf")}
    err = np.sqrt(((got - want) ** 2).sum(-1) / (want ** 2).sum(-1))
    return {"block_err_max": float(err.max())}


CHECKS = {"channelizer": check_channelizer, "stream": check_stream}

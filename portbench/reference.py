"""Plain reference of the chains the benchmark drives, in float64
PyTorch, written from the definitions:

* FIR: ``y[n] = sum_k h[k] x[n-k]``, causal, computed as an FFT
  convolution over a context that holds the history;
* rational resampling: ``z[m] = sum_i h[m*down - i*up] y[i]`` (the
  ``upfirdn`` definition), one phase of outputs at a time;
* spectral frames: the rFFT of consecutive, non-overlapping frames.

``rounding`` rounds every product's operands to a narrower format first
("bf16" or "tf32", round to nearest even; the sums stay float64), which is
what a tensor core computing in that format does: the control of the
check.  This file imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def round_to(x: torch.Tensor, rounding) -> torch.Tensor:
    """``x`` rounded to ``rounding`` ("bf16", "tf32" or None), as float64."""
    if rounding is None:
        return x.to(F64)
    if rounding == "bf16":
        return x.to(torch.float32).to(torch.bfloat16).to(F64)
    if rounding == "tf32":  # keep 10 of float32's 23 mantissa bits
        bits = x.to(torch.float32).contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32).to(F64)
    raise ValueError(f"unknown rounding {rounding!r}")


def _taps(h, device, rounding) -> torch.Tensor:
    return round_to(torch.as_tensor(np.asarray(h, np.float64),
                                    device=device), rounding)


def fir_valid(ctx: torch.Tensor, taps, rounding=None) -> torch.Tensor:
    """Causal FIR over ``ctx (R, L)``: the ``L - ntaps + 1`` outputs whose
    every tap meets a sample of ``ctx``."""
    h = _taps(taps, ctx.device, rounding)
    x = round_to(ctx, rounding)
    ntaps, length = h.shape[0], x.shape[-1]
    nfft = 1 << (length + ntaps - 2).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft),
                        nfft)
    return y[..., ntaps - 1:length]


def resample(y: torch.Tensor, taps, up: int, down: int,
             rounding=None) -> torch.Tensor:
    """Rational resampling of ``y (R, k - 1 + T)``, whose first ``k - 1``
    samples are history (``k`` taps a phase), to the ``T * up / down``
    outputs of the ``T`` samples after it; ``T`` a multiple of ``down``."""
    h = _taps(taps, y.device, rounding)
    if h.shape[0] % up:
        h = torch.nn.functional.pad(h, (0, up - h.shape[0] % up))
    k = h.shape[0] // up
    y = round_to(y, rounding)
    t = y.shape[-1] - (k - 1)
    if t % down:
        raise ValueError(f"{t} samples are not a multiple of down={down}")
    groups = t // down
    z = y.new_empty(y.shape[:-1] + (groups, up))
    for p in range(up):
        # output m = up*s + p reads y[down*s + q - j] * h[up*j + r], j < k
        r, q = (p * down) % up, (p * down) // up
        win = y[..., q:q + (groups - 1) * down + k].unfold(-1, k, down)
        z[..., p] = win @ h[r::up].flip(0)
    return z.reshape(y.shape[:-1] + (groups * up,))


def frames(z: torch.Tensor, n: int) -> torch.Tensor:
    """rFFT of the whole ``n``-sample frames of ``z (R, T)``."""
    f = z.shape[-1] // n
    return torch.fft.rfft(z[..., :f * n].reshape(z.shape[:-1] + (f, n)))


def channelizer(ctx: torch.Tensor, fir_taps, rs_taps, up: int, down: int,
                fft_n: int, rounding=None) -> torch.Tensor:
    """FIR, resampler and frames of one step: ``ctx (R, H + T)`` holds the
    ``H = ntaps - 1 + k - 1`` input samples before the step, then its
    ``T``; returns the step's ``(R, F, fft_n // 2 + 1)`` complex128
    frames."""
    y = fir_valid(ctx, fir_taps, rounding)
    return frames(resample(y, rs_taps, up, down, rounding), fft_n)


def channelizer_history(fir_taps, rs_taps, up: int) -> int:
    """``H``: input samples before a step that its outputs depend on."""
    k = -(-len(rs_taps) // up)
    return len(fir_taps) - 1 + k - 1

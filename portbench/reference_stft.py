"""Plain reference of the STFT → per-bin gain → iSTFT chain (a weighted
overlap-add, WOLA), in float64 PyTorch, written from the definitions.  It
imports nothing of the program and no JAX.  ``tests/stft_reference.py``
and ``portbench/reference_stft.py`` are the same file.

For a stream ``x (R, T)`` from its start, frame ``i`` is ``x[i·hop :
i·hop + N]``; its spectrum is ``X_i = rfft(w · frame_i)`` with the periodic
Hann window ``w[n] = 0.5 − 0.5·cos(2πn/N)``; its synthesised frame is
``s_i = w · irfft(g · X_i)`` for the per-bin gain ``g``; and position ``p``
of the result is ``Σ_i s_i[p − i·hop] / Σ_i w[p − i·hop]²``, over the
frames that hold ``p``.

Departures from a textbook WOLA, each the stream convention of the
program's ``SpectralGainStage``:

* causal framing: the first frame starts at sample 0, with nothing padded
  before the stream (no centred frames), so the first hop is held by one
  frame, the second by two, and so on; frames that would start before the
  stream do not exist (the program masks them);
* the envelope ``Σ_i w[p − i·hop]²`` is clamped at 1e-8 where it is
  smaller (positions 0 to 6 of a 2048-point Hann stream), as the program
  clamps it;
* the result lags the input by ``N − hop`` samples: a position is
  emitted once every frame that holds it has arrived, so the stream leads
  with ``N − hop`` zeros, and the last ``N − hop`` positions wait for
  input still to come (the program's ``flush``).

``rounding="tf32"`` rounds the operands of every product (the windows,
the gain, and the frames and spectra they multiply) and every FFT's input
to TF32 first (10 of float32's 23 mantissa bits, round to nearest even;
the sums and the FFTs stay float64): the control of the benchmark's
check, one format below the configuration's "highest".  :func:`stream`
turns TF32 off for any product on a card."""

from __future__ import annotations

import math

import torch

F64 = torch.float64
#: the envelope's floor, the program's
ENV_FLOOR = 1e-8


def hann(n: int, device=None) -> torch.Tensor:
    """The periodic Hann window of ``n`` points, float64."""
    k = torch.arange(n, dtype=F64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (to nearest even), as float64; a complex ``x``
    part by part (as complex128)."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real), round_tf32(x.imag))
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(F64)


def stream(x: torch.Tensor, gain, n_fft: int, hop: int,
           rounding=None) -> torch.Tensor:
    """The chain's output of the stream ``x (R, T)`` from its start, in the
    program's stream convention: ``(R, T)`` float64 on ``x``'s device.
    ``gain`` holds ``n_fft // 2 + 1`` bins; ``T`` and ``n_fft`` are
    multiples of ``hop``."""
    if rounding not in (None, "tf32"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if n_fft % hop or x.shape[-1] % hop:
        raise ValueError("hop must divide n_fft and the stream's length")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = round_tf32 if rounding else (lambda v: v)
    x = x.to(F64)
    rows, t = x.shape
    dev = x.device
    lag = n_fft - hop
    y = torch.zeros((rows, t), dtype=F64, device=dev)
    if t < n_fft:
        return y
    w = hann(n_fft, dev)
    g = torch.as_tensor(gain).to(dev, F64)
    frames = x.unfold(-1, n_fft, hop)  # (R, nf, N), frame i at i·hop
    nf = frames.shape[1]
    spec = torch.fft.rfft(r(r(frames) * r(w)), dim=-1)
    synth = r(torch.fft.irfft(r(r(spec) * r(g)), n=n_fft, dim=-1)) * r(w)
    # position p of the result sums every s_i[p − i·hop]
    pos = (torch.arange(nf, device=dev)[:, None] * hop
           + torch.arange(n_fft, device=dev)).reshape(-1)
    length = (nf - 1) * hop + n_fft
    ola = torch.zeros((rows, length), dtype=F64, device=dev).index_add_(
        1, pos, synth.reshape(rows, -1))
    env = torch.zeros(length, dtype=F64, device=dev).index_add_(
        0, pos, (r(w) * r(w)).expand(nf, n_fft).reshape(-1))
    y[:, lag:] = (ola / torch.clamp(env, min=ENV_FLOOR))[:, :t - lag]
    return y

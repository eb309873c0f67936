"""Plain reference of rational polyphase resampling, in float64 PyTorch,
written from the ``upfirdn`` definition.  It imports nothing of the
program and no JAX.  ``tests/resample_reference.py`` and
``portbench/reference_resample.py`` are the same file.

For an input ``x`` behind its history ``zi`` (the ``H`` samples before
``x[0]``, zeros before them), the zero-stuffed input is ``x_up[n·up] =
x[n]`` and ``x_up = 0`` between, with ``x_up[0] = x[0]`` and the history
at negative positions.  Output ``m`` is

    y[m] = Σ_j h[j] · x_up[m·down − j],   0 ≤ j < len(h),

for ``m = 0 .. ceil(T·up/down) − 1`` (``T`` samples of ``x``), the
program's truncation.  The sum is evaluated over its terms whose
``x_up`` position is a multiple of ``up`` (``j ≡ m·down mod up``): the
others multiply a zero that the stuffing put there, by construction.
Positions past the input's end read zeros.

``rounding="tf32"`` rounds both operands of every product (the taps and
the input) to TF32 first (10 of float32's 23 mantissa bits, round to
nearest even; the sums stay float64): the control of the benchmark's
check, one format below the configuration's "highest".  :func:`resample`
turns TF32 off for any product on a card."""

from __future__ import annotations

import torch

F64 = torch.float64


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (to nearest even), as float64."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(F64)


def output_len(t: int, up: int, down: int) -> int:
    """``ceil(t·up/down)``: the outputs of ``t`` input samples."""
    return -(-t * up // down)


def resample(x: torch.Tensor, taps, up: int, down: int, zi=None,
             rounding=None) -> torch.Tensor:
    """The outputs of ``x (R, T)`` behind the history ``zi (R, H)`` (None:
    zeros), ``(R, ceil(T·up/down))`` float64 on ``x``'s device; ``taps``
    the prototype ``h``, applied at the rate ``up / down`` as given."""
    if rounding not in (None, "tf32"):
        raise ValueError(f"unknown rounding {rounding!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = round_tf32 if rounding else (lambda v: v.to(F64))
    dev = x.device
    h = r(torch.as_tensor(taps, dtype=F64).to(dev))
    rows, t = x.shape
    if zi is None:
        zi = x.new_zeros((rows, 0))
    hist = zi.shape[-1]
    ctx = r(torch.cat([zi.to(F64), x.to(F64)], dim=-1))
    # the zero-stuffed stream, x_up[0] at column hist·up; one zero sample
    # after its end stands for every position past it
    x_up = torch.zeros((rows, (hist + t) * up + 1), dtype=F64, device=dev)
    x_up[:, :(hist + t) * up:up] = ctx
    m = torch.arange(output_len(t, up, down), device=dev)[:, None]
    j = (m * down) % up + up * torch.arange(-(-len(h) // up),
                                            device=dev)[None, :]
    pos = m * down - j + hist * up  # column of x_up[m·down − j]
    live = (j < len(h)) & (pos >= 0)
    pos = torch.where(live & (pos < x_up.shape[-1]), pos, x_up.shape[-1] - 1)
    hj = torch.where(live, h[j.clamp(max=len(h) - 1)], 0.0)
    return (x_up[:, pos] * hj).sum(-1)

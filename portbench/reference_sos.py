"""Plain reference of a cascade of second-order sections, in float64
PyTorch, written from the definition.  Each section is its difference
equation

    y[n] = b0·x[n] + b1·x[n−1] + b2·x[n−2] − a1·y[n−1] − a2·y[n−2]

(rows ``[b0 b1 b2 1 a1 a2]``), and the sections run one after another.
It imports nothing of the program and no JAX.

Departures from the definition, each with its reason:

* each section runs in transposed direct form II, whose two states carry
  the same recurrence: equal to the difference equation in exact
  arithmetic, and the form whose state a stream carries from one call to
  the next;
* float64 throughout (the program computes in float32), so that the
  reference's own rounding lies far below the program's;
* the loop runs over the samples and is vectorised across rows;
* :func:`history_len` gives a truncated history: a block filtered from
  zero state behind the ``H`` samples before it differs from the whole
  stream's output by what the state of ``H`` samples back still weighs,
  at most ``r^H`` of it for the largest pole radius ``r``.

``rounding`` rounds every product's operands to a narrower format first
(``reference.round_to``: "bf16" or "tf32"; the sums and the states stay
float64), which is what a tensor core computing in that format does: the
control of the check.  :func:`sosfilt` turns TF32 off for any product on
a card, though its loop has none that a tensor core would run."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import round_to

F64 = torch.float64


def pole_radius(sos) -> float:
    """The largest pole radius of the cascade's sections."""
    sos = np.asarray(sos, np.float64)
    return max(float(np.abs(np.roots([1.0, a1, a2])).max())
               for a1, a2 in sos[:, 4:6])


def history_len(sos, eps: float = 1e-17) -> int:
    """``H``, the samples of history after which the state left behind
    weighs under ``eps``: the least ``H`` with ``r^H < eps``."""
    r = pole_radius(sos)
    if not r < 1.0:
        raise ValueError(f"an unstable cascade (pole radius {r})")
    return int(math.floor(math.log(eps) / math.log(r))) + 1


def sosfilt(sos, x: torch.Tensor, zi=None, rounding=None):
    """The cascade over ``x (R, T)``, along ``T``, from the states ``zi
    (R, ns, 2)`` (zeros if None).  Returns ``(y (R, T), zf (R, ns, 2))``,
    float64 on ``x``'s device."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6 or not np.all(sos[:, 3] == 1.0):
        raise ValueError("sos must be (ns, 6) rows with a0 == 1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cur = x.to(F64).T.contiguous()  # (T, R): one sample of every row
    rows = cur.shape[1]
    zi = torch.zeros((rows, len(sos), 2), dtype=F64, device=x.device) \
        if zi is None else torch.as_tensor(zi).to(x.device, F64)
    zf = torch.empty_like(zi)
    coef = round_to(torch.from_numpy(sos), rounding).tolist()
    for s, (b0, b1, b2, _, a1, a2) in enumerate(coef):
        z1, z2 = zi[:, s, 0].clone(), zi[:, s, 1].clone()
        xs = round_to(cur, rounding)  # cur itself without rounding
        out = torch.empty_like(cur)
        for n in range(cur.shape[0]):
            xn = xs[n]
            yn = xn * b0 + z1
            yr = round_to(yn, rounding) if rounding else yn
            z1 = xn * b1 - yr * a1 + z2
            z2 = xn * b2 - yr * a2
            out[n] = yn
        zf[:, s, 0], zf[:, s, 1] = z1, z2
        cur = out
    return cur.T, zf

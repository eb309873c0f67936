"""FIR → polyphase resample as one op (port of
``llzlab_tpu/ops/fused_chain.py``).

Two engines compute the same linear map:

* ``"kernel"``: kernel B1 (``kernels/fused_fir_resample.py``), the port's
  name for the JAX package's ``"pallas"`` engine, with the same envelope
  and the same ``2·block`` history.  On a CPU tensor it runs the kernel's
  plain version.
* ``"composite"``: both stages folded on host into one block-periodic
  map, ``z[s, p] = Σ_i G[p, i] · x[s·down + i − offset]`` with
  ``G[p] = conv(W_r[p], reverse(h_fir))``, evaluated as ``ceil(|G|/down)``
  shifted block products summed (plain f32 torch; XLA einsum in the JAX
  package).

``"auto"`` picks ``"kernel"`` for a CUDA tensor that the kernel accepts,
else ``"composite"``: the rule of the JAX package, with ``x.is_cuda`` in
place of its TPU backend test.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.kernels import fused_fir_resample as _ff
from llzlab_tpu_torch.ops.resample import (
    polyphase_weights,
    resample_output_len,
    resample_taps,
)
from llzlab_tpu_torch.runtime.platform import kernel_mode

__all__ = ["fir_resample", "fir_resample_state_len", "fir_resample_tables",
           "fir_resample_engine"]

ENGINES = ("auto", "kernel", "composite")


@functools.lru_cache(maxsize=16)
def _tables_cached(fir_bytes: bytes, r_bytes: bytes, up: int, down: int,
                   device: str):
    h_fir = np.frombuffer(fir_bytes, np.float64)
    rtaps = np.frombuffer(r_bytes, np.float64)
    if len(rtaps) % up != 0:
        rtaps = np.pad(rtaps, (0, up - len(rtaps) % up))
    k = len(rtaps) // up
    w_r = polyphase_weights(rtaps, up, down)  # (up, down+k-1) float64
    ntaps = len(h_fir)
    offset = (k - 1) + (ntaps - 1)
    # W_r rows hold the bank time-reversed (newest input at the highest
    # column), so the composite row is conv with the *reversed* FIR taps.
    g = np.stack([np.convolve(w_r[p], h_fir[::-1]) for p in range(up)])
    hist_parts = -(-offset // down)
    pad_front = hist_parts * down - offset
    gp = np.pad(g, ((0, 0), (pad_front, 0)))
    nparts = -(-gp.shape[1] // down)
    gp = np.pad(gp, ((0, 0), (0, nparts * down - gp.shape[1])))
    # (nparts, down, up) float32: part e multiplies input block s+e.
    gparts = gp.reshape(up, nparts, down).transpose(1, 2, 0).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(gparts)).to(device),
            hist_parts * down)


def fir_resample_tables(fir_taps, up: int, down: int, rtaps, device="cpu"):
    """Composite weight blocks ``(nparts, down, up)`` on ``device`` and
    history length."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    return _tables_cached(
        np.asarray(fir_taps, np.float64).tobytes(),
        np.asarray(rtaps, np.float64).tobytes(),
        up, down, str(device),
    )


def fir_resample_state_len(fir_taps_len: int, up: int, down: int,
                           rtaps_len: int, *, engine: str = "composite"
                           ) -> int:
    """Streaming history length (input samples) of the resolved ``engine``
    ("kernel" or "composite"; their histories differ)."""
    if engine == "kernel":
        return _ff.fused_state_len(fir_taps_len)
    g = math.gcd(up, down)
    up, down = up // g, down // g
    k = -(-rtaps_len // up)
    offset = (k - 1) + (fir_taps_len - 1)
    return -(-offset // down) * down


def fir_resample_engine(channels: int, fir_taps_len: int, up: int,
                        down: int, rtaps_len: int, t: int, *,
                        device) -> str:
    """Resolve "auto": "kernel" on a CUDA device when kernel B1 accepts
    the call, else "composite"."""
    if torch.device(device).type != "cuda":
        return "composite"
    g = math.gcd(up, down)
    up_r, down_r = up // g, down // g
    k = -(-rtaps_len // up_r)
    if (_ff.fused_supports(channels, fir_taps_len, up_r, down_r, k, t)
            and _ff.kernel_fits(fir_taps_len, down_r, k)):
        return "kernel"
    return "composite"


def _fir_resample_impl(x, gparts, zi, *, up, down, hist_len, return_zf):
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).to(torch.float32)
    b = xb.shape[0]
    if zi is None:
        hist = torch.zeros((b, hist_len), dtype=torch.float32,
                           device=x.device)
    else:
        hist = zi.reshape(b, hist_len).to(torch.float32)
    s_groups = -(-t // down)
    nparts = gparts.shape[0]
    stream_len = (s_groups + nparts - 1) * down
    xs = torch.cat([hist, xb], dim=-1)
    xs = F.pad(xs, (0, max(stream_len - xs.shape[-1], 0)))[:, :stream_len]
    z = None
    for e in range(nparts):
        part = xs[:, e * down: (e + s_groups) * down].reshape(
            b, s_groups, down)
        term = part @ gparts[e]
        z = term if z is None else z + term
    n_out = resample_output_len(t, up, down)
    z = z.reshape(b, s_groups * up)[:, :n_out]
    z = z.reshape(shape[:-1] + (n_out,)).to(x.dtype)
    if not return_zf:
        return z
    # Final history: the last hist_len *input* samples of (hist ++ signal).
    zf = torch.cat([hist, xb], dim=-1)[:, -hist_len:]
    zf = zf.to(x.dtype).reshape(shape[:-1] + (hist_len,))
    return z, zf


def fir_resample(
    x: torch.Tensor,
    fir_taps,
    up: int,
    down: int,
    *,
    rtaps=None,
    taps_per_phase: int = 64,
    zi: Optional[torch.Tensor] = None,
    return_zf: bool = False,
    engine: str = "auto",
    precision: Optional[str] = None,
):
    """FIR filter + rational resample as one op.

    Numerically equal (same linear map, sums reassociated) to
    ``resample_poly(fir_filter(x, fir_taps), up, down, taps=rtaps)``.

    Args:
      x: ``(..., T)`` tensor.
      fir_taps: ``(ntaps,)`` host FIR taps.
      up, down: rational rate factors (reduced by gcd internally).
      rtaps: optional resampler prototype (designed if omitted).
      zi: optional ``(..., fir_resample_state_len(..., engine=E))`` input
        history, where ``E`` is the resolved engine.
      return_zf: also return the final history.
      engine: "auto" | "kernel" | "composite" (see the module docstring);
        streaming callers resolve it once, since the histories differ.
      precision: "high" (bf16x3) | "highest" (f32) for the kernel engine;
        None reads ``LLZ_MATMUL_PRECISION`` (default "highest").  The
        composite always runs f32.

    Streaming is exact when each fed block has ``T % down == 0``
    (composite) or ``T`` a multiple of ``fused_program_in`` (kernel).
    """
    g = math.gcd(up, down)
    up_r, down_r = up // g, down // g
    if rtaps is None:
        rtaps = resample_taps(up_r, down_r, taps_per_phase)
    if engine == "auto":
        channels = int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1
        engine = fir_resample_engine(
            channels, len(np.asarray(fir_taps)), up_r, down_r,
            len(np.asarray(rtaps)), x.shape[-1], device=x.device)
    if engine == "kernel":
        return _ff.fused_fir_resample(
            x, fir_taps, up_r, down_r, rtaps, zi=zi, return_zf=return_zf,
            mode=kernel_mode(precision),
        )
    if engine != "composite":
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    gparts, hist_len = fir_resample_tables(fir_taps, up_r, down_r, rtaps,
                                           x.device)
    return _fir_resample_impl(
        x, gparts, zi, up=up_r, down=down_r, hist_len=hist_len,
        return_zf=return_zf,
    )

"""FIR filter design and filtering (port of ``llzlab_tpu/ops/fir.py``).

Design is host-side float64 numpy, the same code as the JAX package, so
the taps are bit-equal.  Three filtering engines:

* ``block2``: direct convolution over blocks of ``block2_block(ntaps)``
  samples, where every output block depends on its own input block and
  the one before it.  A CUDA tensor runs kernel B2
  (``kernels/block2_fir.py``); a CPU tensor runs that kernel's plain
  PyTorch version.
* ``ols``: overlap-save through ``torch.fft`` (``ops/transform.py``).
* ``direct``: one ``conv1d`` over the history-padded signal.

The JAX package's ``im2col`` engine and its low-channel block2 fold are
not ported yet (ROADMAP queue A, "FIR alone").

Streaming: ``fir_filter(concat(a, b))`` equals ``concat(ya, yb)`` with
``ya, zf = fir_filter(a, return_zf=True)`` and ``yb = fir_filter(b,
zi=zf)``, bit for bit for ``block2`` and ``ols`` when ``len(a)`` is a
multiple of the block (``block2_block``) or hop (``ols_hop``).  The
history length is ``fir_state_len(ntaps, nfft, method)``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.kernels import block2_fir as _bf
from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.ops.window import get_window
from llzlab_tpu_torch.runtime.platform import kernel_mode

__all__ = [
    "firwin",
    "fir_filter",
    "default_nfft",
    "ols_hop",
    "fir_state_len",
    "fir_halo",
    "block2_block",
]


# ---------------------------------------------------------------------------
# Design (host-side, float64)
# ---------------------------------------------------------------------------


def _sinc_bands(m: np.ndarray, bands: Sequence[tuple]) -> np.ndarray:
    """Ideal impulse response for a union of passbands (edges in Nyquist units)."""
    h = np.zeros_like(m)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    return h


def firwin(
    numtaps: int,
    cutoff: Union[float, Sequence[float]],
    *,
    window="hamming",
    pass_zero: Union[bool, str] = True,
    fs: float = 2.0,
) -> np.ndarray:
    """Window-method FIR design (lowpass/highpass/bandpass/bandstop).

    Matches ``scipy.signal.firwin`` semantics: ``cutoff`` in the same units
    as ``fs`` (default Nyquist units), ``pass_zero`` selecting whether DC is
    in a passband (or one of "lowpass"/"highpass"/"bandpass"/"bandstop").
    Returns float64 taps; cast at the filtering site.
    """
    if isinstance(pass_zero, str):
        pass_zero = pass_zero.lower() in ("lowpass", "bandstop")
    cut = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) * 2.0 / fs
    if np.any(cut <= 0) or np.any(cut >= 1):
        raise ValueError("cutoff must lie strictly inside (0, fs/2)")
    if np.any(np.diff(cut) <= 0):
        raise ValueError("cutoff frequencies must be strictly increasing")

    # Build band edges: prepend 0 if DC passes, append 1 if Nyquist passes.
    edges = list(cut)
    if pass_zero:
        edges = [0.0] + edges
    if len(edges) % 2 == 1:
        edges = edges + [1.0]
    passes_nyquist = edges[-1] == 1.0
    if passes_nyquist and numtaps % 2 == 0:
        raise ValueError(
            "an even number of taps cannot pass Nyquist (type II zero at fs/2); "
            "use odd numtaps"
        )
    bands = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]

    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps, dtype=np.float64) - alpha
    h = _sinc_bands(m, bands)
    h *= get_window(window, numtaps, periodic=False)

    # Normalise unity gain at the reference frequency of the first passband
    # (DC if it passes zero, Nyquist if it touches fs/2, else band centre).
    left, right = bands[0]
    if left == 0.0:
        fc = 0.0
    elif right == 1.0:
        fc = 1.0
    else:
        fc = 0.5 * (left + right)
    scale = np.sum(h * np.cos(np.pi * m * fc))
    h /= scale
    return h


# ---------------------------------------------------------------------------
# Engine geometry
# ---------------------------------------------------------------------------


def default_nfft(ntaps: int) -> int:
    """Overlap-save FFT size: next power of two ≥ 4·ntaps."""
    return 1 << max(8, math.ceil(math.log2(4 * max(ntaps, 2))))


def ols_hop(ntaps: int, nfft: int) -> int:
    """Valid samples per overlap-save block, rounded down to a multiple of
    512 (or the largest power of two below it) for friendly stream grids."""
    raw = nfft - ntaps + 1
    if raw <= 0:
        raise ValueError(f"nfft={nfft} too small for ntaps={ntaps}")
    g = 512
    while g > raw:
        g //= 2
    return (raw // g) * g


def block2_block(ntaps: int) -> int:
    """Block size for method="block2": smallest multiple of 128 ≥ ntaps−1."""
    return max(128, 128 * (-(-(ntaps - 1) // 128)))


def fir_state_len(ntaps: int, nfft: Optional[int] = None, method: str = "ols") -> int:
    """Length of the streaming history ``zi``/``zf`` for fir_filter."""
    if method in ("direct", "im2col"):
        return ntaps - 1
    if method == "block2":
        return block2_block(ntaps)
    nfft = nfft or default_nfft(ntaps)
    return nfft - ols_hop(ntaps, nfft)


def fir_halo(ntaps: int) -> int:
    """Samples of left-neighbour history a time shard needs."""
    return ntaps - 1


# ---------------------------------------------------------------------------
# Filtering
# ---------------------------------------------------------------------------


def _ols_filter(xpad: torch.Tensor, taps: torch.Tensor, nfft: int,
                hist: int) -> torch.Tensor:
    """Overlap-save on ``(B, hist + T)`` pre-padded input → ``(B, T)``.

    ``hist = nfft − hop ≥ ntaps − 1`` history samples are already
    prepended, so each frame's first ``hist`` outputs are the circular
    wrap-around and are dropped.
    """
    hop = nfft - hist
    b, tp = xpad.shape
    t = tp - hist
    nframes = -(-t // hop)
    xp = F.pad(xpad, (0, hist + nframes * hop - tp))
    frames = xp.unfold(-1, nfft, hop)  # (B, nframes, nfft)
    spec = _tf.rfft(frames, nfft) * _tf.rfft(taps, nfft)
    y = _tf.irfft(spec, nfft)[:, :, hist:]
    return y.reshape(b, nframes * hop)[:, :t]


def _direct_filter(xpad: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Direct convolution on ``(B, ntaps − 1 + T)`` pre-padded input
    (``conv1d`` correlates, so the taps are flipped)."""
    return F.conv1d(xpad[:, None, :], taps.flip(0)[None, None, :])[:, 0, :]


def fir_filter(
    x: torch.Tensor,
    taps,
    *,
    method: str = "auto",
    nfft: Optional[int] = None,
    zi: Optional[torch.Tensor] = None,
    return_zf: bool = False,
):
    """Causal FIR filtering ``y[n] = Σ_k taps[k]·x[n-k]`` along the last axis.

    Args:
      x: ``(..., T)`` tensor (compute is f32; the output has x's dtype).
      taps: ``(ntaps,)`` host taps (numpy or a CPU tensor).
      method: "block2", "ols", "direct", or "auto" (= "block2").
      nfft: overlap-save FFT size; default ``default_nfft(ntaps)``.
      zi: optional ``(..., fir_state_len(ntaps, nfft, method))`` initial
        history (oldest first); zeros if omitted.  "block2" also takes a
        shorter history of ``ntaps − 1 … block`` samples and pads it on
        the left with zeros to a block (those samples meet no tap).
      return_zf: also return the final history (always the full state
        length).

    Precision of "block2" follows ``LLZ_MATMUL_PRECISION`` (default
    "highest"; "high" and "default" run the bf16x3 mode), as in the JAX
    package; "ols" and "direct" run f32.

    With "block2" a CUDA tensor runs kernel B2 and raises outside its
    envelope (channels a multiple of 8, ``ntaps − 1 ≤ 2048``); a CPU tensor
    runs the plain version.  On the card, streamed == one shot bitwise for
    splits at multiples of 8 samples at "high" (the tensor-core sum order
    depends on the output index mod 8 of a call), which covers every split
    at a multiple of the block; at "highest" for any split.
    """
    taps_host = np.asarray(
        taps.detach().cpu().numpy() if isinstance(taps, torch.Tensor)
        else taps, np.float64)
    ntaps = len(taps_host)
    if method == "auto":
        method = "block2"
    if method == "im2col":
        raise NotImplementedError(
            "fir_filter(method='im2col') is not ported yet (ROADMAP queue "
            "A, 'FIR alone'); use 'block2', 'ols' or 'direct'")
    if method not in ("block2", "ols", "direct"):
        raise ValueError(f"unknown method {method!r}")
    if nfft is None:
        nfft = default_nfft(ntaps)
    if nfft < 2 * ntaps:
        raise ValueError(f"nfft={nfft} too small for ntaps={ntaps}")
    hlen = fir_state_len(ntaps, nfft, method)
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).to(torch.float32)
    b = xb.shape[0]
    if zi is None:
        hist = torch.zeros((b, hlen), dtype=torch.float32, device=x.device)
    else:
        hist = zi.reshape(b, -1).to(torch.float32)
        short = hlen - hist.shape[-1]
        if method == "block2" and 0 < short <= hlen - (ntaps - 1):
            hist = F.pad(hist, (short, 0))
        elif short:
            raise ValueError(
                f"zi must hold {hlen} samples for method={method!r} "
                f"(block2 also takes {ntaps - 1}…{hlen}), got "
                f"{hist.shape[-1]}")
    xpad = torch.cat([hist, xb], dim=-1)
    if method == "block2":
        y = _bf.block2_fir(xpad, taps_host, hlen, mode=kernel_mode())
    else:
        taps_dev = torch.from_numpy(taps_host).to(torch.float32).to(x.device)
        y = (_ols_filter(xpad, taps_dev, nfft, hlen) if method == "ols"
             else _direct_filter(xpad, taps_dev))
    y = y.to(x.dtype).reshape(shape)
    if not return_zf:
        return y
    zf = xpad[:, -hlen:].to(x.dtype).reshape(shape[:-1] + (hlen,))
    return y, zf

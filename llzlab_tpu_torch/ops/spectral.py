"""STFT / iSTFT: framing, windowing, batched FFT, overlap-add synthesis
(port of ``llzlab_tpu/ops/spectral.py``).

Causal framing anchored at sample 0 (no centre padding), with a hop that
divides the frame length (75 % overlap: ratio 4), so streaming blocks at
hop multiples concatenate exactly.

* :func:`frame` is ``Tensor.unfold``, a view: no copy until a product or a
  window multiply reads it.
* :func:`overlap_add` is ``ratio`` shifted in-place adds of the frames'
  hop-chunks into hop-blocks, in the JAX package's order, so it is
  bitwise the JAX package's.
* :func:`stft` / :func:`istft` window the frames and run the port's FFT
  entry points (``ops/transform.py``: cuFFT on the card).
* The frame-free engines :func:`windowed_rdft` / :func:`windowed_irdft_ola`
  (the window folded into dense rDFT tables) and :func:`composed_wola`
  (analysis → static gain → synthesis composed into one ``(n_fft, n_fft)``
  matrix) are one ``torch.matmul`` each on the frame view.  None of these
  is a Pallas kernel in the JAX package (XLA einsums there), so plain
  matrix products are the port.  Their sum order differs from the JAX
  package's per-hop-chunk einsums, so they agree with it by SNR, not bit
  for bit.

Precision: every product here is fp32 with TF32 off at every precision
name (``runtime/platform.py``).  ``prec=`` is accepted for the JAX
package's signature and checked, and selects nothing: the JAX package's
``high`` is a bf16x3 einsum on the TPU, which no plain product here runs.

The host tables (``_wdft_tables``, ``_cwola_tables``) are the JAX
package's table functions, copied: float64 on the host, rounded to
float32 once, cached, so they are bit-equal to its tables.  Both assume an even
``n_fft`` (the Nyquist row, ``scale[-1]``); the JAX package builds them for
an odd size too and returns a wrong result, so here an odd size raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from llzlab_tpu_torch.ops import transform as _fft
from llzlab_tpu_torch.ops.window import get_window
from llzlab_tpu_torch.runtime.platform import matmul_precision_name
from llzlab_tpu_torch.runtime.profiler import span

__all__ = ["stft", "istft", "frame", "overlap_add", "stft_num_frames",
           "windowed_rdft", "windowed_irdft_ola", "composed_wola"]

_PRECISIONS = ("highest", "high", "default")


def stft_num_frames(t: int, n_fft: int, hop: int) -> int:
    if t < n_fft:
        return 0
    return 1 + (t - n_fft) // hop


def _check_hop(n_fft: int, hop: int) -> None:
    if n_fft % hop != 0:
        raise ValueError(f"hop ({hop}) must divide n_fft ({n_fft})")


def _check_shapes(t: int, n_fft: int, hop: int) -> None:
    _check_hop(n_fft, hop)
    if t < n_fft:
        raise ValueError(
            f"signal length {t} shorter than one frame ({n_fft})")


def _check_even(n_fft: int, what: str) -> None:
    if n_fft % 2:
        raise ValueError(
            f"{what} needs an even n_fft, got {n_fft}: its dense rDFT "
            "tables have a Nyquist bin (the JAX package builds them for an "
            "odd size too and returns a wrong result)")


def _check_prec(prec: Optional[str]) -> None:
    if prec is not None and prec.lower() not in _PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}; one of {_PRECISIONS}")


def frame(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Frame ``(..., T)`` → ``(..., nf, n_fft)``, a view; requires
    ``hop | n_fft`` and ``T ≥ n_fft``."""
    _check_shapes(x.shape[-1], n_fft, hop)
    return x.unfold(-1, n_fft, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``(..., nf, n_fft)`` → ``(..., n_fft + (nf-1)·hop)``.

    Each frame is cut into ``ratio`` hop-chunks; chunk k of frame i lands
    on hop-block i + k, so the output is ``ratio`` shifted adds, in the
    JAX package's order (k = 0 first)."""
    n_fft = frames.shape[-1]
    _check_hop(n_fft, hop)
    ratio = n_fft // hop
    nf = frames.shape[-2]
    lead = tuple(frames.shape[:-2])
    chunks = frames.reshape(lead + (nf, ratio, hop))
    nbh = nf - 1 + ratio
    with span("ops", "overlap_add"):
        acc = torch.zeros(lead + (nbh, hop), dtype=frames.dtype,
                          device=frames.device)
        for k in range(ratio):
            acc[..., k:k + nf, :] += chunks[..., :, k, :]
        return acc.reshape(lead + (nbh * hop,))


def _use_wdft(n_fft: int, window, method: str) -> bool:
    """The JAX package's rule: ``"auto"`` takes the frame-free engine on a
    TPU only, so here (never a TPU) the framed path; ``"wdft"`` takes it
    for a power-of-two ``n_fft ≥ 16`` and a named window."""
    if method == "wdft":
        _check_even(n_fft, "method='wdft'")
    return (method == "wdft" and n_fft >= 16
            and (n_fft & (n_fft - 1)) == 0 and isinstance(window, str))


def _fft_method(method: str) -> str:
    """The FFT method of the framed path: "wdft" names the frame-free
    engine, and where that does not apply the JAX package's FFT takes
    the library transform, as "auto" does here."""
    return "auto" if method == "wdft" else method


@functools.lru_cache(maxsize=32)
def _window_cached(window, n_fft: int, device: str) -> torch.Tensor:
    return torch.from_numpy(
        get_window(window, n_fft, periodic=True).astype(np.float32)
    ).to(device)


def window_tensor(window, n_fft: int, device) -> torch.Tensor:
    """The periodic window as f32 on ``device``, made once per device."""
    return _window_cached(window, n_fft, str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _wdft_tables(n_fft: int, hop: int, window: str, inverse: bool):
    """Window-folded dense rDFT tables (the JAX package's function: f64 on
    the host, rounded once).

    Forward: W[q][p, k] = w[q·hop+p] · e^{−2πi(q·hop+p)k/n}.
    Inverse: V[k][q, p] = scale_k · w[q·hop+p] · e^{+2πi(q·hop+p)k/n}
    with scale = [1, 2, …, 2, 1]/n (conjugate pair folded; imaginary rows
    at DC and Nyquist zeroed, the irfft convention).
    """
    w = get_window(window, n_fft, periodic=True).astype(np.float64)
    ratio = n_fft // hop
    j = np.arange(n_fft)
    k = np.arange(n_fft // 2 + 1)
    if not inverse:
        ang = -2.0 * np.pi * np.outer(j, k) / n_fft
        cr = (np.cos(ang) * w[:, None]).astype(np.float32)
        ci = (np.sin(ang) * w[:, None]).astype(np.float32)
        nb = n_fft // 2 + 1
        return (cr.reshape(ratio, hop, nb), ci.reshape(ratio, hop, nb))
    scale = np.full(n_fft // 2 + 1, 2.0 / n_fft)
    scale[0] = scale[-1] = 1.0 / n_fft
    ang = 2.0 * np.pi * np.outer(k, j) / n_fft
    vr = (np.cos(ang) * scale[:, None] * w[None, :]).astype(np.float32)
    vi = (-np.sin(ang) * scale[:, None] * w[None, :]).astype(np.float32)
    vi[0] = 0.0
    vi[-1] = 0.0
    nb = n_fft // 2 + 1
    return (vr.reshape(nb, ratio, hop), vi.reshape(nb, ratio, hop))


@functools.lru_cache(maxsize=16)
def _wdft_matrix(n_fft: int, hop: int, window: str, inverse: bool,
                 device: str) -> torch.Tensor:
    """The tables as one matrix on ``device``: forward ``[Cr | Ci]``
    ``(n, 2·nb)``, inverse ``[[Vr], [Vi]]`` ``(2·nb, n)``."""
    re, im = _wdft_tables(n_fft, hop, window, inverse)
    nb = n_fft // 2 + 1
    if inverse:
        m = np.concatenate([re.reshape(nb, n_fft), im.reshape(nb, n_fft)])
    else:
        m = np.concatenate([re.reshape(n_fft, nb), im.reshape(n_fft, nb)],
                           axis=1)
    return torch.from_numpy(m).to(device)


def windowed_rdft(x: torch.Tensor, n_fft: int, hop: int,
                  window: str = "hann",
                  prec: Optional[str] = None) -> torch.Tensor:
    """``rfft(frame(x)·w)`` as one product of the frame view with the
    window-folded rDFT table ``[Cr | Ci]``: complex64 ``(..., nf, nb)``."""
    _check_shapes(x.shape[-1], n_fft, hop)
    _check_even(n_fft, "windowed_rdft")
    _check_prec(prec)
    m = _wdft_matrix(n_fft, hop, window, False, str(x.device))
    out = frame(x.to(torch.float32), n_fft, hop) @ m
    nb = n_fft // 2 + 1
    return torch.complex(out[..., :nb], out[..., nb:])


def windowed_irdft_ola(spec: torch.Tensor, n_fft: int, hop: int,
                       window: str = "hann",
                       prec: Optional[str] = None) -> torch.Tensor:
    """``overlap_add(irfft(spec)·w, hop)`` with the synthesis window
    folded into the inverse table: one product of ``[re | im]`` with
    ``[[Vr], [Vi]]``, then the overlap-add (the envelope division is the
    caller's)."""
    _check_hop(n_fft, hop)
    _check_even(n_fft, "windowed_irdft_ola")
    _check_prec(prec)
    m = _wdft_matrix(n_fft, hop, window, True, str(spec.device))
    pair = torch.cat([spec.real.to(torch.float32),
                      spec.imag.to(torch.float32)], dim=-1)
    return overlap_add(pair @ m, hop)


@functools.lru_cache(maxsize=16)
def _cwola_tables(n_fft: int, hop: int, window: str,
                  gain_bytes: bytes) -> np.ndarray:
    """The whole ``diag(w)·DFT·diag(g)·iDFT·diag(w)`` frame map composed
    on the host in float64 into one real ``(n_fft, n_fft)`` matrix (the
    JAX package's function), returned as ``(ratio, hop, ratio, hop)``: for
    a static per-bin gain, one product a frame (n² MACs) instead of the
    wdft engine's two (2·2·n·(n/2+1))."""
    w = get_window(window, n_fft, periodic=True).astype(np.float64)
    g = np.frombuffer(gain_bytes, np.float64)
    nb = n_fft // 2 + 1
    if g.shape != (nb,):
        raise ValueError(f"gain must have {nb} bins, got {g.shape}")
    j = np.arange(n_fft)
    k = np.arange(nb)
    ang = -2.0 * np.pi * np.outer(j, k) / n_fft
    cr = np.cos(ang) * w[:, None]          # analysis re (n, nb)
    ci = np.sin(ang) * w[:, None]          # analysis im
    scale = np.full(nb, 2.0 / n_fft)
    scale[0] = scale[-1] = 1.0 / n_fft
    vr = np.cos(-ang.T) * scale[:, None] * w[None, :]   # (nb, n)
    vi = np.sin(ang.T) * scale[:, None] * w[None, :]
    vi[0] = 0.0
    vi[-1] = 0.0
    m = cr @ (g[:, None] * vr) + ci @ (g[:, None] * vi)
    ratio = n_fft // hop
    return (m.astype(np.float32)
            .reshape(ratio, hop, ratio, hop))


@functools.lru_cache(maxsize=16)
def _cwola_matrix(n_fft: int, hop: int, window: str, gain_bytes: bytes,
                  device: str) -> torch.Tensor:
    m = _cwola_tables(n_fft, hop, window, gain_bytes)
    return torch.from_numpy(m.reshape(n_fft, n_fft)).to(device)


def composed_wola(x: torch.Tensor, mask: torch.Tensor, n_fft: int,
                  hop: int, window: str, gain,
                  prec: Optional[str] = None) -> torch.Tensor:
    """WOLA ``overlap_add(istft_frame(gain · stft_frame(x)))`` for a
    static per-bin gain: the frame view times the composed matrix, each
    frame's result weighted by ``mask`` ``(nf,)`` (the stream-start
    masking commutes with the linear map), then the overlap-add.  Output
    ``(..., n_fft − hop + T)`` for ``T`` a multiple of the hop; the
    envelope division is the caller's."""
    _check_shapes(x.shape[-1], n_fft, hop)
    _check_even(n_fft, "composed_wola")
    _check_prec(prec)
    m = _cwola_matrix(n_fft, hop, window,
                      np.ascontiguousarray(gain, np.float64).tobytes(),
                      str(x.device))
    y = frame(x.to(torch.float32), n_fft, hop) @ m
    return overlap_add(y * mask.to(y.dtype)[:, None], hop)


def stft(
    x: torch.Tensor,
    *,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window="hann",
    method: str = "auto",
) -> torch.Tensor:
    """STFT along the last axis: ``(..., T)`` → complex ``(..., nf,
    n_fft//2+1)``.

    Causal framing anchored at sample 0; default 2048-point frames, 75 %
    overlap (hop 512), periodic Hann: config 4 (BASELINE.json:10).
    """
    hop = hop or n_fft // 4
    prec = matmul_precision_name()
    if _use_wdft(n_fft, window, method):
        return windowed_rdft(x.to(torch.float32), n_fft, hop, window,
                             prec=prec)
    w = window_tensor(window, n_fft, x.device)
    frames_ = frame(x.to(torch.float32), n_fft, hop) * w
    return _fft.rfft(frames_, n_fft, method=_fft_method(method))


def istft(
    spec: torch.Tensor,
    *,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window="hann",
    method: str = "auto",
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add and COLA envelope division.

    ``istft(stft(x))`` reconstructs x away from the first and last
    ``n_fft − hop`` samples, where the analysis window's taper is divided
    out by the envelope.
    """
    hop = hop or n_fft // 4
    prec = matmul_precision_name()
    w = window_tensor(window, n_fft, spec.device)
    if _use_wdft(n_fft, window, method):
        y = windowed_irdft_ola(spec, n_fft, hop, window, prec=prec)
    else:
        frames_ = _fft.irfft(spec, n_fft, method=_fft_method(method)) * w
        y = overlap_add(frames_, hop)
    nf = spec.shape[-2]
    # window-square envelope (the same overlap-add); the COLA constant in
    # the interior
    env = overlap_add((w * w).expand(nf, n_fft), hop)
    y = y / torch.clamp(env, min=1e-8)
    if length is not None:
        y = y[..., :length]
    return y

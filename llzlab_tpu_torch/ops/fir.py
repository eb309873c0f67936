"""FIR filter design and filtering (port of ``llzlab_tpu/ops/fir.py``).

Design (``firwin``, ``firwin2``, ``kaiser_beta``, ``kaiser_atten``,
``kaiserord``, ``firls``, ``minimum_phase``) is host-side float64 numpy,
the same code as the JAX package, so the taps are bit-equal.  Four
filtering engines:

* ``block2``: direct convolution over blocks of ``block2_block(ntaps)``
  samples, where every output block depends on its own input block and
  the one before it.  Inside kernel B2's envelope
  (``block2_fir.cuda_supports``: a block of at most 2048) a CUDA tensor
  runs B2 (``kernels/block2_fir.py``) and a CPU tensor that kernel's plain
  PyTorch version.  Any channel count is one launch on the rows as they
  are: the JAX package's fold of fewer than 8 channels into rows fills the
  TPU's 8-row matrix tile, and on the card it gave bitwise the same output
  more slowly (``PERF.md``), so it is not ported.  Outside the envelope
  (more than 2049 taps) both devices run the JAX package's two-product
  engine (``_block2_filter``) as tensor code, fp32, with the same block
  and history.
* ``ols``: overlap-save through ``torch.fft`` (``ops/transform.py``).
* ``direct``: one ``conv1d`` over the history-padded signal.
* ``im2col``: one dense product of slabs of ``256 + ntaps − 1`` inputs with
  the ``(256 + ntaps − 1, 256)`` Toeplitz matrix of the taps
  (``torch.matmul``, as the JAX package leaves it to XLA).

Streaming: ``fir_filter(concat(a, b))`` equals ``concat(ya, yb)`` with
``ya, zf = fir_filter(a, return_zf=True)`` and ``yb = fir_filter(b,
zi=zf)``, bit for bit for ``block2`` and ``ols`` when ``len(a)`` is a
multiple of the block (``block2_block``) or hop (``ols_hop``).  On the
CPU the plain versions run MKL, which splits a call over its threads by
the call's batch: there ols holds this on one thread, and block2 for
pieces of more than two rows (``tests/test_torch_fir_state.py``).  The
history length is ``fir_state_len(ntaps, nfft, method)``, for "auto" too.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.kernels import block2_fir as _bf
from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.ops.window import get_window
from llzlab_tpu_torch.runtime.platform import kernel_mode
from llzlab_tpu_torch.runtime.profiler import span

__all__ = [
    "firwin",
    "firwin2",
    "kaiser_beta",
    "kaiser_atten",
    "kaiserord",
    "firls",
    "minimum_phase",
    "fir_filter",
    "default_nfft",
    "ols_hop",
    "fir_state_len",
    "fir_halo",
    "block2_block",
    "resolve_method",
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


def firwin2(
    numtaps: int,
    freq,
    gain,
    *,
    nfreqs: Optional[int] = None,
    window="hamming",
    fs: float = 2.0,
) -> np.ndarray:
    """Frequency-sampling FIR design (scipy.signal.firwin2 semantics).

    ``freq`` (monotone, 0 … fs/2 with both endpoints present) and ``gain``
    define the desired magnitude; the linear-phase response is sampled on a
    fine grid, inverse-rFFT'd, truncated to ``numtaps`` and windowed.
    """
    freq = np.asarray(freq, np.float64) * 2.0 / fs
    gain = np.asarray(gain, np.float64)
    if freq[0] != 0.0 or freq[-1] != 1.0:
        raise ValueError("freq must start at 0 and end at fs/2")
    if np.any(np.diff(freq) < 0):
        raise ValueError("freq must be nondecreasing")
    if numtaps % 2 == 0 and gain[-1] != 0.0:
        raise ValueError("even numtaps needs zero gain at Nyquist (type II)")
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(max(numtaps, 2))))
    # Nudge duplicate interior frequencies apart (step responses).
    eps = np.finfo(np.float64).eps
    fq = freq.copy()
    for i in range(1, len(fq)):
        if fq[i] <= fq[i - 1]:
            fq[i] = fq[i - 1] + eps * (i + 1)
    x = np.linspace(0.0, 1.0, nfreqs)
    fx = np.interp(x, fq, gain)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * x)
    h_full = np.fft.irfft(fx * shift)
    h = h_full[:numtaps] * get_window(window, numtaps, periodic=False)
    return h


def kaiser_beta(a: float) -> float:
    """Kaiser window β for ``a`` dB of stopband attenuation."""
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a Kaiser-window FIR with the given transition
    ``width`` (Nyquist units)."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def kaiserord(ripple: float, width: float):
    """(numtaps, beta) meeting ``ripple`` dB over a ``width`` transition
    (scipy.signal.kaiserord semantics; width in Nyquist units)."""
    a = abs(ripple)
    if a < 8.0:
        raise ValueError("ripple attenuation too small for Kaiser (min 8 dB)")
    beta = kaiser_beta(a)
    numtaps = (a - 7.95) / (2.285 * np.pi * width) + 1
    return int(math.ceil(numtaps)), beta


def firls(numtaps: int, bands, desired, *, weight=None,
          fs: float = 2.0) -> np.ndarray:
    """Least-squares linear-phase FIR design (scipy.signal.firls semantics).

    Minimises the weighted integrated squared error between the type-I
    amplitude response and the piecewise-linear ``desired`` over ``bands``
    (band-edge pairs in Hz).  Host-side float64: the normal equations
    ``Q a = b`` use the closed-form cosine-product band integrals
    (Q = ½·(Toeplitz(q) + Hankel(q))), so no frequency grid is involved.

    ``numtaps`` must be odd (type I).  ``weight`` is one constant per band.
    """
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("numtaps must be odd and >= 1")
    m = (numtaps - 1) // 2
    bands = np.asarray(bands, np.float64).reshape(-1, 2) * (2.0 / fs)
    desired = np.asarray(desired, np.float64).reshape(-1, 2)
    if bands.shape[0] != desired.shape[0]:
        raise ValueError("desired must have one value per band edge")
    if weight is None:
        weight = np.ones(bands.shape[0])
    weight = np.asarray(weight, np.float64)

    # q[j] = sum_bands W \int cos(pi j f) df,  j = 0 .. 2m
    j = np.arange(2 * m + 1, dtype=np.float64)
    f0, f1 = bands[:, 0][:, None], bands[:, 1][:, None]
    # (bands, j): f*sinc(j f) = sin(pi j f)/(pi j), exact at j=0
    q = np.sum(weight[:, None]
               * (f1 * np.sinc(j * f1) - f0 * np.sinc(j * f0)), axis=0)

    # b[k] = sum_bands W \int D(f) cos(pi k f) df with D linear in f.
    # \int f cos(af) df = cos(af)/a^2 + f sin(af)/a  (a = pi k).
    k = np.arange(m + 1, dtype=np.float64)
    d0, d1 = desired[:, 0][:, None], desired[:, 1][:, None]
    slope = (d1 - d0) / np.where(f1 > f0, f1 - f0, 1.0)
    c0 = d0 - slope * f0  # D(f) = c0 + slope*f
    # constant part: c0 * (f sinc(k f)) |_{f0}^{f1}
    b = np.sum(weight[:, None] * c0
               * (f1 * np.sinc(k * f1) - f0 * np.sinc(k * f0)), axis=0)
    # linear part: slope * [cos(pi k f)/(pi k)^2 + f sin(pi k f)/(pi k)]
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.pi * k
        lin1 = (np.cos(a * f1) - np.cos(a * f0)) / (a * a)
        lin = lin1 + f1 * f1 * np.sinc(k * f1) - f0 * f0 * np.sinc(k * f0)
    # k = 0: \int f df = (f1^2 - f0^2)/2
    lin[:, 0] = (f1[:, 0] ** 2 - f0[:, 0] ** 2) / 2.0
    b += np.sum(weight[:, None] * slope * lin, axis=0)

    from scipy.linalg import hankel, toeplitz

    Q = 0.5 * (toeplitz(q[: m + 1]) + hankel(q[: m + 1], q[m:]))
    try:
        a_coef = np.linalg.solve(Q, b)
    except np.linalg.LinAlgError:
        a_coef = np.linalg.lstsq(Q, b, rcond=None)[0]
    h = np.concatenate([a_coef[:0:-1] / 2.0, [a_coef[0]], a_coef[1:] / 2.0])
    return h


def minimum_phase(h, *, n_fft: Optional[int] = None) -> np.ndarray:
    """Minimum-phase half-length filter from linear-phase ``h``
    (scipy.signal.minimum_phase homomorphic method).

    The log-magnitude cepstrum is folded onto the causal side and
    re-exponentiated, yielding ``(len(h)+1)//2`` taps whose magnitude is
    ``sqrt(|H|)`` — the standard route to minimum-phase FIRs for low-latency
    streaming chains.  Host-side float64.
    """
    h = np.asarray(h, np.float64)
    n = len(h)
    if n_fft is None:
        n_fft = 1 << int(math.ceil(math.log2(2 * (n - 1) / 0.01)))
    if n_fft < n:
        raise ValueError(f"n_fft must be >= len(h) == {n}")
    h_spec = np.abs(np.fft.fft(h, n_fft))
    h_spec += 1e-7 * h_spec[h_spec > 0].min()  # guard exact zeros
    cep = np.fft.ifft(np.log(h_spec)).real * 0.5  # sqrt in log domain
    win = np.zeros(n_fft)
    win[0] = 1.0
    stop = (n + 1) // 2
    win[1:stop] = 2.0
    if n % 2:
        win[stop] = 1.0
    h_min = np.fft.ifft(np.exp(np.fft.fft(cep * win))).real
    n_out = (n + 1) // 2
    return h_min[:n_out]


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
    """Length of the streaming history ``zi``/``zf`` for fir_filter;
    "auto" names the engine that :func:`resolve_method` resolves it to, as
    ``fir_filter(method="auto")`` does."""
    if method == "auto":
        method = resolve_method(method, ntaps)
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

METHODS = ("auto", "block2", "ols", "direct", "im2col")
SPECTRAL = ("auto", "fft", "fused")
#: the largest filter that "auto" sends to block2 (the JAX package's rule
#: on an accelerator; beyond it the ntaps products per sample lose to ols)
BLOCK2_AUTO_MAX_TAPS = 2048
#: outputs per im2col slab (the JAX package's)
IM2COL_BLOCK = 256


def resolve_method(method: str, ntaps: int) -> str:
    """The engine that ``method`` names at ``ntaps`` taps: "auto" is
    block2 up to ``BLOCK2_AUTO_MAX_TAPS`` taps, else ols, on every device
    (a CPU tensor runs the kernels' plain versions, so it follows the
    card's rule)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if method == "auto":
        return "block2" if ntaps <= BLOCK2_AUTO_MAX_TAPS else "ols"
    return method


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


def _block2_engine(taps: np.ndarray, block: int, mode: str):
    """Kernel B2 (its plain version on a CPU tensor) inside B2's envelope,
    else B2's plain version at "highest" on either device: the JAX
    package's two-product engine ``y_j = x_j @ A + x_{j−1} @ Bm`` in fp32
    with TF32 off.  The route is chosen from the shapes before any
    launch."""
    ntaps = len(taps)

    def run(xpad: torch.Tensor) -> torch.Tensor:
        if _bf.cuda_supports(xpad.shape[0], ntaps, block,
                             xpad.shape[-1] - block):
            return _bf.block2_fir(xpad, taps, block, mode=mode)
        return _bf.block2_fir_plain(xpad, taps, block, "highest")

    return run


def _direct_filter(xpad: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Direct convolution on ``(B, ntaps − 1 + T)`` pre-padded input
    (``conv1d`` correlates, so the taps are flipped)."""
    return F.conv1d(xpad[:, None, :], taps.flip(0)[None, None, :])[:, 0, :]


@functools.lru_cache(maxsize=16)
def _taps_cached(taps_bytes: bytes, device: str) -> torch.Tensor:
    """The f32 taps on ``device``, copied there once: a copy from host
    memory on every call would wait for the card each time."""
    return torch.from_numpy(np.frombuffer(taps_bytes, np.float64).astype(
        np.float32)).to(device)


@functools.lru_cache(maxsize=16)
def _toeplitz_cached(taps_bytes: bytes, block: int, device: str):
    taps = np.frombuffer(taps_bytes, np.float64)
    ntaps = len(taps)
    m = np.zeros((block + ntaps - 1, block), np.float32)
    for j in range(block):
        m[j:j + ntaps, j] = taps[::-1]
    return torch.from_numpy(m).to(device)


def _toeplitz_matrix(taps: np.ndarray, block: int, device="cpu"):
    """Dense ``(block + ntaps − 1, block)`` f32 Toeplitz matrix of the taps:
    column ``j`` holds the reversed taps from row ``j``."""
    return _toeplitz_cached(np.asarray(taps, np.float64).tobytes(), block,
                            str(device))


def _im2col_filter(xpad: torch.Tensor, tap_mat: torch.Tensor,
                   block: int) -> torch.Tensor:
    """Direct convolution as one dense Toeplitz product on ``(B, ntaps − 1
    + T)`` pre-padded input → ``(B, T)``: output block ``j`` is the slab
    ``xpad[j·block : j·block + slab]`` times ``tap_mat``."""
    slab = tap_mat.shape[0]
    b, tp = xpad.shape
    t = tp - (slab - block)
    nblk = -(-t // block)
    xp = F.pad(xpad, (0, max(0, (nblk - 1) * block + slab - tp)))
    slabs = xp.unfold(-1, slab, block)  # (B, nblk, slab)
    return (slabs @ tap_mat).reshape(b, nblk * block)[:, :t]


def _filter(x, zi, hlen: int, short_ok: int, return_zf: bool, engine):
    """Shared frame of the engines: ``x (..., T)`` as ``(B, T)`` f32 behind
    ``hlen`` samples of history (``zi``, zeros if None; a history of
    ``hlen − short_ok … hlen − 1`` samples is padded on the left with
    zeros, a longer one is taken by its last ``hlen`` samples: history is
    oldest first, and only its last ``ntaps − 1`` meet a tap),
    ``engine(xpad)`` → ``(B, T)``, and the final history."""
    shape = x.shape
    t = shape[-1]
    xb = x.reshape(-1, t).to(torch.float32)
    b = xb.shape[0]
    if zi is None:
        hist = torch.zeros((b, hlen), dtype=torch.float32, device=x.device)
    else:
        hist = zi.reshape(b, -1).to(torch.float32)
        short = hlen - hist.shape[-1]
        if short < 0:
            hist = hist[:, -hlen:]
        elif 0 < short <= short_ok:
            hist = F.pad(hist, (short, 0))
        elif short:
            raise ValueError(
                f"zi must hold {hlen} samples"
                + (f" (or {hlen - short_ok}…{hlen})" if short_ok else "")
                + f", got {hist.shape[-1]}")
    xpad = torch.cat([hist, xb], dim=-1)
    y = engine(xpad).to(x.dtype).reshape(shape)
    if not return_zf:
        return y
    zf = xpad[:, -hlen:].to(x.dtype).reshape(shape[:-1] + (hlen,))
    return y, zf


def fir_filter(
    x: torch.Tensor,
    taps,
    *,
    method: str = "auto",
    nfft: Optional[int] = None,
    zi: Optional[torch.Tensor] = None,
    return_zf: bool = False,
    spectral: str = "auto",
):
    """Causal FIR filtering ``y[n] = Σ_k taps[k]·x[n-k]`` along the last axis.

    Args:
      x: ``(..., T)`` tensor (compute is f32; the output has x's dtype).
      taps: ``(ntaps,)`` host taps (numpy or a CPU tensor).
      method: "block2", "ols", "direct", "im2col", or "auto" (block2 up to
        2048 taps, else ols: the JAX package's rule on an accelerator).
      nfft: overlap-save FFT size; default ``default_nfft(ntaps)``.
      zi: optional ``(..., fir_state_len(ntaps, nfft, method))`` initial
        history (oldest first); zeros if omitted.  A longer history is
        taken by its last ``fir_state_len`` samples.  "block2" also takes
        a shorter history of ``ntaps − 1 … block`` samples and pads it on
        the left with zeros to a block (those samples meet no tap).
      return_zf: also return the final history (always the full state
        length).
      spectral: the overlap-save engine, "auto" | "fft" | "fused".  All
        three run ``torch.fft``: the JAX package's "fused" engine
        (``ops/ols_matmul.py``) is a layout for the TPU's matrix unit and
        is not ported, so "fused" names the same computation here.

    Precision of "block2" follows ``LLZ_MATMUL_PRECISION`` (default
    "highest"; "high" and "default" run the bf16x3 mode), as in the JAX
    package; "ols", "direct" and "im2col" run f32.

    With "block2" a CUDA tensor runs kernel B2 once on all channels, a CPU
    tensor its plain version, up to 2049 taps and on any channel count.
    Streamed == one shot bitwise there for splits at multiples of 8
    samples at "high" (the tensor-core sum order depends on the output
    index mod 8 of a call), which covers every split at a multiple of the
    block; at "highest" for any split.  Beyond 2049 taps "block2" runs
    B2's plain version at fp32 ("highest") on either device, the JAX
    package's two-product engine; streamed equals one shot there to f32
    rounding, not bit for bit (the library product's sum order may follow
    the number of blocks).
    """
    with span("ops", "fir_filter"):
        taps_host = np.asarray(
            taps.detach().cpu().numpy() if isinstance(taps, torch.Tensor)
            else taps, np.float64)
        ntaps = len(taps_host)
        method = resolve_method(method, ntaps)
        if spectral not in SPECTRAL:
            raise ValueError(f"unknown spectral engine {spectral!r}; one of "
                             f"{SPECTRAL}")
        if nfft is None:
            nfft = default_nfft(ntaps)
        if nfft < 2 * ntaps:
            raise ValueError(f"nfft={nfft} too small for ntaps={ntaps}")
        hlen = fir_state_len(ntaps, nfft, method)
        if method == "block2":
            return _filter(x, zi, hlen, hlen - (ntaps - 1), return_zf,
                           _block2_engine(taps_host, hlen, kernel_mode()))
        if method == "im2col":
            tap_mat = _toeplitz_matrix(taps_host, IM2COL_BLOCK, x.device)
            return _filter(x, zi, hlen, 0, return_zf,
                           lambda xpad: _im2col_filter(xpad, tap_mat,
                                                       IM2COL_BLOCK))
        taps_dev = _taps_cached(taps_host.tobytes(), str(x.device))
        if method == "direct":
            return _filter(x, zi, hlen, 0, return_zf,
                           lambda xpad: _direct_filter(xpad, taps_dev))
        return _filter(x, zi, hlen, 0, return_zf,
                       lambda xpad: _ols_filter(xpad, taps_dev, nfft, hlen))

"""Kernel wola_gain: config 4's whole frame map (frames, window, a real FFT,
the per-bin gain, the inverse, overlap-add and the envelope) in one
launch, by hand for Hopper (``csrc/wola_gain.cu``).

Replaces no TPU kernel: the JAX package runs config 4's ``SpectralGainStage``
on ``lax`` / XLA FFTs and einsums, with no ``pallas_call``.  It was added
for config 4, where the ``reference`` engine on the card is some 30
elementwise launches and two cuFFT calls handing ~0.4 GB intermediates to
each other through device memory.  This kernel keeps every intermediate on
the chip: a step reads each input sample and writes each output sample
about once.  At 256 × 95 744 it is bound by operations (two real FFTs a
frame at fp32, 86.3 µs) before bytes (58.5 µs).

The arithmetic (``SpectralGainStage.apply``'s ``reference`` engine, the
FFT written out):

* a frame of ``N = n_fft`` samples, windowed, is packed as ``M = N / 2``
  complex points ``z[n] = x[2n]·w[2n] + i·x[2n+1]·w[2n+1]``;
* ``Z = DFT_M(z)`` by the Stockham passes of :func:`fft_plan`: pass ``p``
  of radix ``R`` over the span ``NS`` (the product of the radices before
  it) reads ``v[r] = a[j + r·M/R]``, multiplies ``v[r]`` for ``r ≥ 1`` by
  ``W_{R·NS}^{r·(j mod NS)}`` (its table) where ``NS > 1``, runs the
  ``R``-point DFT on ``v`` and writes ``v[r]`` to ``(j // NS)·NS·R + r·NS
  + j mod NS``; the ``R``-point DFT is ``log2 R`` radix-2 Stockham steps
  of the same form, whose twiddles ``W_R^m`` come from a 32-point table
  (``m = 0`` multiplies by nothing, ``4m = R`` by ``∓i`` exactly);
* the split step, for ``k = 0..M`` with ``Zk = Z[k mod M]``, ``Zp =
  Z[(M − k) mod M]``, ``t = e^{−2πik/N}``: ``A = Zk + conj Zp``, ``B = Zk −
  conj Zp``, ``C = B·t``, ``X = A − i·C``, then ``Y = (g/2)·X``;
* the inverse split, for ``k < M``: ``W = (Yk + conj Yp) + i·(Yk − conj
  Yp)·conj t``, and ``w = IDFT_M(W)`` by the same passes with conjugate
  twiddles, unnormalised: ``x[2n] + i·x[2n+1] = w[n] / N``;
* each synthesised sample is ``(w·(win/N))·mask``, the frame's start mask
  from ``pos``; the overlap-add of the signal and of the envelope
  ``(win·win)·mask``, the carried ``ola`` and ``env``, the division by
  ``clamp(env, 1e-8)`` and the tails are the stage's, operation for
  operation, so ``x_hist``, ``env`` and ``pos`` are bit for bit the
  composite path's and ``y`` and ``ola`` differ by the FFT's rounding.

Every product and sum is float32, each rounded alone (``__fmul_rn`` and
friends in the kernel, which nvcc does not contract into an FMA; one
tensor operation each in :func:`wola_gain_plain`), in one fixed order with
no atomics: the kernel is bit for bit its plain version and the same from
run to run.  The tables are float64 on the host, rounded once to float32
and copied to the card once (:func:`wola_tables`).

* :func:`supports` is the kernel's domain (the stage's dispatch).
* :func:`wola_gain_cuda` launches the kernel (``.launches`` counts each).
* :func:`wola_gain_plain` is the plain PyTorch version in the kernel's
  order from the same tables; :func:`fft_plain` its FFT alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.ops.window import get_window
from llzlab_tpu_torch.runtime.profiler import span

__all__ = ["MIN_N_FFT", "MAX_N_FFT", "MAX_RATIO", "ENV_FLOOR", "supports",
           "fft_plan", "WolaTables", "wola_tables", "frames_per_run",
           "wola_gain_cuda", "wola_gain_plain", "fft_plain"]

#: the kernel's sizes: power-of-two frames from MIN_N_FFT to MAX_N_FFT
#: points, at most MAX_RATIO frames over a sample
MIN_N_FFT, MAX_N_FFT, MAX_RATIO = 256, 4096, 8
#: the envelope's floor, the stage's
ENV_FLOOR = 1e-8
#: CTAs a launch aims for, a multiple of the card's SMs: two fit an SM at
#: config 4's widths, so one round of them; longer runs compute fewer
#: frames again (on an H100 at 256 × 95 744: 0.463 ms in runs of 187
#: frames, 0.473 of 94, 0.508 of 47, 0.546 of 24)
CTAS_PER_SM = 2


def supports(n_fft: int, hop: int, window) -> bool:
    """Whether the kernel runs this frame map: a named window, a power-of-
    two ``n_fft`` from :data:`MIN_N_FFT` to :data:`MAX_N_FFT`, ``hop |
    n_fft`` and ``n_fft / hop ≤`` :data:`MAX_RATIO`."""
    return (isinstance(window, str) and MIN_N_FFT <= n_fft <= MAX_N_FFT
            and n_fft & (n_fft - 1) == 0 and hop > 0 and n_fft % hop == 0
            and n_fft // hop <= MAX_RATIO)


def fft_plan(m: int) -> Tuple[int, ...]:
    """The radices of the ``m``-point complex FFT's Stockham passes: each
    as large as 32 and ``m / 32`` allow, so that every lane of a warp runs
    whole butterflies (``csrc/wola_gain.cu``, ``Plan``)."""
    cap = min(32, m // 32)
    plan, rem = [], m
    while rem > 1:
        r = min(cap, rem)
        plan.append(r)
        rem //= r
    return tuple(plan)


def _unit(num: np.ndarray, den: int) -> np.ndarray:
    """``e^{−2πi·num/den}`` in float64 as ``(..., 2)``, exact at the
    quarter turns."""
    a = np.mod(np.asarray(num, np.int64), den)
    ang = 2.0 * np.pi * a / den
    out = np.stack([np.cos(ang), -np.sin(ang)], -1)
    quarter = (4 * a) % den == 0
    exact = np.array([[1.0, 0.0], [0.0, -1.0], [-1.0, 0.0], [0.0, 1.0]])
    out[quarter] = exact[(4 * a[quarter]) // den]
    return out


class WolaTables(NamedTuple):
    """One frame map's float32 tables, on one device."""

    #: ``[pass twiddles (tw_len, 2) | split twiddles (M + 1, 2) | window
    #: (n_fft) | gain / 2 (M + 1)]`` float32 (``csrc/wola_gain.cu``)
    buf: torch.Tensor
    #: ``W_32^m``, ``m < 16``, as 32 float32 on the host (re, im): the
    #: in-register DFTs' twiddles, passed by value to the kernel
    w32: ctypes.Array
    n_fft: int
    hop: int
    #: float2 entries of the passes' twiddles
    tw_len: int


def _host_tables(gain, n_fft: int, window: str):
    m = n_fft // 2
    passes, ns = [], 1
    for r in fft_plan(m):
        if ns > 1:
            rr, jm = np.meshgrid(np.arange(1, r), np.arange(ns),
                                 indexing="ij")
            passes.append(_unit(rr * jm, r * ns).reshape(-1, 2))
        ns *= r
    tw = (np.concatenate(passes) if passes else np.zeros((0, 2)))
    tws = _unit(np.arange(m + 1), n_fft)
    win = get_window(window, n_fft, periodic=True).astype(np.float32)
    gh = np.asarray(gain, np.float32).reshape(-1) * np.float32(0.5)
    if gh.shape != (m + 1,):
        raise ValueError(f"gain must have {m + 1} bins, got {gh.shape}")
    buf = np.concatenate([tw.astype(np.float32).reshape(-1),
                          tws.astype(np.float32).reshape(-1), win,
                          gh.astype(np.float32)])
    w32 = _unit(np.arange(16), 32).astype(np.float32)
    return buf, w32, tw.shape[0]


def wola_tables(gain, n_fft: int, hop: int, window: str,
                device="cpu") -> WolaTables:
    """The tables of the frame map ``window`` → rFFT → ``gain`` (``n_fft //
    2 + 1`` bins) → irFFT → ``window`` at ``(n_fft, hop)``, built on the
    host and copied to ``device`` (the caller keeps them: the stage once a
    device)."""
    if not supports(n_fft, hop, window):
        raise ValueError(f"wola_gain runs power-of-two n_fft in "
                         f"[{MIN_N_FFT}, {MAX_N_FFT}] with hop | n_fft, "
                         f"n_fft / hop ≤ {MAX_RATIO} and a named window; "
                         f"got n_fft {n_fft}, hop {hop}, window {window!r}")
    buf, w32, tw_len = _host_tables(gain, n_fft, window)
    return WolaTables(torch.from_numpy(buf).to(device),
                      (ctypes.c_float * 32)(*w32.reshape(-1).tolist()),
                      n_fft, hop, tw_len)


def _parts(tables: WolaTables, device):
    """The tables' pieces as float32 tensors on ``device``: the passes'
    twiddles ``(tw_len, 2)``, the split twiddles ``(M + 1, 2)``, the window
    ``(n_fft,)``, the halved gain ``(M + 1,)`` and ``W_32`` ``(16, 2)``."""
    m = tables.n_fft // 2
    buf = tables.buf.to(device)
    a = 2 * tables.tw_len
    b = a + 2 * (m + 1)
    c = b + tables.n_fft
    return (buf[:a].reshape(-1, 2), buf[a:b].reshape(-1, 2), buf[b:c],
            buf[c:], torch.tensor(tables.w32[:], dtype=torch.float32,
                                  device=device).reshape(16, 2))


def frames_per_run(rows: int, nf: int, sms: int) -> int:
    """Frames a CTA emits: runs along a row so that ``rows × runs`` makes
    about :data:`CTAS_PER_SM` CTAs an SM, at least 8 frames a run (each
    run computes ``ratio − 1`` frames before its own again)."""
    runs = max(1, round(CTAS_PER_SM * sms / max(rows, 1)))
    return max(min(nf, 8), -(-nf // runs))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wola_gain_launch.argtypes = [p, ll, p, p, p, p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, p]
    lib.wola_gain_launch.restype = i


def _check(x, x_hist, ola, env, pos, tables: WolaTables) -> None:
    """Raise on what the kernel does not take: types and shapes first,
    then the device."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.stride(-1) != 1:
        raise ValueError(f"x must be a (rows, t) float32 tensor with rows "
                         f"contiguous, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}")
    rows, t = x.shape
    ov = tables.n_fft - tables.hop
    if rows == 0:
        raise ValueError("wola_gain_cuda needs at least one row")
    if t == 0 or t % tables.hop:
        raise ValueError(f"a block of {t} samples is not a positive "
                         f"multiple of the hop {tables.hop}")
    for name, v, want in (("x_hist", x_hist, (rows, ov)),
                          ("ola", ola, (rows, ov)), ("env", env, (ov,))):
        if (v.dtype != torch.float32 or tuple(v.shape) != want
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {want} float32 "
                             f"tensor, got {v.dtype} {tuple(v.shape)}")
    if pos.dtype != torch.int32 or pos.dim() != 0:
        raise ValueError(f"pos must be a 0-dim int32 tensor, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if not x.is_cuda:
        raise ValueError("wola_gain_cuda needs a CUDA tensor")
    devs = {v.device for v in (x_hist, ola, env, pos, tables.buf)}
    if devs != {x.device}:
        raise ValueError(f"x on {x.device}, its state and tables on "
                         f"{sorted(map(str, devs))}")


def wola_gain_cuda(x: torch.Tensor, x_hist: torch.Tensor, ola: torch.Tensor,
                   env: torch.Tensor, pos: torch.Tensor,
                   tables: WolaTables):
    """Launch the kernel on ``torch.cuda.current_stream()``: ``x (rows, t)``
    (rows may be strided) from the stage's state ``x_hist``, ``ola`` ``(rows,
    n_fft − hop)``, ``env`` ``(n_fft − hop,)`` and ``pos`` (0-dim int32) →
    ``(y, x_hist, ola, env, pos)``, the new state in fresh tensors.  One
    launch a call; ``pos`` is read on the card."""
    with span("kernels", "wola_gain"):
        _check(x, x_hist, ola, env, pos, tables)
        rows, t = x.shape
        ov = tables.n_fft - tables.hop
        f32 = dict(dtype=torch.float32, device=x.device)
        y = torch.empty((rows, t), **f32)
        xh_new = torch.empty((rows, ov), **f32)
        ola_new = torch.empty((rows, ov), **f32)
        env_new = torch.empty((ov,), **f32)
        pos_new = torch.empty((), dtype=torch.int32, device=x.device)
        lib = _build.load("wola_gain", _declare)
        fpr = frames_per_run(rows, t // tables.hop,
                             _sm_count(x.device.index))
        with torch.cuda.device(x.device):
            rc = lib.wola_gain_launch(
                x.data_ptr(), x.stride(0), x_hist.data_ptr(),
                ola.data_ptr(), env.data_ptr(), pos.data_ptr(),
                tables.buf.data_ptr(), ctypes.addressof(tables.w32),
                y.data_ptr(), xh_new.data_ptr(), ola_new.data_ptr(),
                env_new.data_ptr(), pos_new.data_ptr(), rows, t,
                tables.n_fft, tables.hop, fpr,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "wola_gain")
        wola_gain_cuda.launches += 1
        return y, xh_new, ola_new, env_new, pos_new


wola_gain_cuda.launches = 0


@functools.lru_cache(maxsize=8)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device()
    ).multi_processor_count


def _cmul(ar, ai, wr, wi):
    """``a·w``, each product and sum rounded alone."""
    return ar * wr - ai * wi, ar * wi + ai * wr


def _dft(re, im, w32, inverse: bool):
    """The ``R``-point DFT along dim 1 of ``(B, R, J)``: radix-2 Stockham
    steps, ``csrc/wola_gain.cu`` ``dft``."""
    b, r, j = re.shape
    h, ns = r // 2, 1
    while ns < r:
        ar, ai, br, bi = re[:, :h], im[:, :h], re[:, h:], im[:, h:]
        m = (np.arange(h) % ns) * (r // (2 * ns))
        if (m != 0).any():
            idx = torch.as_tensor(m * (32 // r), device=re.device)
            wr, wi = w32[idx, 0], w32[idx, 1]
            if inverse:
                wr, wi = wr, -wi
            cr, ci = _cmul(br, bi, wr[None, :, None], wi[None, :, None])
            qr, qi = (-bi, br) if inverse else (bi, -br)
            quarter = torch.as_tensor(4 * m == r, device=re.device)[
                None, :, None]
            none = torch.as_tensor(m == 0, device=re.device)[None, :, None]
            br, bi = (torch.where(none, br, torch.where(quarter, qr, cr)),
                      torch.where(none, bi, torch.where(quarter, qi, ci)))
        shape = (b, r // (2 * ns), ns, j)
        re = torch.stack([(ar + br).reshape(shape), (ar - br).reshape(shape)],
                         2).reshape(b, r, j)
        im = torch.stack([(ai + bi).reshape(shape), (ai - bi).reshape(shape)],
                         2).reshape(b, r, j)
        ns *= 2
    return re, im


def _fft(re, im, tw, w32, inverse: bool):
    """The ``M``-point complex FFT of ``(B, M)`` by :func:`fft_plan`'s
    passes (unnormalised; ``inverse``: conjugate twiddles)."""
    b, m = re.shape
    ns, off = 1, 0
    for r in fft_plan(m):
        j = m // r
        vr, vi = re.reshape(b, r, j), im.reshape(b, r, j)
        if ns > 1:
            jm = torch.arange(j, device=re.device) % ns
            t = tw[off:off + (r - 1) * ns].reshape(r - 1, ns, 2)[:, jm]
            wr, wi = t[..., 0], t[..., 1]
            if inverse:
                wi = -wi
            cr, ci = _cmul(vr[:, 1:], vi[:, 1:], wr, wi)
            vr = torch.cat([vr[:, :1], cr], 1)
            vi = torch.cat([vi[:, :1], ci], 1)
            off += (r - 1) * ns
        vr, vi = _dft(vr, vi, w32, inverse)
        shape = (b, r, j // ns, ns)
        re = vr.reshape(shape).permute(0, 2, 1, 3).reshape(b, m)
        im = vi.reshape(shape).permute(0, 2, 1, 3).reshape(b, m)
        ns *= r
    return re, im


def fft_plain(re: torch.Tensor, im: torch.Tensor, tables: WolaTables,
              inverse: bool = False):
    """The kernel's ``M``-point complex FFT (``M = n_fft / 2``) of float32
    ``(B, M)`` real and imaginary parts, in its order from its tables:
    ``Σ_n a[n]·e^{∓2πikn/M}``, unnormalised."""
    tw, _, _, _, w32 = _parts(tables, re.device)
    return _fft(re.to(torch.float32), im.to(torch.float32), tw, w32, inverse)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """``ops/spectral.overlap_add``'s sums: hop-block ``j`` is the frames'
    chunks ``k = 0, 1, …`` of frames ``j − k`` added in that order to
    zeros."""
    *lead, nf, n = frames.shape
    ratio = n // hop
    chunks = frames.reshape(*lead, nf, ratio, hop)
    acc = torch.zeros((*lead, nf - 1 + ratio, hop), dtype=frames.dtype,
                      device=frames.device)
    for k in range(ratio):
        acc[..., k:k + nf, :] += chunks[..., :, k, :]
    return acc.reshape(*lead, (nf - 1 + ratio) * hop)


def wola_gain_plain(x: torch.Tensor, x_hist: torch.Tensor,
                    ola: torch.Tensor, env: torch.Tensor, pos: torch.Tensor,
                    tables: WolaTables):
    """The kernel's arithmetic in plain PyTorch, float32, in its order, on
    any device: the same arguments and results as :func:`wola_gain_cuda`
    (``x (rows, t)``, the state's tensors on ``x``'s device)."""
    n, hop = tables.n_fft, tables.hop
    m, ov = n // 2, n - hop
    rows, t = x.shape
    dev = x.device
    tw, tws, win, gh, w32 = _parts(tables, dev)
    ext = torch.cat([x_hist.to(torch.float32), x.to(torch.float32)], -1)
    nf = t // hop
    fr = ext.unfold(-1, n, hop)
    zr = (fr[..., 0::2] * win[0::2]).reshape(rows * nf, m)
    zi = (fr[..., 1::2] * win[1::2]).reshape(rows * nf, m)
    zr, zi = _fft(zr, zi, tw, w32, False)
    # the split step: X[k] for k = 0..M, then Y = (g / 2)·X
    k = torch.arange(m + 1, device=dev)
    kr, kp = k % m, (m - k) % m
    ar, ai = zr[:, kr] + zr[:, kp], zi[:, kr] - zi[:, kp]
    br, bi = zr[:, kr] - zr[:, kp], zi[:, kr] + zi[:, kp]
    cr, ci = _cmul(br, bi, tws[:, 0], tws[:, 1])
    yr, yi = gh * (ar + ci), gh * (ai - cr)
    # the inverse split: W[k] for k < M from Y[k] and Y[M − k]
    kp = m - torch.arange(m, device=dev)
    ar, ai = yr[:, :m] + yr[:, kp], yi[:, :m] - yi[:, kp]
    br, bi = yr[:, :m] - yr[:, kp], yi[:, :m] + yi[:, kp]
    cr, ci = _cmul(br, bi, tws[:m, 0], -tws[:m, 1])
    wr, wi = _fft(ar - ci, ai + cr, tw, w32, True)
    ws = win * (1.0 / n)
    starts = torch.arange(nf, device=dev) * hop
    mask = (pos.to(dev) + starts >= ov).to(torch.float32)
    mk = mask.repeat(rows)[:, None]
    synth = torch.stack([(wr * ws[0::2]) * mk, (wi * ws[1::2]) * mk],
                        -1).reshape(rows, nf, n)
    buf = _overlap_add(synth, hop)
    envs = _overlap_add((win * win) * mask[:, None], hop)
    buf[..., :ov] += ola.to(torch.float32)
    envs[:ov] += env.to(torch.float32)
    y = buf[..., :t] / torch.clamp(envs[:t], min=ENV_FLOOR)
    return (y, ext[..., t:].clone(), buf[..., t:].clone(), envs[t:].clone(),
            torch.clamp(pos.to(dev) + t, max=ov).to(torch.int32))

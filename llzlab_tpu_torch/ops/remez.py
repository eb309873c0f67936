"""Parks–McClellan minimax FIR design (Remez exchange); port of
``llzlab_tpu/ops/remez.py``.

Numpy float64 only, the same code as the JAX package, kept here so that the
port never imports it; the taps are bit-equal.  Semantics follow
``scipy.signal.remez`` for linear-phase type I/II bandpass-mode filters.

Textbook algorithm:

1. Express the symmetric filter's zero-phase response as a degree-M cosine
   polynomial ``H(ω) = Σ a_k cos(kω)`` (type II filters factor out
   ``cos(ω/2)``, which re-weights the problem) — a polynomial ``P(x)`` in
   ``x = cos ω``.
2. Iterate the Remez exchange on a dense frequency grid: solve for the
   unique degree-M polynomial equioscillating on the current ``M+2``
   extremal candidates (closed form via barycentric weights), then move
   the candidates to the extrema of the weighted error.
3. Recover taps by sampling the converged response at the DFT frequencies
   and inverse-transforming.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["remez"]


def _build_grid(bands: np.ndarray, r: int, density: int):
    """Dense ω grid over the union of bands, edges included."""
    span = float(np.sum(bands[:, 1] - bands[:, 0]))
    npts = max(r * density, 64)
    grids = []
    band_of = []
    for i, (lo, hi) in enumerate(bands):
        n = max(int(round(npts * (hi - lo) / span)), 8)
        g = np.linspace(lo, hi, n)
        grids.append(g)
        band_of.append(np.full(n, i))
    return np.concatenate(grids), np.concatenate(band_of)


def _barycentric_weights(x: np.ndarray) -> np.ndarray:
    """w_k = 1/Π_{j≠k}(x_k − x_j) in log space (65+ nodes overflow the
    direct product), normalised to max |w| = 1."""
    n = len(x)
    scale = 4.0 / (np.max(x) - np.min(x) + 1e-300)
    logw = np.empty(n)
    sign = np.empty(n)
    for k in range(n):
        d = (x[k] - np.delete(x, k)) * scale
        sign[k] = np.prod(np.sign(d))
        logw[k] = -np.sum(np.log(np.abs(d) + 1e-300))
    logw -= np.max(logw)
    return sign * np.exp(logw)


def _remez_exchange(xg, D, W, r, maxiter, tol, band_of=None):
    """Core exchange on x = cos ω grid.  Returns (extremal values C,
    extremal nodes x_e, delta)."""
    ng = len(xg)
    if band_of is None:
        band_of = np.zeros(ng, int)
    same_prev = np.concatenate([[False], band_of[1:] == band_of[:-1]])
    same_next = np.concatenate([band_of[:-1] == band_of[1:], [False]])
    # Initial extremals: equally spaced grid indices.
    idx = np.linspace(0, ng - 1, r + 1).round().astype(int)
    idx = np.unique(idx)
    while len(idx) < r + 1:  # degenerate tiny grids
        cand = np.setdiff1d(np.arange(ng), idx)
        idx = np.sort(np.concatenate([idx, cand[: r + 1 - len(idx)]]))
    last_delta = 0.0
    for _ in range(maxiter):
        xe, De, We = xg[idx], D[idx], W[idx]
        w = _barycentric_weights(xe)
        signs = (-1.0) ** np.arange(len(idx))
        delta = np.sum(w * De) / np.sum(w * signs / We)
        C = De - signs * delta / We
        # Barycentric interpolation of P over the whole grid.
        with np.errstate(divide="ignore", invalid="ignore"):
            diff = xg[:, None] - xe[None, :]
            close = np.abs(diff) < 1e-14
            inv = np.where(close, 0.0, 1.0 / np.where(close, 1.0, diff))
            num = inv @ (w * C)
            den = inv @ w
            P = num / np.where(den == 0.0, 1.0, den)
            hit = close.any(axis=1)
            if hit.any():
                P[hit] = C[close[hit].argmax(axis=1)]
        E = W * (D - P)
        # New extremal candidates: local maxima of |E| *within each band*
        # (band edges compare only against their in-band neighbour — the
        # error is discontinuous across transition gaps, and edge extrema
        # are legitimate alternation points).
        aE = np.abs(E)
        ge_prev = np.empty(ng, bool)
        ge_next = np.empty(ng, bool)
        ge_prev[0] = True
        ge_prev[1:] = (aE[1:] >= aE[:-1]) | ~same_prev[1:]
        ge_next[-1] = True
        ge_next[:-1] = (aE[:-1] >= aE[1:]) | ~same_next[:-1]
        cand = np.flatnonzero(ge_prev & ge_next & (aE > 0))
        if len(cand) < r + 1:
            extra = np.argsort(-aE)
            cand = np.unique(np.concatenate([cand, extra[: 2 * (r + 1)]]))
        # Enforce sign alternation: among consecutive same-sign candidates
        # keep the largest |E|.
        cand = cand[np.argsort(cand)]
        keep = []
        for i in cand:
            if keep and np.sign(E[i]) == np.sign(E[keep[-1]]):
                if aE[i] > aE[keep[-1]]:
                    keep[-1] = i
            else:
                keep.append(i)
        # Trim to exactly r+1, dropping the smallest-error end of the
        # longer side (standard exchange heuristic).
        while len(keep) > r + 1:
            if len(keep) - (r + 1) >= 2:
                if aE[keep[0]] < aE[keep[-1]]:
                    keep.pop(0)
                else:
                    keep.pop()
            else:
                keep.pop(0 if aE[keep[0]] < aE[keep[-1]] else -1)
        if len(keep) < r + 1:
            filler = [i for i in np.argsort(-aE) if i not in keep]
            keep = sorted(keep + filler[: r + 1 - len(keep)])
        new_idx = np.asarray(sorted(keep))
        if np.array_equal(new_idx, idx) or (
            abs(delta) > 0
            and abs(abs(delta) - last_delta) <= tol * abs(delta)
            and np.max(aE) - abs(delta) <= 10 * tol * max(np.max(aE), 1e-30)
        ):
            idx = new_idx
            break
        last_delta = abs(delta)
        idx = new_idx
    xe, De, We = xg[idx], D[idx], W[idx]
    w = _barycentric_weights(xe)
    signs = (-1.0) ** np.arange(len(idx))
    delta = np.sum(w * De) / np.sum(w * signs / We)
    C = De - signs * delta / We
    return xe, C, w, delta


def _lawson_minimax(wgrid, D, W, M, iters: int = 120):
    """Minimax cosine-polynomial fit via Lawson's iteratively reweighted
    least squares — the numerically robust fallback when the barycentric
    exchange stalls (very high degree: the trial-set levelled error δ
    underflows f64 and the alternation signal is lost).

    Returns the coefficients a_k of Σ a_k cos(kω).
    """
    A = np.cos(np.outer(wgrid, np.arange(M + 1)))
    u = np.full(len(wgrid), 1.0 / len(wgrid))
    a = None
    for _ in range(iters):
        sw = W * np.sqrt(u)
        a, *_ = np.linalg.lstsq(A * sw[:, None], D * sw, rcond=None)
        e = np.abs(W * (D - A @ a))
        tot = np.sum(u * e)
        if tot <= 0:
            break
        u = u * e / tot
    return a


def _eval_bary(x, xe, C, w):
    with np.errstate(divide="ignore", invalid="ignore"):
        diff = x[:, None] - xe[None, :]
        close = np.abs(diff) < 1e-14
        inv = np.where(close, 0.0, 1.0 / np.where(close, 1.0, diff))
        num = inv @ (w * C)
        den = inv @ w
        P = num / np.where(den == 0.0, 1.0, den)
        hit = close.any(axis=1)
        if hit.any():
            P[hit] = C[close[hit].argmax(axis=1)]
    return P


def remez(
    numtaps: int,
    bands: Sequence[float],
    desired: Sequence[float],
    *,
    weight: Optional[Sequence[float]] = None,
    grid_density: int = 32,
    fs: float = 1.0,
    maxiter: int = 50,
) -> np.ndarray:
    """Minimax (equiripple) linear-phase FIR design.

    Args:
      numtaps: filter length (odd → type I; even → type II, needs zero
        desired response approaching fs/2).
      bands: 2·nbands monotone edges in the units of ``fs`` (scipy
        convention: ``fs`` defaults to 1, so edges live in [0, 0.5]).
      desired: one target amplitude per band.
      weight: one relative error weight per band (default all 1).
      grid_density: grid points per cosine coefficient (the default 32 is
        denser than scipy's 16 — the exchange's extremum localisation is
        grid-limited, and the denser grid reliably reaches the minimax
        solution for long filters).
      maxiter: exchange iteration cap.

    Returns float64 taps; matches ``scipy.signal.remez`` responses on
    well-posed problems.
    """
    bands = np.asarray(bands, np.float64).reshape(-1, 2) / fs  # → [0, 0.5]
    desired = np.asarray(desired, np.float64)
    if bands.shape[0] != len(desired):
        raise ValueError("one desired value per band required")
    if weight is None:
        weight = np.ones(len(desired))
    weight = np.asarray(weight, np.float64)
    if np.any(np.diff(bands.ravel()) < 0) or bands[0, 0] < 0 or bands[-1, 1] > 0.5:
        raise ValueError("band edges must be monotone within [0, fs/2]")

    type2 = numtaps % 2 == 0
    if type2 and desired[-1] != 0 and bands[-1, 1] >= 0.5 - 1e-9:
        # A type II filter has a forced zero at fs/2; approximating a
        # nonzero target right up to Nyquist is ill-posed (scipy silently
        # returns a response sagging to 0 there — we reject instead).
        raise ValueError(
            "even numtaps force a zero at fs/2; use odd numtaps for a "
            "band with nonzero desired response touching fs/2"
        )
    M = (numtaps - 1) // 2 if not type2 else numtaps // 2 - 1
    r = M + 1  # cosine coefficients

    wgrid, band_of = _build_grid(2.0 * np.pi * bands, r, grid_density)
    D = desired[band_of].astype(np.float64).copy()
    W = weight[band_of].astype(np.float64).copy()
    if type2:
        # H(ω) = cos(ω/2)·Ĥ(ω): fold the factor into D and W.  The forced
        # zero at fs/2 makes points within ~1e-4 of π unusable — drop them
        # (a nonzero desired value there is unreachable for type II, same
        # behaviour as scipy).
        c = np.cos(wgrid / 2.0)
        ok = np.abs(c) > 1e-4
        wgrid, band_of, D, W, c = (
            wgrid[ok], band_of[ok], D[ok], W[ok], c[ok]
        )
        D = D / c
        W = W * np.abs(c)
    xg = np.cos(wgrid)
    # The exchange works on a monotone x grid (cos reverses order).
    order = np.argsort(xg)
    xg_s, D_s, W_s = xg[order], D[order], W[order]
    # Deduplicate equal x (band edges can collide after cos).
    band_s = band_of[order]
    keep = np.concatenate([[True], np.diff(xg_s) > 1e-15])
    xe, C, wts, delta = _remez_exchange(
        xg_s[keep], D_s[keep], W_s[keep], r, maxiter, 1e-12, band_s[keep]
    )

    wk = 2.0 * np.pi * np.arange(numtaps) / numtaps
    # Accept the exchange only if it truly equioscillates; at very high
    # degree the trial-set levelled error underflows f64 and the exchange
    # stalls — fall back to Lawson IRLS (same minimax problem, solved by
    # reweighted least squares).
    P = _eval_bary(xg_s[keep], xe, C, wts)
    maxe = float(np.max(np.abs(W_s[keep] * (D_s[keep] - P))))
    if not np.isfinite(maxe) or maxe > 3.0 * abs(delta) + 1e-12:
        a = _lawson_minimax(wgrid, D, W, M)
        Hk = np.cos(np.outer(wk, np.arange(M + 1))) @ a
    else:
        # Sample the converged barycentric interpolant at DFT frequencies.
        Hk = _eval_bary(np.cos(wk), xe, C, wts)
    if type2:
        Hk = Hk * np.cos(wk / 2.0)
    # Linear phase: H_full(ω) = Hk·e^{−jω(numtaps−1)/2}; inverse DFT.
    phase = np.exp(-1j * wk * (numtaps - 1) / 2.0)
    h = np.fft.ifft(Hk * phase)
    return np.real(h)

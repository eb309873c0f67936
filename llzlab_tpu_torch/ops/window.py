"""Window functions (host-side tap/window generation, f64 internally).

Port of ``llzlab_tpu/ops/window.py``: numpy float64 only, so it is the
same code, kept here so that the port never imports the JAX package.
Windows are generated in float64 on host and cast at use sites so that
tap rounding stays below the -80 dB SNR budget.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "get_window", "hann", "hamming", "blackman", "kaiser", "rect",
    "bartlett", "triang", "blackmanharris", "nuttall", "flattop",
    "tukey", "gaussian", "general_cosine", "general_hamming", "bohman",
    "cosine", "exponential", "parzen", "barthann", "chebwin", "lanczos",
    "taylor",
]


def rect(n: int) -> np.ndarray:
    return np.ones(n, dtype=np.float64)


def hann(n: int, periodic: bool = False) -> np.ndarray:
    """Hann window.  ``periodic=True`` gives the DFT-even variant used for
    STFT framing (COLA at 75% overlap); ``False`` gives the symmetric
    filter-design variant."""
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)


def hamming(n: int, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / denom)


def blackman(n: int, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    w = 2.0 * np.pi * k / denom
    return 0.42 - 0.5 * np.cos(w) + 0.08 * np.cos(2.0 * w)


def kaiser(n: int, beta: float, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    arg = beta * np.sqrt(np.clip(1.0 - (2.0 * k / denom - 1.0) ** 2, 0.0, None))
    return np.i0(arg) / np.i0(beta)


def general_cosine(n: int, a, periodic: bool = False) -> np.ndarray:
    """Generic weighted-cosine-sum window ``sum_k a[k] cos(k w)``.

    The base form behind blackmanharris/nuttall/flattop (scipy
    ``windows.general_cosine`` semantics; symmetric unless ``periodic``).
    """
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    w = np.linspace(-np.pi, np.pi, denom + 1)[:n]
    out = np.zeros(n, dtype=np.float64)
    for k, ak in enumerate(np.asarray(a, dtype=np.float64)):
        out += ak * np.cos(k * w)
    return out


def general_hamming(n: int, alpha: float, periodic: bool = False) -> np.ndarray:
    return general_cosine(n, [alpha, 1.0 - alpha], periodic)


def blackmanharris(n: int, periodic: bool = False) -> np.ndarray:
    return general_cosine(n, [0.35875, 0.48829, 0.14128, 0.01168], periodic)


def nuttall(n: int, periodic: bool = False) -> np.ndarray:
    return general_cosine(
        n, [0.3635819, 0.4891775, 0.1365995, 0.0106411], periodic)


def flattop(n: int, periodic: bool = False) -> np.ndarray:
    a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    return general_cosine(n, a, periodic)


def bartlett(n: int, periodic: bool = False) -> np.ndarray:
    """Triangular window with zero endpoints (scipy ``bartlett``)."""
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return 1.0 - np.abs(2.0 * k / denom - 1.0)


def triang(n: int, periodic: bool = False) -> np.ndarray:
    """Triangular window with non-zero endpoints (scipy ``triang``)."""
    m = n + 1 if periodic else n
    k = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        w = (2.0 * k - 1.0) / m
        w = np.concatenate([w, w[::-1]])
    else:
        w = 2.0 * k / (m + 1.0)
        w = np.concatenate([w, w[-2::-1]])
    return w[:n]


def tukey(n: int, alpha: float = 0.5, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    if alpha <= 0:
        return np.ones(n)
    if alpha >= 1:
        return hann(n, periodic)
    m = n + 1 if periodic else n
    k = np.arange(m, dtype=np.float64)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    w = np.ones(m)
    left = k[: width + 1]
    w[: width + 1] = 0.5 * (
        1 + np.cos(np.pi * (-1 + 2.0 * left / alpha / (m - 1))))
    right = k[m - width - 1:]
    w[m - width - 1:] = 0.5 * (
        1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * right / alpha / (m - 1))))
    return w[:n]


def gaussian(n: int, std: float, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    m = n + 1 if periodic else n
    k = np.arange(m, dtype=np.float64) - (m - 1) / 2.0
    return np.exp(-0.5 * (k / std) ** 2)[:n]


def bohman(n: int, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    m = n + 1 if periodic else n
    fac = np.abs(np.linspace(-1, 1, m)[1:-1])
    w = (1 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
    w = np.concatenate([[0.0], w, [0.0]])
    return w[:n]


def cosine(n: int, periodic: bool = False) -> np.ndarray:
    m = n + 1 if periodic else n
    return np.sin(np.pi / m * (np.arange(m) + 0.5))[:n]


def exponential(n: int, center=None, tau: float = 1.0,
                periodic: bool = False) -> np.ndarray:
    """Exponential (Poisson) window.  ``center=None`` → symmetric peak.

    Matches ``scipy.signal.windows.exponential``: an explicit ``center``
    is used as-is (also with ``periodic=True``, where scipy computes on
    the extended grid and truncates).
    """
    m = n + 1 if periodic else n
    if center is None:
        center = (m - 1) / 2.0
    k = np.arange(m, dtype=np.float64)
    return np.exp(-np.abs(k - center) / tau)[:n]


def parzen(n: int, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    m = n + 1 if periodic else n
    k = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
    na = np.extract(k < -(m - 1) / 4.0, k)
    nb = np.extract(np.abs(k) <= (m - 1) / 4.0, k)
    wa = 2 * (1 - np.abs(na) / (m / 2.0)) ** 3
    wb = (1 - 6 * (np.abs(nb) / (m / 2.0)) ** 2
          * (1 - np.abs(nb) / (m / 2.0)))
    w = np.concatenate([wa, wb, wa[::-1]])
    return w[:n]


def barthann(n: int, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    m = n + 1 if periodic else n
    fac = np.abs(np.arange(m, dtype=np.float64) / (m - 1) - 0.5)
    return (0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac))[:n]


def chebwin(n: int, at: float = 100.0, periodic: bool = False) -> np.ndarray:
    """Dolph-Chebyshev window with ``at`` dB equiripple sidelobes.

    Closed form: sample the degree-(M-1) Chebyshev polynomial on the unit
    circle and inverse-DFT (scipy ``chebwin`` semantics, peak-normalised).
    """
    if n == 1:
        return np.ones(1)
    m = n + 1 if periodic else n
    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (np.abs(at) / 20.0)))
    k = np.arange(m, dtype=np.float64)
    x = beta * np.cos(np.pi * k / m)
    # Chebyshev T_order(x) for |x|>1 via cosh branch, |x|<=1 via cos branch
    p = np.zeros_like(x)
    big = x > 1
    small = np.abs(x) <= 1
    neg = x < -1
    p[big] = np.cosh(order * np.arccosh(x[big]))
    p[small] = np.cos(order * np.arccos(x[small]))
    p[neg] = (2 * (m % 2) - 1) * np.cosh(order * np.arccosh(-x[neg]))
    if m % 2:
        w = np.real(np.fft.fft(p))
        half = (m + 1) // 2
        w = w[:half]
        w = np.concatenate([w[half - 1:0:-1], w])
    else:
        p = p * np.exp(1.0j * np.pi / m * np.arange(m))
        w = np.real(np.fft.fft(p))
        half = m // 2 + 1
        w = w[1:half]
        w = np.concatenate([w[half - 2::-1], w])
    w = w / np.max(w)
    return w[:n]


def lanczos(n: int, periodic: bool = False) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    m = n + 1 if periodic else n
    k = np.arange(m, dtype=np.float64)
    return np.sinc(2.0 * k / (m - 1) - 1.0)[:n]


def taylor(n: int, nbar: int = 4, sll: float = 30.0, norm: bool = True,
           periodic: bool = False) -> np.ndarray:
    """Taylor window (scipy ``windows.taylor`` semantics): near-Chebyshev
    mainlobe with ``nbar`` nearly-constant-level sidelobes at ``-sll`` dB."""
    if n == 1:
        return np.ones(1)
    m = n + 1 if periodic else n
    b = 10 ** (sll / 20.0)
    a = np.arccosh(b) / np.pi
    s2 = nbar ** 2 / (a ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar, dtype=np.float64)
    fm = np.zeros(nbar - 1)
    signs = np.empty_like(ma)
    signs[::2] = 1
    signs[1::2] = -1
    m2 = ma ** 2
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / s2 / (a ** 2 + (ma - 0.5) ** 2))
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(
            1 - m2[mi] / m2[mi + 1:])
        fm[mi] = numer / denom

    def _w(x):
        return 1 + 2 * np.dot(
            fm, np.cos(2 * np.pi * ma[:, None] * (x - m / 2.0 + 0.5) / m))

    w = _w(np.arange(m, dtype=np.float64))
    if norm:
        w /= _w((m - 1) / 2.0)
    return w[:n]


_WINDOWS = {
    "rect": lambda n, periodic=False: rect(n),
    "boxcar": lambda n, periodic=False: rect(n),
    "hann": hann,
    "hanning": hann,
    "hamming": hamming,
    "blackman": blackman,
    "bartlett": bartlett,
    "triang": triang,
    "blackmanharris": blackmanharris,
    "nuttall": nuttall,
    "flattop": flattop,
    "bohman": bohman,
    "cosine": cosine,
    "parzen": parzen,
    "barthann": barthann,
    "lanczos": lanczos,
    "tukey": tukey,
    "exponential": exponential,
    "taylor": taylor,
}

_PARAM_WINDOWS = {
    "kaiser": kaiser,
    "gaussian": gaussian,
    "tukey": tukey,
    # scipy passes tuple params positionally: ("exponential", center, tau).
    # A lone parameter is therefore the CENTER (scipy 1.17 semantics), not
    # tau — use ("exponential", None, tau) for a symmetric Poisson window.
    "exponential": exponential,
    "chebwin": chebwin,
    "general_cosine": general_cosine,
    "general_hamming": general_hamming,
}


def get_window(window, n: int, periodic: bool = False) -> np.ndarray:
    """Resolve a window spec to an ``(n,)`` float64 array.

    ``window`` may be a name (``"hann"``, ``"blackmanharris"``,
    ``"flattop"``, ...), a parameterised tuple (``("kaiser", beta)``,
    ``("gaussian", std)``, ``("tukey", alpha)``, ``("chebwin", at_dB)``,
    ``("exponential", center, tau)``), or an array of length ``n``.
    """
    if isinstance(window, str):
        try:
            return _WINDOWS[window.lower()](n, periodic=periodic)
        except KeyError:
            raise ValueError(f"unknown window {window!r}") from None
    if isinstance(window, tuple):
        name, *params = window
        fn = _PARAM_WINDOWS.get(name.lower())
        if fn is None:
            raise ValueError(f"unknown window {window!r}")
        if name.lower() == "general_cosine":
            return fn(n, params[0], periodic=periodic)
        return fn(n, *[None if p is None else float(p) for p in params],
                  periodic=periodic)
    arr = np.asarray(window, dtype=np.float64)
    if arr.shape != (n,):
        raise ValueError(f"window array has shape {arr.shape}, expected ({n},)")
    return arr

"""IIR engine selection with SNR guardrails, calibrated per card (port of
``llzlab_tpu/ops/iir_select.py``).

Two engines with different contracts: the blockwise scan
(:func:`llzlab_tpu_torch.ops.iir.sosfilt`, bit-matched streaming splits)
and the matrix-product engine
(:func:`llzlab_tpu_torch.ops.iir_matmul.sosfilt_matmul`, splits equal to
rounding).  Callers state the SNR they need and whether streaming splits
must be bit-exact; this module picks the engine.

Engine data is measured on the card, not assumed:
``scripts/calibrate_iir_torch.py`` writes a per-card artifact to
``llzlab_tpu_torch/calib/<card>.json`` (the card's name from
``torch.cuda.get_device_name``), and :func:`load_engine_matrix` reads the
artifact of the card the signal is on, with selection floors of
``measured SNR − SNR_MARGIN_DB``.  On a card with no artifact the
fallback matrix applies: the JAX package's SNR floors, and a rank order in
place of rates, since no rate measured on another device applies here.
A CPU tensor always takes the scan engine.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional, Tuple

import torch

from llzlab_tpu_torch.ops.iir import sosfilt
from llzlab_tpu_torch.ops.iir_matmul import sosfilt_matmul

__all__ = ["sosfilt_auto", "select_engine", "load_engine_matrix",
           "calib_path", "SNR_MARGIN_DB"]

#: selection floors sit this far under the measured benchmark-EQ SNR
SNR_MARGIN_DB = 10.0

# (engine, precision) -> (rank, guaranteed SNR floor dB) for a card with
# no calibration artifact.  The first entry only orders the candidates
# (higher is tried first; no rate is known); the floors are the JAX
# package's, the load-bearing part.
_FALLBACK: Dict[Tuple[str, str], Tuple[float, float]] = {
    ("matmul", "high"): (3.0, 75.0),
    ("matmul", "highest"): (2.0, 125.0),
    ("scan", "f32"): (1.0, 125.0),
}


def _kind_slug(device_kind: str) -> str:
    return device_kind.lower().replace(" ", "-").replace("/", "-")


def calib_path(device_kind: str) -> str:
    """Artifact path for a card's name (env ``LLZ_CALIB_DIR`` overrides
    the packaged ``llzlab_tpu_torch/calib/`` directory)."""
    d = os.environ.get("LLZ_CALIB_DIR")
    if d is None:
        d = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "calib")
    return os.path.join(d, _kind_slug(device_kind) + ".json")


@functools.lru_cache(maxsize=8)
def load_engine_matrix(
    device_kind: str,
) -> Dict[Tuple[str, str], Tuple[float, float]]:
    """Engine matrix for a card: ``(engine, precision) → (msps,
    floor_db)`` with floors = measured − :data:`SNR_MARGIN_DB`; the
    fallback matrix (ranks, not rates) when the card has no artifact."""
    path = calib_path(device_kind)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return dict(_FALLBACK)
    out = {}
    for row in data.get("measured", []):
        key = (row["engine"], row["precision"])
        out[key] = (float(row["msps"]),
                    float(row["snr"]) - SNR_MARGIN_DB)
    return out if out else dict(_FALLBACK)


def select_engine(device, *, min_snr_db: float = 80.0,
                  bit_exact_carry: bool = False) -> Tuple[str, str]:
    """The ``(engine, precision)`` :func:`sosfilt_auto` runs for a signal
    on ``device``: the scan engine for ``bit_exact_carry`` or a CPU device,
    else the fastest entry of the card's matrix whose floor meets
    ``min_snr_db``.  Raises ValueError if none does."""
    device = torch.device(device)
    if bit_exact_carry:
        return "scan", "f32"
    if device.type != "cuda":
        # the matrix engine's products buy nothing on a CPU
        matrix = {("scan", "f32"): (1.0, _FALLBACK[("scan", "f32")][1])}
    else:
        matrix = load_engine_matrix(torch.cuda.get_device_name(device))
    max_floor = max(v[1] for v in matrix.values())
    if min_snr_db > max_floor:
        raise ValueError(
            f"min_snr_db={min_snr_db} exceeds every engine's calibrated "
            f"floor for this device (max {max_floor:.1f} dB); use "
            "float64 offline processing for higher accuracy"
        )
    candidates = sorted(matrix.items(), key=lambda kv: -kv[1][0])
    return next(key for key, (_rate, floor) in candidates
                if floor >= min_snr_db)


def sosfilt_auto(
    sos,
    x: torch.Tensor,
    *,
    min_snr_db: float = 80.0,
    bit_exact_carry: bool = False,
    zi: Optional[torch.Tensor] = None,
    return_zf: bool = False,
    block_size: Optional[int] = None,
):
    """Cascaded biquad filtering, engine picked from the caller's needs.

    Args:
      sos: ``(ns, 6)`` second-order sections (``a0 == 1``), host array.
      x: ``(..., T)`` tensor; the engine runs on its device.
      min_snr_db: required output SNR vs the exact (float64 serial)
        response.  The fastest engine whose calibrated floor (see module
        docstring) meets it is chosen; raises ValueError if nothing can.
      bit_exact_carry: require BASELINE.json:9 bit-matched streaming
        state — splitting the stream at any block boundary and carrying
        ``zf`` must reproduce the unsplit output bit-for-bit.  Only the
        scan engine guarantees this; implies it regardless of speed.
      zi / return_zf / block_size: as in :func:`sosfilt` (states
        interchange between engines — same ``(..., ns, 2)`` realization
        convention).

    Returns ``y`` or ``(y, zf)``.
    """
    engine, prec = select_engine(x.device, min_snr_db=min_snr_db,
                                 bit_exact_carry=bit_exact_carry)
    kw = {} if block_size is None else {"block_size": block_size}
    if engine == "matmul":
        return sosfilt_matmul(sos, x, zi=zi, return_zf=return_zf,
                              precision=prec, **kw)
    return sosfilt(sos, x, zi=zi, return_zf=return_zf, **kw)

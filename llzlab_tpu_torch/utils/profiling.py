"""Stage timers, trace capture and a roofline report (port of
``llzlab_tpu/utils/profiling.py``).

* :class:`StageTimer` accumulates wall-clock time per named stage, waiting
  for the card where the JAX package calls ``block_until_ready``: a CUDA
  tensor (or a tuple, list or dict holding one) synchronises its device.
* :func:`trace` records ``torch.profiler`` activity (the card's kernels
  too, where there is a card) into a Chrome trace under ``logdir``.
* :func:`roofline_report` sets achieved bytes/s and FLOP/s beside the
  peaks of :data:`CHIP_PEAKS`, keyed by ``torch.cuda.get_device_name()``.

* :func:`collective_traffic` counts the bytes that a call moves between
  ranks, per kind.  The JAX function parses XLA's compiled HLO, which the
  port has no counterpart of; here every exchange of ``parallel/`` and of
  kernels B3 / B4 notes its bytes as it is queued
  (``parallel.mesh.note_traffic``), in the JAX package's kinds and count.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

__all__ = ["StageTimer", "trace", "CHIP_PEAKS", "roofline_report",
           "collective_traffic"]

#: Peaks per device name: dense bf16 matrix TFLOP/s and memory GB/s.  The
#: H100 SXM's published figures (fp32 outside the tensor cores: 67
#: TFLOP/s); "cpu" is a nominal row for CPU runs.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tflops_bf16": 989.0, "hbm_gbps": 3350.0},
    "cpu": {"tflops_bf16": 1.0, "hbm_gbps": 50.0},
}


def _synchronize(out) -> None:
    """Wait for the devices of the CUDA tensors in ``out``."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _synchronize(v)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)


@dataclass
class StageTimer:
    """Accumulating per-stage wall timers (device-synchronised)."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _synchronize(sync_on)
            self._add(name, time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _synchronize(out)
        self._add(name, time.perf_counter() - t0)
        return out

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[k]
            lines.append(
                f"{k:30s} {self.totals[k]*1e3:9.2f} ms total  "
                f"{self.totals[k]/n*1e3:8.2f} ms/call  x{n}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Record ``torch.profiler`` activity of the enclosed calls (CPU, and
    CUDA where a card is visible) and write it as a Chrome trace,
    ``logdir/trace.json``, viewable in Perfetto or ``chrome://tracing``.
    The program's spans (``runtime.profiler.span``) are in it beside the
    card's work, with the operators' input shapes and each request's
    call number (``record_shapes``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def collective_traffic(fn, *args, **kw) -> Dict[str, object]:
    """Bytes that ``fn(*args, **kw)`` moves between ranks, per exchange,
    in the JAX package's dict: ``{"total_bytes", "ops": [{"op", "bytes",
    "bytes_per_device"}, ...]}``.

    Kinds and counts are the JAX docstring's: ``collective-permute`` (the
    halos, the state tails, the stage hand-offs) counts the payload of one
    send times its sends; ``all-gather`` (the IIR end states),
    ``all-to-all`` (the reshard) and ``all-reduce`` (the tap sum, the
    heartbeat) count the per-device payload times the participants,
    summed over the groups.  A call that exchanges nothing gives zero.
    """
    from llzlab_tpu_torch.parallel.mesh import record_traffic

    with record_traffic() as ops:
        fn(*args, **kw)
    ops = list(ops)
    return {"total_bytes": int(sum(o["bytes"] for o in ops)), "ops": ops}


def roofline_report(
    *, seconds: float, flops: float = 0.0, bytes_moved: float = 0.0,
    device_kind: Optional[str] = None,
) -> Dict[str, float]:
    """Achieved against peak: the fraction of memory bandwidth and of
    dense bf16 matrix throughput.

    ``device_kind`` defaults to the current CUDA device's name, or "cpu"
    where there is none.  A name without a row in :data:`CHIP_PEAKS`
    raises: a report against another device's peaks would hide the one
    that ran.
    """
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else "cpu")
    if device_kind not in CHIP_PEAKS:
        raise ValueError(
            f"no peaks for device {device_kind!r} in CHIP_PEAKS "
            f"({sorted(CHIP_PEAKS)}); add its published figures")
    peaks = CHIP_PEAKS[device_kind]
    out = {
        "seconds": seconds,
        "achieved_gbps": bytes_moved / seconds / 1e9 if seconds else 0.0,
        "achieved_tflops": flops / seconds / 1e12 if seconds else 0.0,
        "peak_gbps": peaks["hbm_gbps"],
        "peak_tflops_bf16": peaks["tflops_bf16"],
    }
    out["hbm_fraction"] = out["achieved_gbps"] / peaks["hbm_gbps"]
    out["mxu_fraction_bf16"] = out["achieved_tflops"] / peaks["tflops_bf16"]
    return out

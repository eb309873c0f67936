"""The program's spans and counters, and what the card did during some
calls.

* :func:`span` marks a stretch of host work at a layer boundary
  (``pipeline``, ``ops``, ``kernels``, ``chains``, ``parallel``) as a
  profiler range named ``llz/<layer>/<name>``, only while a profiler
  runs: the range then lands in the profiler's event list on the clock
  of the card's kernels and copies, and ``utils.profiling.trace`` writes
  it out with them.  Off, a span is one check and one shared null
  context.  :func:`request` is the span of a call into a request entry
  (``Chain.apply``, ``Channelizer.step``, the sharded step), which is
  counted whether a profiler runs or not and carries the call's sequence
  number (``call`` in the range's arguments, which a trace taken with
  ``record_shapes`` shows); the spans of the call nest inside it on the
  host thread.

  The ranges are ``torch._C._profiler._RecordFunctionFast``, the
  profiler's range without the dispatcher call of
  ``torch.profiler.record_function``: on an H100's host under the
  profiler a ``record_function`` range added 12 to 15 µs to a 0.5 ms
  stream block and a fast range next to nothing, so the traced slice
  keeps the proportions of an untraced one; and a fast range, unlike a
  ``record_function`` one, puts no user annotation on the card's
  timeline and carries an integer argument into the trace.
* :func:`counters` is one snapshot of the program's counters, kept with
  or without a profiler: request calls, the bytes every exchange between
  ranks notes (``parallel.mesh.note_traffic``) by kind, the kernels'
  launches (their wrappers' ``.launches`` attributes), the builds of
  ``kernels/_build.py``, the IIR scan's reads of its states from the
  device (``ops.iir.apply_section_host``) by calling op, the frames
  ``SpectralGainStage`` synthesises, by engine, and the samples and the
  slab bytes of ``ops.resample.resample_poly``.
* :func:`profile_calls` profiles some calls and says what the cards did.
  ``chip_smoke.py`` and the ``scripts/profile_*_torch.py`` scripts read
  their profiles through it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

#: the layers a span names, from the entry points down to the kernels
LAYERS = ("pipeline", "ops", "kernels", "chains", "parallel")


class _Off:
    """The null context of every span while no profiler runs.  Its enter
    and exit are one C call each: ``"".format`` takes any arguments and
    returns "", which is false, so an exception passes through."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()
#: guards the totals of the cold paths (exchanges, builds)
_LOCK = threading.Lock()
#: calls of each request entry, by its span's name
_CALLS: Dict[str, int] = {}
#: bytes noted by ``note_traffic``, by kind
_TRAFFIC: Dict[str, int] = {}
#: ``[builds, nvcc seconds]`` by kernel source name
_BUILDS: Dict[str, list] = {}
#: the IIR scan's device-to-host reads of its states, by calling op
_STATE_READS: Dict[str, int] = {}
#: frames synthesised by ``SpectralGainStage``, by engine
_FRAMES: Dict[str, int] = {}
#: ``resample_poly``'s input samples and the bytes of its slab intermediates
_RESAMPLE: Dict[str, int] = {}


def span(layer: str, name: str):
    """``with span(layer, name):`` records the enclosed host work as
    ``llz/<layer>/<name>`` while a profiler runs, and does nothing else
    otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(f"llz/{layer}/{name}")


def request(layer: str, name: str):
    """As :func:`span`, for a call into a request entry: counts the call,
    and passes its sequence number (1 for the first call of the process)
    as the range's argument ``call``.  The count is a plain integer add,
    as the kernels' ``.launches``: calls of one entry from several
    threads at once may lose a count."""
    n = _CALLS[name] = _CALLS.get(name, 0) + 1
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(f"llz/{layer}/{name}", (), {"call": n})


def count_traffic(kind: str, nbytes: int) -> None:
    """Add an exchange's bytes to the running total of its kind."""
    with _LOCK:
        _TRAFFIC[kind] = _TRAFFIC.get(kind, 0) + nbytes


def count_build(name: str, seconds: float) -> None:
    """Count one build of ``csrc/<name>.cu`` and its nvcc seconds."""
    with _LOCK:
        got = _BUILDS.setdefault(name, [0, 0.0])
        got[0] += 1
        got[1] += seconds


def count_state_reads(op: str, n: int) -> None:
    """Count ``n`` reads of scan states from the device under ``op``: a
    plain integer add, always on, as the kernels' ``.launches``."""
    _STATE_READS[op] = _STATE_READS.get(op, 0) + n


def count_frames(engine: str, n: int) -> None:
    """Count ``n`` frames synthesised by ``engine``: a plain integer add,
    always on, as :func:`count_state_reads`."""
    _FRAMES[engine] = _FRAMES.get(engine, 0) + n


def count_resample(samples: int, slab_bytes: int) -> None:
    """Count a call of ``resample_poly``: its input samples and the bytes
    of the intermediates its dense path makes, a plain integer add, always
    on, as :func:`count_frames`."""
    _RESAMPLE["samples"] = _RESAMPLE.get("samples", 0) + samples
    _RESAMPLE["slab_bytes"] = _RESAMPLE.get("slab_bytes", 0) + slab_bytes


def counters() -> dict:
    """A snapshot of the program's counters since the process started::

        {"calls": {entry: calls},
         "traffic_bytes": {kind: bytes},
         "launches": {"B1": {"launches": n}, ..., "B3": {"launches": n,
                      "cross_card_launches": n, ...}, ...,
                      "sos_scan": {"launches": n},
                      "wola_gain": {"launches": n}},
         "builds": {source: {"builds": n, "nvcc_s": seconds}},
         "state_reads": {op: reads},
         "frames": {engine: frames},
         "resample": {"samples": n, "slab_bytes": bytes}}

    ``traffic_bytes`` counts as ``utils.profiling.collective_traffic``
    does (a send's payload times its sends); ``frames`` counts the frames
    ``SpectralGainStage.apply`` synthesised (rows × block // hop a call),
    by the engine that ran them; ``resample`` the input samples of every
    ``resample_poly`` call and the bytes of the intermediates its dense
    path made (empty before the first call)."""
    from llzlab_tpu_torch.kernels import block2_fir as _b2
    from llzlab_tpu_torch.kernels import fused_fir_resample as _b1
    from llzlab_tpu_torch.kernels import halo_fir_fused as _b4
    from llzlab_tpu_torch.kernels import halo_ring as _b3
    from llzlab_tpu_torch.kernels import sos_scan as _sos
    from llzlab_tpu_torch.kernels import wola_gain as _wola

    wrappers = {"B1": _b1.fused_fir_resample_cuda, "B2": _b2.block2_fir_cuda,
                "B3": _b3.left_halo_ring_cuda,
                "B4": _b4.block2_fir_halo_fused_cuda,
                "sos_scan": _sos.sos_scan_cuda,
                "wola_gain": _wola.wola_gain_cuda}
    with _LOCK:
        return {
            "calls": dict(_CALLS),
            "traffic_bytes": dict(_TRAFFIC),
            "launches": {k: {a: v for a, v in vars(fn).items()
                             if a.endswith("launches")}
                         for k, fn in wrappers.items()},
            "builds": {k: {"builds": n, "nvcc_s": s}
                       for k, (n, s) in _BUILDS.items()},
            "state_reads": dict(_STATE_READS),
            "frames": dict(_FRAMES),
            "resample": dict(_RESAMPLE),
        }


@dataclasses.dataclass
class DeviceProfile:
    """Per call, averaged over the profiled calls."""

    #: ``(name, device ms, launches)`` of each kernel or copy, slowest first
    rows: List[Tuple[str, float, float]]
    #: kernel launches
    kernels: float
    #: memory copies and sets
    copies: float
    #: device time of the kernels and copies, summed over streams and cards
    busy_ms: float
    #: CUDA-event time, the first call's start to the last call's end
    event_ms: float
    #: host time to enqueue a call
    host_ms: float
    #: each card's busy time, the union of its kernel and copy intervals:
    #: ``{device index: ms}``
    busy_by_device: dict = dataclasses.field(default_factory=dict)

    @property
    def idle_pct(self) -> float:
        """The share of the event time in which a card ran nothing, the
        mean over the cards."""
        shares = [max(0.0, 1.0 - ms / self.event_ms)
                  for ms in self.busy_by_device.values()]
        return 100.0 * sum(shares) / len(shares)


def device_ops(events) -> Dict[int, List[Tuple[float, float, str]]]:
    """``{device index: [(start us, end us, name), ...]}`` of the device's
    kernels, copies and sets among profiler ``events``.  The profiler also
    puts each ``record_function`` range on the device's timeline, as a
    user annotation from its first kernel to its last: those are not
    device work and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out: Dict[int, list] = {}
    for e in events:
        if e.device_type == cuda and not e.is_user_annotation:
            out.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    return out


def union_length(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: time that
    streams overlap counts once."""
    total, reach = 0.0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def profile_calls(fn: Callable[[], object], iters: int = 1,
                  trace: Optional[str] = None) -> Optional[DeviceProfile]:
    """Run ``fn()`` ``iters`` times back to back under ``torch.profiler``
    on the current CUDA stream and return what the cards did per call;
    ``None`` where the profiler saw no device time.  Every visible card is
    drained before and after.  ``trace``: also write the timeline there
    (``export_chrome_trace``).  Warm ``fn`` up first: its first call may
    build kernels and tables."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def sync_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync_all()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        begin.record()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        sync_all()
    if trace:
        prof.export_chrome_trace(trace)
    ops = device_ops(prof.events())
    by_name: Dict[str, list] = {}
    for card in ops.values():
        for s, e, name in card:
            got = by_name.setdefault(name, [0.0, 0])
            got[0] += (e - s) / 1e3 / iters
            got[1] += 1 / iters
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items() if ms > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy <= 0.0:
        return None
    copies = sum(r[2] for r in rows
                 if r[0].startswith(("Memcpy", "Memset")))
    return DeviceProfile(
        rows=rows, kernels=sum(r[2] for r in rows) - copies, copies=copies,
        busy_ms=busy, event_ms=begin.elapsed_time(end) / iters,
        host_ms=host_ms,
        busy_by_device={
            card: union_length((s, e) for s, e, _ in v) / 1e3 / iters
            for card, v in sorted(ops.items())})

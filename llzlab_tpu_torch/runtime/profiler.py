"""What the card did during some calls, read from ``torch.profiler``: the
kernels and memory copies they launched, their device time, and the calls'
CUDA-event and host enqueue times.  ``chip_smoke.py`` and the
``scripts/profile_*_torch.py`` scripts read their profiles through
:func:`profile_calls`."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class DeviceProfile:
    """Per call, averaged over the profiled calls."""

    #: ``(name, device ms, launches)`` of each kernel or copy, slowest first
    rows: List[Tuple[str, float, float]]
    #: kernel launches
    kernels: float
    #: memory copies and sets
    copies: float
    #: device time of the kernels and copies, summed over streams
    busy_ms: float
    #: CUDA-event time, the first call's start to the last call's end
    event_ms: float
    #: host time to enqueue a call
    host_ms: float
    #: ``busy_ms`` split by card: ``{device index: ms}``
    busy_by_device: dict = dataclasses.field(default_factory=dict)

    @property
    def idle_pct(self) -> float:
        """The share of the event time in which the card ran nothing."""
        return 100.0 * max(0.0, 1.0 - self.busy_ms / self.event_ms)


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
    by_device: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_device[e.device_index] = by_device.get(e.device_index, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / iters
    rows = [(e.key, e.device_time_total / 1e3 / iters, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy <= 0.0:
        return None
    copies = sum(r[2] for r in rows
                 if r[0].startswith(("Memcpy", "Memset")))
    return DeviceProfile(rows=rows, kernels=sum(r[2] for r in rows) - copies,
                         copies=copies, busy_ms=busy,
                         event_ms=begin.elapsed_time(end) / iters,
                         host_ms=host_ms, busy_by_device=by_device)

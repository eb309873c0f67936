"""What the device did in a traced slice of the window, from
``torch.profiler``: each card's operations as intervals, the host's spans
on the harness's thread, and the slice's own span.  Busy time is the union
of a card's intervals (streams overlap), never their sum."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

#: the harness's span around the traced slice
SLICE = "portbench.slice"
#: every span of an untraced run
_OFF = contextlib.nullcontext()


def union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(v) for v in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Trace:
    """One traced slice.  Times in seconds on the profiler's clock.

    ``ops``: per card, ``(start, end, name)`` of every kernel, copy and
    set; ``host``: ``(start, end, name)`` of the host's events on the
    harness's thread; ``window``: the slice's ``(start, end)``; ``steps``:
    the steps (or blocks) the slice ran."""

    def __init__(self, ops: dict, host: list, window: tuple, steps: int):
        self.ops = {c: sorted(v) for c, v in ops.items()}
        self.host = sorted(host)
        self.window = window
        self.steps = steps

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def cards(self):
        return sorted(self.ops)

    def busy(self, card):
        """The card's merged busy intervals inside the window."""
        lo, hi = self.window
        return clip(union((s, e) for s, e, _ in self.ops[card]), lo, hi)

    def busy_s(self, card) -> float:
        return sum(e - s for s, e in self.busy(card))

    def gaps(self, card):
        """The card's idle intervals inside the window."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy(card):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def ops_in_window(self, card):
        lo, hi = self.window
        return [(s, e, n) for s, e, n in self.ops[card] if e > lo and s < hi]

    def host_at(self, points):
        """For each time in ``points``, the name of the innermost host
        event that holds it, or "host idle".  The events of one thread
        nest, so the innermost is the latest to start among those that
        hold the time."""
        starts = [s for s, _, _ in self.host]
        names = []
        for p in points:
            i = bisect.bisect_right(starts, p)
            name = "host idle"
            for s, e, n in reversed(self.host[max(0, i - 4096):i]):
                if e >= p:
                    name = n
                    break
            names.append(name)
        return names

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed over cards)
        and the idle time of the cards by what the host was doing, each
        ``[[name, seconds], ...]``, longest first."""
        lo, hi = self.window
        by_op = defaultdict(float)
        for c in self.cards():
            for s, e, n in self.ops_in_window(c):
                by_op[n[:120]] += min(e, hi) - max(s, lo)
        by_gap = defaultdict(float)
        for c in self.cards():
            gaps = self.gaps(c)
            for (s, e), n in zip(gaps, self.host_at(
                    [(s + e) / 2 for s, e in gaps])):
                by_gap[n[:120]] += e - s

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_gap)}


class Spans:
    """The harness's spans around its calls into the program's layers:
    ``torch.profiler.record_function`` ranges while a slice is traced, and
    host-clock totals (``host_s``, ``calls``) of named spans in a traced
    run outside the profiled slice, where the profiler's own cost is not
    in them.  Off, every span is one shared null context."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profiling = False
        self.host_s = defaultdict(float)
        self.calls = defaultdict(int)
        self.names = {SLICE}

    def __call__(self, name: str):
        return self._span(name) if self.enabled else _OFF

    @contextlib.contextmanager
    def _span(self, name: str):
        if self.profiling:
            from torch.profiler import record_function

            self.names.add(name)

            with record_function(name):
                yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_s[name] += time.perf_counter() - t0
            self.calls[name] += 1


def collect(prof, steps: int, spans=()) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    traced slice ran inside a ``record_function(SLICE)``.  The profiler
    also puts each ``record_function`` range on the device's timeline, as
    a user annotation from its first kernel to its last: those (and any
    event named as one of ``spans``) are not device operations."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, host, window, thread = defaultdict(list), [], None, None
    events = prof.events()
    for e in events:
        if e.device_type != cuda and e.name == SLICE:
            window = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            thread = e.thread
    if window is None:
        raise RuntimeError(f"the trace holds no {SLICE!r} span")
    for e in events:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in spans or e.name == SLICE):
                ops[e.device_index].append((s, t, e.name))
        elif e.thread == thread and e.name != SLICE:
            host.append((s, t, e.name))
    return Trace(ops, host, window, steps)

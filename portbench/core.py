"""The harness's core: finds a cell's configuration, workload, driver and
metric readers by the names in ``BENCHMARK.json``, runs set-up, the
measured window and (with ``trace``) a profiled slice of it, checks the
kept outputs against the reference, and builds the result line.  It
knows no cell, configuration or metric by name: those are files.

* ``portbench/configs/<config>.json``: the configuration's widths;
* ``portbench/workloads/<cell>.json``: its configuration and traffic
  names, the driver, precision, traffic parameters and check limits;
* ``portbench/drivers/<driver>.py``: the entry point a window drives;
* ``portbench/metrics/<metric>.py``: the reader of one per-layer metric.

The end-to-end metrics are arithmetic over the window's record
(:data:`END_TO_END`)."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "llzlab_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"{name!r} is not in BENCHMARK.json")


class Cell:
    """One cell: its entry, workload file, configuration and metrics."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or benchmark()
        self.name = name
        self.entry = find(bench["workloads"], name)
        self.wl = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
        for key in ("config", "traffic", "chips"):
            if self.wl[key] != self.entry[key]:
                raise ValueError(f"{name}: {key} is {self.wl[key]!r} in its "
                                 f"workload file, {self.entry[key]!r} in "
                                 "BENCHMARK.json")
        cfg_entry = find(bench["configs"], self.entry["config"])
        self.cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = self.entry["chips"]


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class Window:
    """What the measured window did: read by :data:`END_TO_END`."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _block_p95_ms(w):
    return percentile(w.latencies_ms, 95) if w.latencies_ms else None


#: each end-to-end metric from the window's record; None where the cell
#: has nothing to read
END_TO_END = {
    # every input sample of the steps (or blocks) the window completed,
    # over its wall time from its start to the final synchronise, a card
    "throughput_msps": lambda w: w.samples / w.seconds / w.cards / 1e6,
    # a block's latency, host memory to host memory, at the 95th
    # percentile (nearest rank) over every block of the window
    "block_p95_ms": _block_p95_ms,
    # max_memory_allocated since the window's start, on the fullest card
    "peak_mem_gib": lambda w: w.peak_bytes / 2 ** 30 if w.peak_bytes
    else None,
    # process start to the first timed step: the build of any kernel,
    # the inputs, the designs and the warm-up of every shape
    "setup_s": lambda w: w.setup_s,
}


class Context:
    """What a per-layer reader reads: the traced slice, the harness's host
    spans, the cell's configuration and workload."""

    def __init__(self, **kw):
        self.notes = []
        self.__dict__.update(kw)

    def note(self, text: str):
        """A line printed before the result line."""
        self.notes.append(text)


def hardware(devices) -> list:
    """Name, power limit, clocks, draw and temperature of each card used,
    from ``nvidia-smi``; empty where it cannot be read."""
    idx = ",".join(str(d.index) for d in devices if d.type == "cuda")
    if not idx:
        return []
    fields = "index,name,power.limit,power.draw,clocks.sm,clocks.max.sm," \
        "clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    keys = fields.split(",")
    return [dict(zip(keys, (v.strip() for v in line.split(","))))
            for line in out.strip().splitlines()]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, devices,
             *, t_start: float, sizes=None, say=None) -> dict:
    """Run one cell once on ``devices`` (torch devices, one a card the
    cell asks for) and return the result line.  ``sizes`` shrinks a cell
    for the tests on the CPU."""
    import torch

    from portbench.trace import Spans, collect

    say = say or (lambda text: print(text, flush=True))
    cell = Cell(name)
    wl, cfg = cell.wl, cell.cfg
    driver = load_module("drivers", wl["driver"])
    marks = [time.perf_counter()]
    spans = Spans(enabled=trace)
    drv = driver.Driver(cfg, wl, seed, devices, spans, sizes)
    marks.append(time.perf_counter())
    cuda = drv.devices[0].type == "cuda"
    lo, hi = wl["trace_after"], wl["trace_after"] + wl["trace_steps"]
    with drv.scope():
        drv.warmup()
        marks.append(time.perf_counter())
        drv.start()
        if cuda:
            for d in drv.devices:
                torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - t_start
        steps, window_s, failed, prof = measure(
            drv, spans, seconds, (lo, hi) if trace else None,
            lambda: _profiler(cuda))
    peak = max(torch.cuda.max_memory_allocated(d) for d in drv.devices) \
        if cuda else 0
    window = Window(seconds=window_s, steps=steps,
                    samples=steps * drv.samples_per_step,
                    cards=len(drv.devices), setup_s=setup_s,
                    peak_bytes=peak,
                    latencies_ms=getattr(drv, "latencies_ms", lambda: None)())
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(drv.devices[0])
              if cuda else "cpu",
              "count": len(drv.devices), "memory_peak_bytes": peak}
    say(json.dumps({"hardware": hardware(drv.devices),
                    "window_s": window_s, "steps": steps,
                    "setup_s": setup_s, "setup_parts_s": {
                        "imports": marks[0] - t_start,
                        "program_and_inputs": marks[1] - marks[0],
                        "warmup": marks[2] - marks[1]}}))
    metrics, breakdown = {}, None
    if trace:
        tr = collect(prof, steps=hi - lo, spans=spans.names)
        prof = None
        cards = [d.index if cuda else -1 for d in drv.devices]
        busy = [tr.busy_s(c) if c in tr.ops else 0.0 for c in cards]
        device.update(busy_s=sum(busy) / len(busy), window_s=tr.window_s)
        ctx = Context(trace=tr, cards=cards, steps=hi - lo,
                      samples_per_step=drv.samples_per_step, cfg=cfg, wl=wl,
                      device_name=device["kind"], spans=spans)
        if any(c in tr.ops for c in cards):  # the device did something
            for m in cell.per_layer:
                value = load_module("metrics", m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = tr.breakdown()
        for text in ctx.notes:
            say(text)
    else:
        for m in cell.end_to_end:
            value = END_TO_END[m["name"]](window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the check, once the window has closed and the program's state is gone
    kept = drv.kept()
    args = drv.check_args()
    drv.free()
    drv = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check_of(driver)(cfg, wl, seed, kept, **args)
    del kept
    limits = wl["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    line = {"correct": correct, "attempted": steps, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def measure(drv, spans, seconds: float, traced=None, profiler=None):
    """The measured window: steps ``0, 1, ...`` queued back to back until
    ``seconds`` have passed, then the wait for all of them.  Returns the
    steps, the window's wall time from its start to the final wait, the
    failed steps and, with ``traced = (lo, hi)``, the finished profile of
    steps ``lo`` to ``hi - 1`` (each side of the slice waits for the
    device; the window runs at least to its end)."""
    import torch

    from portbench.trace import SLICE

    t0 = time.perf_counter()
    i, prof = 0, None
    while True:
        if traced and i == traced[0]:
            drv.sync()
            prof = profiler()
            prof.start()
            spans.profiling = True
            slice_span = torch.profiler.record_function(SLICE)
            slice_span.__enter__()
        with spans("portbench.step"):
            drv.step(i)
        i += 1
        if traced and i == traced[1]:
            drv.sync()
            slice_span.__exit__(None, None, None)
            spans.profiling = False
            prof.stop()
        if time.perf_counter() - t0 >= seconds and (
                not traced or i >= traced[1]):
            break
    failed = drv.finish()
    return i, time.perf_counter() - t0, failed, prof


def check_of(driver):
    """The check of a driver's outputs: the driver's own ``check``
    function, or the one of ``checks.py`` its ``CHECK`` names."""
    if hasattr(driver, "check"):
        return driver.check
    from portbench.checks import CHECKS

    return CHECKS[driver.CHECK]


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)

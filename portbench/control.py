#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the
program's place, computed in the nearest precision below the one the
cell's workload states (bf16 products for "high", which is bf16x3; TF32
products for "highest", fp32 with TF32 off), through the same comparison
as a run, on the outputs a run of ``--steps`` steps (or blocks) keeps.
Its numbers have to come out over the limits, so that ``correct`` fails:

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--steps N]

Prints a JSON line a seed.  The benchmark's runs do not run it."""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: the precision a workload states -> the control's rounding
BELOW = {"high": "bf16", "highest": "tf32"}
#: steps (blocks) of a run of ten seconds on the card, about
STEPS = {"channelizer": 220, "stream": 30000}


def control_kept(cell, seed: int, steps: int, device, sizes=None):
    """The outputs a run of ``steps`` steps keeps, made by the reference at
    the control's precision, in the driver's format; and the check's
    keyword arguments."""
    import numpy as np
    import torch

    from portbench import checks, core

    rounding = BELOW[cell.wl["precision"]]
    kind = core.load_module("drivers", cell.wl["driver"]).CHECK
    sizes = sizes or {}
    if kind == "stream":
        mask = checks.stream_sampled(seed, cell.wl)
        idx = [i for i in range(steps) if mask[i % len(mask)]]
        if not idx or idx[-1] != steps - 1:
            idx.append(steps - 1)
        y = checks.stream_reference(cell.cfg, cell.wl, seed, idx, rounding)
        return kind, [(i, v.astype(np.float32)) for i, v in zip(idx, y)], {}
    channels = sizes.get("channels", cell.cfg["channels"])
    samples = sizes.get("step_samples", cell.wl["step_samples"])
    sampled = checks.channelizer_sampled(seed, cell.wl, channels)
    plan = [(s, r) for s, r in sampled.items() if s < steps - 1]
    plan.append((steps - 1, None))
    got = {}
    for s, rows, frames in checks.channelizer_reference(
            cell.cfg, cell.wl, seed, plan, channels, samples, device,
            rounding):
        got.setdefault(s, []).append(frames.to(torch.complex64))
    kept = [(s, r, torch.cat(got[s])) for s, r in plan]
    return kind, kept, dict(channels=channels, samples=samples,
                            device=device)


def run_control(name: str, seed: int, steps=None, device=None, sizes=None):
    """The control's compared numbers, their limits and ``correct``."""
    from portbench import core

    cell = core.Cell(name)
    kind = core.load_module("drivers", cell.wl["driver"]).CHECK
    kind, kept, args = control_kept(cell, seed, steps or STEPS[kind],
                                    device, sizes)
    numbers = core.check_of(core.load_module(
        "drivers", cell.wl["driver"]))(cell.cfg, cell.wl, seed, kept, **args)
    limits = cell.wl["limits"]
    return {"workload": name, "seed": seed,
            "rounding": BELOW[cell.wl["precision"]],
            "checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in numbers.items()},
            "correct": all(v <= limits[k] for k, v in numbers.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in args.seeds:
        print(json.dumps(run_control(args.workload, seed, args.steps,
                                     device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

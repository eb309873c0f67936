#!/usr/bin/env python3
"""The control of the resampler stream's check
(``drivers/resample_stream.py``): the plain reference put in the
program's place, with both operands of every product (the taps and the
input) rounded one format below the precision the cell's workload states
(``control.BELOW``: TF32 below "highest"), through the same comparison as
a run (``checks_resample.block_err_max``), on the blocks a run of
``--steps`` blocks keeps.  Its number has to come out over the limit, so
that ``correct`` fails:

    python3 portbench/control_resample.py --workload <cell> --seeds 1 2 3 \
        [--steps N]

Prints a JSON line a seed.  The benchmark's runs do not run it."""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: blocks of a run of ten seconds on the card, about
STEPS = 25000


def control_kept(cell, seed: int, steps: int, device, channels: int):
    """The blocks a run of ``steps`` blocks keeps, made by the reference at
    the control's precision, ``[(block index, (C, out) float32)]``."""
    import torch

    from portbench import checks_resample, checks_sos, control

    sig = checks_resample.stream_signal(cell.cfg, cell.wl, seed, channels)
    mask = checks_sos.kept_mask(seed, cell.wl)
    idx = [i for i in range(steps) if mask[i % len(mask)] or i == steps - 1]
    y = checks_resample.reference_blocks(
        cell.cfg, cell.wl, sig, idx, device,
        control.BELOW[cell.wl["precision"]])
    return [(i, v.to(torch.float32).cpu()) for i, v in zip(idx, y)]


def run_control(name: str, seed: int, steps=None, device=None,
                channels=None):
    """The control's compared number, its limit and ``correct``."""
    from portbench import checks_resample, control, core

    cell = core.Cell(name)
    channels = channels or cell.cfg["channels"]
    kept = control_kept(cell, seed, steps or STEPS, device, channels)
    numbers = checks_resample.check(cell.cfg, cell.wl, seed, kept,
                                    channels=channels, device=device)
    limits = cell.wl["limits"]
    return {"workload": name, "seed": seed,
            "rounding": control.BELOW[cell.wl["precision"]],
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

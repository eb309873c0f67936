#!/usr/bin/env python3
"""The control of the spectral-gain chain's check
(``drivers/spectral_block.py``): the plain reference put in the program's
place, with the operands of every product (the windows, the gain, the
frames and spectra they multiply) and every FFT's input rounded to TF32,
one format below the cell's "highest", through the same comparison as a
run (``checks_stft.block_err_max``), on the steps a run of ``--steps``
steps keeps.  Its number has to come out over the limit, so that
``correct`` fails:

    python3 portbench/control_stft.py --workload <cell> --seeds 1 2 3 \
        [--steps N]

Prints a JSON line a seed.  The benchmark's runs do not run it."""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: steps of a run of ten seconds on the card, about (its parity picks the
#: last step's input block)
STEPS = 3300


def run_control(name: str, seed: int, steps=None, device=None, sizes=None):
    """The control's compared number, its limit and ``correct``; ``sizes``
    shrinks the cell as for the driver."""
    from portbench import checks_stft, control, core

    cell = core.Cell(name)
    sizes = sizes or {}
    channels = sizes.get("channels", cell.cfg["channels"])
    block = sizes.get("block", cell.wl["block"])
    rounding = control.BELOW[cell.wl["precision"]]
    ref = checks_stft.Reference(cell.cfg, cell.wl, seed, channels, block,
                                device)
    kept = [(i, rows, ref.step(i, rows, rounding).float())
            for i, rows in checks_stft.kept_steps(seed, cell.wl, channels,
                                                  (steps or STEPS) - 1)]
    numbers = {"block_err_max": checks_stft.block_err_max(ref, kept)}
    limits = cell.wl["limits"]
    return {"workload": name, "seed": seed, "rounding": rounding,
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

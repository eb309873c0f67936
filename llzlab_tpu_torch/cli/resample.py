"""Resampler tool (port of ``llzlab_tpu/cli/resample.py``).

    python -m llzlab_tpu_torch.cli.resample -i in48k.wav -o out44k.wav \
        --rate 44100 [--cpu]
"""

import argparse
import math

from llzlab_tpu_torch.cli.common import add_io_args, run_chain_tool
from llzlab_tpu_torch.io.wav import wav_info
from llzlab_tpu_torch.pipeline import Chain, ResampleStage


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_io_args(p)
    p.add_argument("--rate", type=int, required=True, help="target sample rate")
    p.add_argument("--taps-per-phase", type=int, default=64)
    args = p.parse_args(argv)

    in_rate = wav_info(args.input).sample_rate
    g = math.gcd(args.rate, in_rate)
    up, down = args.rate // g, in_rate // g
    chain = Chain([ResampleStage(up, down, taps_per_phase=args.taps_per_phase)])
    return run_chain_tool(args, chain, out_rate_fn=lambda r: args.rate,
                          tool="resample")


if __name__ == "__main__":
    main()

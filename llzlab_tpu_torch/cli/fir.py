"""FIR filter tool (port of ``llzlab_tpu/cli/fir.py``).

    python -m llzlab_tpu_torch.cli.fir -i in.wav -o out.wav \
        --taps 1024 --cutoff 0.25 [--kind lowpass] [--window hamming] [--cpu]
"""

import argparse

from llzlab_tpu_torch.cli.common import add_io_args, run_chain_tool
from llzlab_tpu_torch.ops.fir import firwin
from llzlab_tpu_torch.pipeline import Chain, FIRStage


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_io_args(p)
    p.add_argument("--taps", type=int, default=1024)
    p.add_argument("--cutoff", type=float, nargs="+", default=[0.25],
                   help="normalised cutoff(s), Nyquist units")
    p.add_argument("--kind", default="lowpass",
                   choices=["lowpass", "highpass", "bandpass", "bandstop"])
    p.add_argument("--window", default="hamming")
    p.add_argument("--kaiser-beta", type=float, default=None)
    p.add_argument("--method", default="auto", choices=["auto", "ols", "direct"])
    args = p.parse_args(argv)

    window = ("kaiser", args.kaiser_beta) if args.kaiser_beta else args.window
    cutoff = args.cutoff if len(args.cutoff) > 1 else args.cutoff[0]
    taps = firwin(args.taps, cutoff, window=window, pass_zero=args.kind)
    chain = Chain([FIRStage(taps, method=args.method)])
    return run_chain_tool(args, chain, tool="fir")


if __name__ == "__main__":
    main()

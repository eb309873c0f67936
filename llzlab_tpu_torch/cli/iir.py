"""IIR EQ tool (port of ``llzlab_tpu/cli/iir.py``).

    python -m llzlab_tpu_torch.cli.iir -i in.wav -o out.wav \
        --eq 100:3 400:-2 1600:5 [--cpu]   # peaking sections freq:gain_dB
    python -m llzlab_tpu_torch.cli.iir -i in.wav -o out.wav \
        --butter 8 --cutoff 0.3 --kind lowpass [--cpu]
"""

import argparse

from llzlab_tpu_torch.cli.common import add_io_args, run_chain_tool
from llzlab_tpu_torch.io.wav import wav_info
from llzlab_tpu_torch.ops.iir import butter_sos, cheby1_sos, peaking_eq_sos
from llzlab_tpu_torch.pipeline import Chain, SOSStage


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_io_args(p)
    p.add_argument("--eq", nargs="+", default=None,
                   help="peaking sections as freq_hz:gain_db")
    p.add_argument("--q", type=float, default=1.0)
    p.add_argument("--butter", type=int, default=None, help="Butterworth order")
    p.add_argument("--cheby1", type=int, default=None, help="Chebyshev-I order")
    p.add_argument("--ripple", type=float, default=1.0)
    p.add_argument("--cutoff", type=float, nargs="+", default=[0.3])
    p.add_argument("--kind", default="lowpass",
                   choices=["lowpass", "highpass", "bandpass", "bandstop"])
    p.add_argument("--block-size", type=int, default=4096,
                   help="scan block length")
    args = p.parse_args(argv)

    rate = wav_info(args.input).sample_rate
    cutoff = args.cutoff if len(args.cutoff) > 1 else args.cutoff[0]
    if args.eq:
        freqs, gains = zip(*(map(float, s.split(":")) for s in args.eq))
        sos = peaking_eq_sos(freqs, gains, float(rate), q=args.q)
    elif args.butter:
        sos = butter_sos(args.butter, cutoff, args.kind)
    elif args.cheby1:
        sos = cheby1_sos(args.cheby1, args.ripple, cutoff, args.kind)
    else:
        p.error("one of --eq / --butter / --cheby1 is required")
    chain = Chain([SOSStage(sos, block_size=args.block_size)])
    return run_chain_tool(args, chain, tool="iir")


if __name__ == "__main__":
    main()

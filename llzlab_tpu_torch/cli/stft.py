"""Spectral-gain tool: STFT → per-bin gain → iSTFT, config 4
(BASELINE.json:10) as a command (port of ``llzlab_tpu/cli/stft.py``).

    python -m llzlab_tpu_torch.cli.stft -i in.wav -o out.wav \
        --notch 1000 2000            # zero bins covering 1–2 kHz
    python -m llzlab_tpu_torch.cli.stft -i in.wav -o out.wav --gain-db -6

Runs on the current CUDA card unless ``--cpu`` is given.  The output keeps
the JAX package's convention: it lags the input by the stage's latency of
``n_fft − hop`` samples (leading zeros), and the stream is not flushed.
"""

import argparse

import numpy as np

from llzlab_tpu_torch.cli.common import add_io_args, run_chain_tool
from llzlab_tpu_torch.io.wav import wav_info
from llzlab_tpu_torch.pipeline import Chain, SpectralGainStage


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_io_args(p)
    p.add_argument("--n-fft", type=int, default=2048)
    p.add_argument("--hop", type=int, default=None)
    p.add_argument("--window", default="hann")
    p.add_argument("--gain-db", type=float, default=0.0,
                   help="broadband gain applied in the spectral domain")
    p.add_argument("--notch", type=float, nargs=2, default=None,
                   metavar=("F_LO", "F_HI"), help="zero bins in [f_lo, f_hi] Hz")
    args = p.parse_args(argv)

    rate = wav_info(args.input).sample_rate
    bins = args.n_fft // 2 + 1
    gain = np.full(bins, 10.0 ** (args.gain_db / 20.0), np.float32)
    if args.notch:
        f_lo, f_hi = args.notch
        k = np.arange(bins) * rate / args.n_fft
        gain[(k >= f_lo) & (k <= f_hi)] = 0.0
    chain = Chain([
        SpectralGainStage(gain, n_fft=args.n_fft, hop=args.hop,
                          window=args.window)
    ])
    return run_chain_tool(args, chain, tool="stft")


if __name__ == "__main__":
    main()

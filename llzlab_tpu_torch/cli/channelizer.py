"""Wideband channelizer tool, the flagship chain (BASELINE.json:11) as a
command (port of ``llzlab_tpu/cli/channelizer.py``).

    python -m llzlab_tpu_torch.cli.channelizer -i wide.wav -o spec.npz \
        [--fft 2048] [--mesh-channel N --mesh-time M] [--cpu]

Reads a multichannel WAV (or synthesises ``--synth`` channels of noise),
shards (channel, time) over a mesh of ranks, runs the FIR → resample → FFT
chain (``Channelizer.sharded_step``) and writes the spectra as an ``.npz``
(``spectra``, ``rate``, ``fft_n``), as the JAX package's tool does; a
channel count that the channel axis does not divide is padded with zero
channels, which the file keeps, as there.

The mesh: one rank per visible card by default (one on a machine with one
card); ``--mesh-channel N --mesh-time M`` puts N × M ranks on the cards,
dealt out by ``parallel.mesh.deal_devices`` (``--mesh-channel`` alone:
time fills the cards; ``--mesh-time`` alone: one channel row); ``--cpu``
runs a mesh of CPU ranks.  One process drives every rank, as the JAX
package's tool does.
"""

import argparse
import sys
import time

import numpy as np


def mesh_shape(mesh_channel, mesh_time, count: int):
    """The tool's ``(n_channel, n_time)`` on ``count`` cards: what the
    options give, the time axis filling the cards where ``--mesh-time``
    is not given (one rank a card by default)."""
    nc = mesh_channel or 1
    return nc, mesh_time or max(count // nc, 1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", "-i", default=None)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--synth", type=int, default=None,
                   help="synthesise N channels of noise instead of reading")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rate", type=int, default=48000)
    p.add_argument("--fft", type=int, default=2048)
    p.add_argument("--fir-taps", type=int, default=1024)
    p.add_argument("--fir-method", default="ols", choices=["ols", "direct"])
    p.add_argument("--mesh-channel", type=int, default=None)
    p.add_argument("--mesh-time", type=int, default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--metrics", default=None)
    args = p.parse_args(argv)

    import torch

    from llzlab_tpu_torch.chains.channelizer import Channelizer
    from llzlab_tpu_torch.io.wav import read_wav
    from llzlab_tpu_torch.ops.fir import firwin
    from llzlab_tpu_torch.parallel.mesh import gather, make_dsp_mesh, shard
    from llzlab_tpu_torch.runtime.platform import require_cuda
    from llzlab_tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(args.metrics)

    if args.input:
        x, rate = read_wav(args.input)
    else:
        c = args.synth or 8
        rng = np.random.default_rng(0)
        x = rng.standard_normal(
            (c, int(args.seconds * args.rate))
        ).astype(np.float32)
        rate = args.rate

    if args.cpu:
        nc, nt = mesh_shape(args.mesh_channel, args.mesh_time, 1)
        mesh = make_dsp_mesh(nc, nt, devices=["cpu"] * (nc * nt))
    else:
        require_cuda()
        nc, nt = mesh_shape(args.mesh_channel, args.mesh_time,
                            torch.cuda.device_count())
        mesh = make_dsp_mesh(nc, nt)
    chan = Channelizer(
        fir_taps=firwin(args.fir_taps, 0.4, window="hamming"),
        fft_n=args.fft,
        fir_method=args.fir_method,
        device=mesh.ranks[0].device,
    )
    nt = mesh.n_time
    m = chan.block_multiple() * nt
    c, t = x.shape
    if c % nc:
        pad_c = nc - c % nc
        x = np.pad(x, ((0, pad_c), (0, 0)))
        c += pad_c
    t_use = (t // m) * m
    if t_use == 0:
        print(f"input too short: need ≥ {m} samples", file=sys.stderr)
        sys.exit(1)
    x = x[:, :t_use]
    log.event("start", channels=c, samples=t_use, mesh=f"{nc}x{nt}",
              backend=mesh.ranks[0].device.type)

    parts = shard(torch.from_numpy(x), mesh)
    state = chan.init_state(c)
    step = chan.sharded_step(mesh)
    mesh.synchronize()
    t0 = time.perf_counter()
    spec, state = step(parts, state)
    mesh.synchronize()
    dt = time.perf_counter() - t0
    log.stage("channelizer", c * t_use, dt)
    spec = gather(spec, mesh, dim=1).cpu().numpy()
    np.savez(args.output, spectra=spec, rate=rate * 147 // 160,
             fft_n=args.fft)
    log.event("done", out=args.output, shape=list(spec.shape))
    return args.output


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Scaling harness of the PyTorch port (port of ``scripts/pod_scaling.py``):
config 5's sharded channelizer (``configs/channelizer_1024ch.json``,
``BASELINE.json:11``) over meshes of 1, 2 and 4 cards.

* ``--scaling weak`` (the default, as the JAX script): a fixed per-card
  block of ``--channels`` × ``--t-loc`` samples (1024 × 327 680, one of
  ``chip_smoke.py``'s four channelizer ranks) while the time axis grows:
  meshes ``1x1``, ``1x2``, ``1x4``.
* ``--scaling strong``: config 5's step, ``--channels`` × 4 · ``--t-loc``
  (1024 × 1 310 720), over ``1x1``, ``1x2``, ``1x4``, ``2x2`` and ``4x1``.

Each point reports Msamples/s per card and the efficiency against the
``1x1`` point (``weak_scaling_eff``, the JAX script's key, for both
kinds), the step time by CUDA events and by the host clock, and the bytes
a step moves between ranks twice: ``comm_bytes_per_step`` from the JAX
script's analytic model and ``comm_bytes_hlo`` from
``utils.profiling.collective_traffic`` (the notes of the port's exchanges;
the key keeps the JAX script's name).  The model is the JAX script's term
for term: the FIR and resampler halos, ``(n_time − 1)`` sends of ``C_row ×
h`` a channel row, and the state tails; the one difference is where the
tails go.  The JAX step replicates the state over the time ranks (``n_time
− 1`` sends a row); the port keeps it on each process's first rank, so a
row's last rank sends its tail to every process's first rank but itself.
With one process a card on a ``1xn`` mesh the two counts are one number.

One process drives every card by default: ranks dealt one a card
(``parallel.mesh.deal_devices``), several ranks a card where the cards are
fewer (the point reports its ``cards``).  ``--procs`` runs every point as
one process a rank, a card each, joined over NCCL (gloo with ``--cpu``),
on this machine; the step time is the slowest process's.  ``--cpu`` is a
functional run at a tiny size on CPU ranks (129 taps, 3/4, K = 8,
64-point frames, 8 channels of 1024 samples a rank): its times are the
host's, not a device's.

    python scripts/pod_scaling_torch.py [--scaling weak|strong] [--cpu]
        [--procs [--hosts]] [--meshes 1x1,2x2] [--iters 5]
        [--fir-method fused]
        [--frames local] [--halo ppermute] [--metrics out.jsonl]

The step is config 5's at ``highest`` with ``halo="ppermute"`` by
default; ``--halo rdma`` (kernel B3) or ``rdma_fused`` (B4, with
``--fir-method block2`` and at most 256 channels) run on the time row of
``1xn`` meshes, in one process or with ``--procs`` across processes
(through CUDA IPC between the processes of this machine).  ``--hosts``
with ``--procs`` makes each process a host of its own: the kernels' edges
are ``NET`` edges (the tails through NCCL, started with
``halo_ipc_worker_torch.NET_ENV``, ``NCCL_P2P_DISABLE=1
NCCL_SHM_DISABLE=1``, so that NCCL takes its network transport, as
between two machines).

Prints one JSON line per mesh point and a final summary line.  Needs a
card unless ``--cpu``.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import socket
import subprocess
import time

#: the meshes of each kind, as the JAX script's CxT tokens
MESHES = {"weak": "1x1,1x2,1x4", "strong": "1x1,1x2,1x4,2x2,4x1"}
#: config 5 (configs/channelizer_1024ch.json) and one rank of chip_smoke.py's
#: channelizer; the tiny functional run of --cpu
CARD = dict(channels=1024, t_loc=327680, fir_taps=1024, up=147, down=160,
            taps_per_phase=64, fft_n=2048)
TINY = dict(channels=8, t_loc=1024, fir_taps=129, up=3, down=4,
            taps_per_phase=8, fft_n=64)
#: how long a --procs point may take, process starts included
TIMEOUT_S = 600


def parse_meshes(text):
    return [tuple(int(v) for v in tok.lower().split("x"))
            for tok in text.split(",")]


def homes(n_ranks: int, procs: int):
    """Each process's first rank, ``procs`` processes of equal runs."""
    k = n_ranks // procs
    return [p * k for p in range(procs)]


def comm_bytes(chan, n_channel: int, n_time: int, c_total: int,
               procs: int = 1, frames: str = "local", t_total: int = 0):
    """Bytes a step moves between ranks, by the JAX script's model
    (``scripts/pod_scaling.py`` ``comm_bytes``) with the port's tails:
    the FIR and resampler halos, ``(n_time − 1)`` sends of ``C_row × (h_fir
    + h_rs)`` floats in each of the ``n_channel`` rows; each row's state
    tails, one send to each process's first rank but the row's last; with
    ``frames="a2a"`` the all-to-all of the resampled signal (its payload
    times the participants)."""
    h = chan.h_fir + chan.h_rs
    c_row = c_total // n_channel
    halos = n_channel * (n_time - 1) * c_row * h * 4
    firsts = homes(n_channel * n_time, procs)
    tails = sum(home != c * n_time + n_time - 1
                for c in range(n_channel) for home in firsts)
    a2a = c_total * (t_total * chan.up // chan.down) * 4 \
        if frames == "a2a" else 0
    return halos + tails * c_row * h * 4 + a2a


def make_channelizer(cfg, fir_method, device):
    from llzlab_tpu_torch.chains.channelizer import Channelizer
    from llzlab_tpu_torch.ops.fir import firwin

    return Channelizer(fir_taps=firwin(cfg["fir_taps"], 0.4,
                                       window="hamming"),
                       up=cfg["up"], down=cfg["down"],
                       taps_per_phase=cfg["taps_per_phase"],
                       fft_n=cfg["fft_n"], fir_method=fir_method,
                       device=device)


def run_point(args, cfg, n_channel: int, n_time: int, procs: int) -> dict:
    """One mesh point in this process (of ``procs``, each holding its
    share of the ranks): the record of the JAX script's keys and the
    port's."""
    import torch

    from llzlab_tpu_torch.parallel.mesh import make_dsp_mesh
    from llzlab_tpu_torch.runtime import distributed as rd
    from llzlab_tpu_torch.utils.profiling import collective_traffic

    nd = n_channel * n_time
    if args.scaling == "weak":
        c_total, t_total = cfg["channels"] * n_channel, cfg["t_loc"] * n_time
    else:
        c_total, t_total = cfg["channels"], cfg["t_loc"] * 4
    if procs > 1:
        mesh = rd.global_dsp_mesh(n_channel, n_time,
                                  ranks_per_process=nd // procs)
    elif args.cpu:
        mesh = make_dsp_mesh(n_channel, n_time, devices=["cpu"] * nd)
    else:
        mesh = make_dsp_mesh(n_channel, n_time)
    if args.halo != "ppermute":  # the kernel halos run on a 1-D time mesh
        if n_channel != 1:
            raise ValueError(f"--halo {args.halo} needs 1xn meshes, got "
                             f"{n_channel}x{n_time}")
        mesh = mesh.row(0)
    edges = None
    if args.halo != "ppermute" and procs > 1:  # every process at once
        from llzlab_tpu_torch.kernels.halo_ring import mesh_plan
        edges = mesh_plan(mesh)[1]
    home = mesh.ranks[mesh.home].device
    chan = make_channelizer(cfg, args.fir_method, home)
    chan.validate_sharded_shapes(mesh, c_total, t_total, args.frames)
    c_loc, t_loc = c_total // n_channel, t_total // n_time

    def block(rank, r):  # this rank's input, made on its device from a seed
        gen = torch.Generator(device=rank.device).manual_seed(1000 + r)
        return torch.randn((c_loc, t_loc), generator=gen,
                           device=rank.device)

    mesh.fork()
    parts = mesh.map(block, mesh.ranks, range(nd))
    mesh.join()
    step = chan.sharded_step(mesh, halo=args.halo, frames=args.frames)
    state = chan.init_state(c_total, device=home)
    traffic = collective_traffic(lambda: step(parts, state))
    spec, st = step(parts, state)  # warm-up
    cuda = home.type == "cuda"
    sync = (lambda: mesh.synchronize()) if cuda else (lambda: None)
    sync()
    if procs > 1:
        import torch.distributed as dist
        dist.barrier()
    t0 = time.perf_counter()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(home))
    for _ in range(args.iters):
        spec, st = step(parts, st)
    if cuda:
        end.record(torch.cuda.current_stream(home))
    sync()
    dt = (time.perf_counter() - t0) / args.iters
    ms = start.elapsed_time(end) / args.iters if cuda else None
    if procs > 1:  # the slowest process's times
        import torch.distributed as dist
        worst = torch.tensor([dt, ms or 0.0], dtype=torch.float64,
                             device=home if cuda else "cpu")
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        dt, ms = float(worst[0]), (float(worst[1]) if cuda else None)
    # a CPU rank stands in for a card
    cards = len({str(r.device) for r in mesh.ranks}) \
        if procs == 1 and cuda else nd
    per_card = c_total * t_total / dt / 1e6 / cards
    return {
        "mesh": f"{n_channel}x{n_time}",
        "devices": nd,
        "msps_per_chip": per_card,
        "aggregate_msps": per_card * cards,
        "weak_scaling_eff": None,
        "step_seconds": dt,
        "comm_bytes_per_step": comm_bytes(chan, n_channel, n_time, c_total,
                                          procs, args.frames, t_total),
        "comm_bytes_hlo": traffic["total_bytes"],
        "comm_ops_hlo": [f"{o['op']}:{o['bytes']}" for o in traffic["ops"]],
        "host_cores": os.cpu_count(),
        "scaling": args.scaling,
        "cards": cards,
        "procs": procs,
        "layout": [str(r.device) for r in mesh.ranks] if procs == 1
        else [f"process {q}, a {home.type} rank" for q in range(procs)],
        "channels": c_total,
        "samples": t_total,
        "ms_cuda_events": ms,
        "halo_edges": edges,
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_point(args, n_channel: int, n_time: int, attempts: int = 3
                ) -> dict:
    """One mesh point as ``n_channel · n_time`` processes, a card (or a
    CPU rank) each; the record process 0 printed last.  The coordinator's
    port is a free one the OS gave this process; where another process
    took it meanwhile (``EADDRINUSE`` in process 0), the point starts again
    on a new one, at most ``attempts`` times."""
    nd = n_channel * n_time
    for attempt in range(attempts):
        port = _free_port()
        procs = []
        for pid in range(nd):
            env = dict(os.environ)
            env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                       JAX_NUM_PROCESSES=str(nd), JAX_PROCESS_ID=str(pid))
            if not args.cpu:
                env["CUDA_VISIBLE_DEVICES"] = str(pid)
            if args.hosts:
                from scripts.halo_ipc_worker_torch import NET_ENV
                env.update(NET_ENV)
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   f"{n_channel}x{n_time}"] + args.forward
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
        codes = [p.returncode for p in procs]
        if not any(codes):
            return json.loads(outs[0][0].strip().splitlines()[-1])
        if "EADDRINUSE" not in outs[0][1] or attempt + 1 == attempts:
            for pid, (_, err) in enumerate(outs):
                sys.stderr.write(f"--- worker {pid} ---\n{err[-3000:]}")
            raise RuntimeError(f"point {n_channel}x{n_time}: workers "
                               f"exited {codes}")
        print(f"point {n_channel}x{n_time}: port {port} was taken, "
              f"starting again", file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scaling", default="weak", choices=["weak", "strong"])
    p.add_argument("--cpu", action="store_true",
                   help="CPU ranks at a tiny size (a functional run)")
    p.add_argument("--procs", action="store_true",
                   help="one process a rank, a card each")
    p.add_argument("--meshes", default=None,
                   help="comma-separated CxT mesh points (default: the "
                        "kind's)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--fir-method", default="fused",
                   choices=["fused", "block2", "ols"])
    p.add_argument("--frames", default="local", choices=["local", "a2a"])
    p.add_argument("--halo", default="ppermute",
                   choices=["ppermute", "rdma", "rdma_fused"])
    p.add_argument("--hosts", action="store_true",
                   help="with --procs: each process a host of its own")
    p.add_argument("--metrics", default=None,
                   help="append JSONL events to this path")
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.forward = [a for a in (argv if argv is not None else sys.argv[1:])
                    if a != "--procs"]

    import torch

    from llzlab_tpu_torch.runtime import distributed as rd
    from llzlab_tpu_torch.utils.metrics import MetricsLogger, config_hash

    cfg = dict(TINY if args.cpu else CARD)

    if args.worker:  # one process of a --procs point
        nc, nt = parse_meshes(args.worker)[0]
        if args.hosts:
            from scripts.halo_ipc_worker_torch import as_own_host
            as_own_host()
        rd.init_distributed(device="cpu" if args.cpu else "cuda")
        import torch.distributed as dist
        try:
            rec = run_point(args, cfg, nc, nt, dist.get_world_size())
            if rd.process_index() == 0:
                print(json.dumps(rec), flush=True)
        finally:
            dist.destroy_process_group()
        return 0

    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: run with --cpu for a functional run",
              file=sys.stderr)
        return 1
    if args.cpu:
        kind, smi = "cpu", None
    else:
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    shapes = parse_meshes(args.meshes or MESHES[args.scaling])
    log = MetricsLogger(path=args.metrics, echo=True)
    print(f"backend={'cpu' if args.cpu else 'cuda'} kind={kind} "
          f"cards={0 if args.cpu else torch.cuda.device_count()} "
          f"nvidia-smi={smi}", file=sys.stderr, flush=True)
    run_cfg = dict(cfg, fir_method=args.fir_method, frames=args.frames,
                   procs=args.procs)
    if args.halo != "ppermute":  # the hash of the ppermute runs stays
        run_cfg["halo"] = args.halo
    if args.hosts:
        run_cfg["hosts"] = True
    points, base = [], None
    for nc, nt in shapes:
        rec = (spawn_point(args, nc, nt) if args.procs
               else run_point(args, cfg, nc, nt, 1))
        if base is None:
            base = rec["msps_per_chip"]
        rec["weak_scaling_eff"] = rec["msps_per_chip"] / base
        rec["config"] = config_hash(run_cfg)
        rec["card"] = smi
        points.append(rec)
        log.event("weak_scaling" if args.scaling == "weak"
                  else "strong_scaling", **rec)
        print(json.dumps(rec), flush=True)
    summary = {
        "metric": f"{args.scaling}-scaling efficiency, sharded channelizer "
                  f"(config 5; BASELINE.json:5 asks >=0.95, not claimed)",
        "backend": "cpu" if args.cpu else "cuda",
        "device": kind,
        "card": smi,
        "points": points,
        "final_efficiency": points[-1]["weak_scaling_eff"] if points
        else None,
        "config": run_cfg,
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

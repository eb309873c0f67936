#!/usr/bin/env python
"""Kernels B3 and B4 across processes: the worker processes of phase 12
of ``chip_smoke.py`` and of the card test of ``tests/test_torch_cuda.py``.

Three modes, each one process of a group that :func:`launch` starts on a
free loopback port:

* ``card``: every process on ``cuda:0``, joined over gloo (NCCL refuses
  two processes on one card), the 1-D mesh ``[P0, P0, P1, P1]`` (4 ranks
  dealt over the processes in equal runs).  Kernel B3
  (``left_halo_ring``) at ``(C, h)`` tails of ``(C, T_loc)`` ranks over
  three epochs, a new input and carry each, and kernel B4
  (``block2_fir_halo_fused``) at both precisions with a carry of a block;
  each process holds its ranks' outputs bitwise against the same four
  ranks in one process (built here, on the same card) and against the
  plain versions (B3 bitwise, B4 at the kernel floors), reads every error
  word, and times both, beside the same ranks in one process.
* ``cards``: a process a card (``CUDA_VISIBLE_DEVICES``), joined over
  NCCL, the 1-D mesh of one rank a process (``global_dsp_mesh(1, n)
  .row(0)``).  Config 5's channelizer at full width, fused ``rdma``,
  block2 ``rdma`` and block2 ``rdma_fused``: two super-blocks, each
  rank's spectra and each process's state as a fingerprint of their
  bytes (:func:`digest`), which the launcher holds against the same steps
  of one process's mesh over the same cards; the traffic a step notes;
  CUDA-event times of the step, of B3 at config 5's ``(1024, 2048)``
  tails and of B4 at 256 channels, the slowest process's.  On two
  processes also config 1 through ``fir_filter_tap_parallel``.
* ``hosts``: as ``cards``, but each process names itself a host of its
  own (:func:`as_own_host` replaces ``kernels.halo_ring.host_name``), so
  that every edge of the mesh is a ``NET`` edge (the tails through NCCL,
  the wait in the kernels), and the launcher starts the workers with
  ``NCCL_P2P_DISABLE=1`` and ``NCCL_SHM_DISABLE=1``, which leave NCCL its
  network transport (sockets, or InfiniBand where there is some), and
  with ``NCCL_DEBUG=INFO``: each result names the transports that NCCL's
  log shows (``nccl_transport``), and a peer-to-peer or shared-memory
  one raises.  The same paths and fingerprints as ``cards``; the
  ``ppermute`` steps go over the same transport.

Each process writes ``result_<process>.json`` into the output directory;
the launch counts of each path are counted from 0 just before it and read
just after.  Inputs are made on the card from seeds, the same in every
process and in the launcher's reference.

    python scripts/halo_ipc_worker_torch.py card 2 [--channels 1024 ...]
    python scripts/halo_ipc_worker_torch.py hosts 2   # two cards or more

runs a group from the command line and prints each process's result.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import re
import socket
import subprocess
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: config 5 (configs/channelizer_1024ch.json): channels and a rank's
#: samples; rdma_fused at 256 channels (B4's envelope)
CZ_CHANNELS, CZ_T_LOC, CZ_FUSED_CHANNELS = 1024, 327680, 256
#: the channelizer's kernel-halo paths: (fir_method, halo, channels)
CZ_PATHS = (("fused", "rdma", CZ_CHANNELS), ("block2", "rdma", CZ_CHANNELS),
            ("block2", "rdma_fused", CZ_FUSED_CHANNELS))
#: timed beside them, a process a card: the plain halos, and block2 at
#: rdma_fused's 256 channels with the other two halos
CZ_TIMED = (("fused", "ppermute", CZ_CHANNELS),
            ("block2", "ppermute", CZ_CHANNELS),
            ("block2", "rdma", CZ_FUSED_CHANNELS),
            ("block2", "ppermute", CZ_FUSED_CHANNELS))
#: B3's halo width on config 5's fused path (its 2-block history)
B3_H = 2048
#: the kernels' floors against their plain versions in float64
#: (chip_smoke.KERNEL_FLOOR_DB)
FLOOR_DB = {"highest": 130.0, "high": 75.0}
#: how long a group may take, process starts included
TIMEOUT_S = 600
#: the ``hosts`` mode's environment: NCCL without its peer-to-peer and
#: shared-memory transports, as between two machines (the launcher adds
#: ``NCCL_DEBUG=INFO``, whose log names the transport, on stdout)
NET_ENV = {"NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1"}
#: the connections that NCCL's log names ("... via NET/Socket/0")
_VIA = re.compile(r" via ((?:NET|P2P|SHM|CollNet)/[\w/]+)")


def as_own_host() -> str:
    """Name this process a host of its own for the halo kernels: every
    edge to another process becomes a ``NET`` edge.  Returns the name."""
    from llzlab_tpu_torch.kernels import halo_ring as hr

    name = f"{socket.gethostname()}/process{os.environ['JAX_PROCESS_ID']}"
    hr.host_name = lambda: name
    return name


def nccl_transports(log: str) -> list:
    """The transports of the connections that NCCL's log (``NCCL_DEBUG=
    INFO``) names, without their channel numbers."""
    return sorted({re.sub(r"/\d+(?=/|$)", "", m) for m in _VIA.findall(log)})


def digest(t) -> str:
    """A fingerprint of a tensor's bytes: its shape, dtype and two sums,
    modulo 2^64, of its 32-bit words times odd weights of their positions.
    Two tensors that differ in one word never share it; computed on the
    card in slices of 2^24 words."""
    import torch

    v = t.detach().contiguous().reshape(-1)
    if v.is_complex():
        v = torch.view_as_real(v).reshape(-1)
    words = v.view(torch.int32)
    sums = [0, 0]
    step = 1 << 24
    for a in range(0, words.numel(), step):
        w = words[a:a + step].to(torch.int64)
        pos = torch.arange(a, a + w.numel(), device=w.device,
                           dtype=torch.int64)
        for i, k in enumerate((0x9E3779B97F4A7C15 >> 1, 0xC2B2AE3D27D4EB4F
                               >> 1)):
            sums[i] = (sums[i] + int((w * (pos * k | 1)).sum())) % (1 << 64)
    return f"{tuple(t.shape)} {t.dtype} {sums[0]:016x}{sums[1]:016x}"


def rank_block(r: int, step: int, channels: int, t_loc: int, device):
    """Rank ``r``'s input of super-block ``step``, made on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1000 * step + r)
    return torch.randn((channels, t_loc), generator=gen, device=device)


def tap_inputs():
    """Config 1 (configs/fir_lowpass_1ch.json: 1 x 480 000,
    firwin(1024, 0.25, hamming)): the signal on the host and the taps."""
    from llzlab_tpu_torch.ops.fir import firwin

    x = np.random.default_rng(21).standard_normal((1, 480000)).astype(
        np.float32)
    return x, firwin(1024, 0.25, window="hamming")


def _launches():
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr

    return {"halo_ring": hr.left_halo_ring_cuda,
            "halo_fir_fused": hf.block2_fir_halo_fused_cuda}


def _counted(fn, across: str = "cross_process_launches"):
    """``fn()`` with the launch counts of B3 and B4 set to 0 before and
    read after: ``(result, {kernel: [launches, across processes]})``
    (``across``: the counter of the launches across, processes or
    hosts)."""
    wrappers = _launches()
    for w in wrappers.values():
        w.launches = 0
        setattr(w, across, 0)
    out = fn()
    return out, {k: [w.launches, getattr(w, across)]
                 for k, w in wrappers.items()}


def _slowest(value: float) -> float:
    """The largest of ``value`` over the processes."""
    import torch
    import torch.distributed as dist

    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def _event_ms(fn, iters: int, alone: bool = False) -> float:
    """CUDA-event ms of ``fn()`` on this process's card, median of
    ``iters`` after one warm-up, the slowest process's; the processes
    start together.  ``alone``: process 0 alone runs ``fn`` while the
    others wait (a mesh of its own, timed without their load)."""
    import torch
    import torch.distributed as dist

    run = not alone or dist.get_rank() == 0
    if run:
        fn()
        torch.cuda.synchronize()
    dist.barrier()
    ms = 0.0
    if run:
        pairs = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        ms = float(np.median([a.elapsed_time(b) for a, b in pairs]))
    return _slowest(ms)


def _on(mesh, fn):
    def run():
        mesh.fork()
        out = fn()
        mesh.join()
        return out
    return run


def _snr_db(ref, y) -> float:
    ref = ref.double()
    err = ref - y.double()
    return float(10 * np.log10(float((ref * ref).sum())
                               / max(float((err * err).sum()), 1e-300)))


def card_run(args) -> dict:
    """``card`` mode: B3 and B4 on ``[P0, P0, P1, P1]`` of ``cuda:0``."""
    import torch
    import torch.distributed as dist

    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.ops.fir import block2_block, firwin
    from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh

    procs = dist.get_world_size()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = DspMesh([dev] * 4, (TIME_AXIS,),
                   processes=[r * procs // 4 for r in range(4)])
    one = DspMesh([dev] * 4, (TIME_AXIS,))  # the same ranks in one process
    mine = [r for r in range(4) if mesh.local(r)]
    res = {"process": dist.get_rank(), "ranks": mine, "paths": {}}
    c, t, h = args.channels, args.t_loc, args.h

    def parts_of(step, channels):
        full = [rank_block(r, step, channels, t, dev) for r in range(4)]
        return [p if mesh.local(r) else None for r, p in enumerate(full)], \
            full

    # ---- B3, three epochs, a new input and carry each ------------------
    path = f"B3 ({c}, {h}) across {procs} processes of {dev}"
    launches = {"halo_ring": [0, 0], "halo_fir_fused": [0, 0]}
    for e in range(3):
        parts, full = parts_of(e, c)
        carry = rank_block(99, e, c, h, dev)
        got, counts = _counted(_on(mesh, lambda: hr.left_halo_ring(
            parts, h, mesh, first_shard_value=carry)))
        for k, v in counts.items():
            launches[k] = [a + b for a, b in zip(launches[k], v)]
        hr.check_exchanges(mesh)
        ref = _on(one, lambda: hr.left_halo_ring(
            full, h, one, first_shard_value=carry))()
        plain = _on(one, lambda: hr.left_halo_ring_plain(
            full, h, one, first_shard_value=carry))()
        torch.cuda.synchronize()
        for r in mine:
            if not torch.equal(got[r], ref[r]):
                raise RuntimeError(f"B3 epoch {e}: rank {r} != the same "
                                   f"ranks in one process")
            if not torch.equal(got[r], plain[r]):
                raise RuntimeError(f"B3 epoch {e}: rank {r} != the plain "
                                   f"version")
    res["paths"][path] = launches
    res["b3_ms"] = _event_ms(_on(mesh, lambda: hr.left_halo_ring(
        parts, h, mesh)), args.iters)
    hr.check_exchanges(mesh)
    res["b3_one_process_ms"] = _event_ms(_on(one, lambda: hr.left_halo_ring(
        full, h, one)), args.iters, alone=True)
    del parts, full

    # ---- B4 at both precisions, a carry of a block ----------------------
    taps = firwin(1024, 0.4, window="hamming")
    block = block2_block(len(taps))
    parts, full = parts_of(1, args.b4_channels)
    carry = rank_block(98, 1, args.b4_channels, block, dev)
    # float64 copies for the plain version, made before the mesh forks
    full64, carry64 = [p.double() for p in full], carry.double()
    res["b4_snr_db"], res["b4_ms"], res["b4_one_process_ms"] = {}, {}, {}
    for mode in ("highest", "high"):
        def b4():
            return _on(mesh, lambda: hf.block2_fir_halo_fused(
                parts, taps, mesh, first_shard_value=carry, mode=mode))()
        path = (f"B4 ({args.b4_channels}, {t}) a rank, {mode}, across "
                f"{procs} processes of {dev}")
        got, res["paths"][path] = _counted(b4)
        hr.check_exchanges(mesh)
        ref = _on(one, lambda: hf.block2_fir_halo_fused(
            full, taps, one, first_shard_value=carry, mode=mode))()
        plain = _on(one, lambda: hf.block2_fir_halo_fused_plain(
            full64, taps, one, first_shard_value=carry64, mode="highest"))()
        torch.cuda.synchronize()
        snr = min(_snr_db(plain[r], got[r]) for r in mine)
        for r in mine:
            if not torch.equal(got[r], ref[r]):
                raise RuntimeError(f"B4 {mode}: rank {r} != the same ranks "
                                   f"in one process")
        if not snr >= FLOOR_DB[mode]:
            raise RuntimeError(f"B4 {mode}: {snr:.1f} dB against the plain "
                               f"version in float64 (floor "
                               f"{FLOOR_DB[mode]})")
        res["b4_snr_db"][mode] = snr
        del got, ref, plain
        res["b4_ms"][mode] = _event_ms(b4, args.iters)
        hr.check_exchanges(mesh)
        res["b4_one_process_ms"][mode] = _event_ms(_on(
            one, lambda: hf.block2_fir_halo_fused(
                full, taps, one, first_shard_value=carry, mode=mode)),
            args.iters, alone=True)
    hr.check_exchanges(mesh)
    hr.check_exchanges(one)

    # ---- a late sender: the receiving process raises, then all is well --
    del parts, full, full64
    parts, full = parts_of(2, c)
    edge = hr.mesh_plan(mesh)[1].index(hr.PROCESS) + 1  # r - 1 -> r
    limit, hr.WAIT_LIMIT_S = hr.WAIT_LIMIT_S, 0.2
    try:
        if mesh.local(edge - 1):
            with mesh.on(edge - 1):
                torch.cuda._sleep(int(2e9))  # about a second late
        _on(mesh, lambda: hr.left_halo_ring(parts, h, mesh))()
        try:
            hr.check_exchanges(mesh)
            res["late_sender"] = "no error"
        except RuntimeError as exc:
            res["late_sender"] = str(exc)
    finally:
        hr.WAIT_LIMIT_S = limit
    got = _on(mesh, lambda: hr.left_halo_ring(parts, h, mesh))()
    hr.check_exchanges(mesh)
    plain = _on(one, lambda: hr.left_halo_ring_plain(full, h, one))()
    torch.cuda.synchronize()
    if not all(torch.equal(got[r], plain[r]) for r in mine):
        raise RuntimeError("B3 after a late sender != the plain version")
    res["late_receiver"] = edge
    return res


def cz_steps(ch, mesh, channels, t_loc, halo, steps: int = 2):
    """``steps`` super-blocks of config 5's sharded step on ``mesh`` (1-D),
    each rank's input from :func:`rank_block`; per step the digests of
    this process's ranks' spectra, then those of the state."""
    import torch

    step = ch.sharded_step(mesh, halo=halo)
    home = mesh.ranks[mesh.home].device
    st = ch.init_state(channels, device=home)
    got = {}
    for i in range(steps):
        parts = [mesh.run(r, lambda r, rank: rank_block(
            r, i, channels, t_loc, rank.device), r, mesh.ranks[r])
            for r in range(len(mesh))]
        spec, st = step(parts, st)
        for r, s in enumerate(spec):
            if s is not None:
                got[f"step{i} rank{r}"] = digest(s)
        del spec, parts
    for k, v in enumerate(st):
        got[f"state{k}"] = digest(v)
    torch.cuda.synchronize()
    return got


def cards_run(args) -> dict:
    """``cards`` and ``hosts`` modes: config 5's kernel-halo steps, B3, B4
    and the tap-parallel FIR on a process a card."""
    import torch
    import torch.distributed as dist

    from llzlab_tpu_torch.chains.channelizer import Channelizer
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.parallel.tap_tp import fir_filter_tap_parallel
    from llzlab_tpu_torch.runtime import distributed as rd
    from llzlab_tpu_torch.utils.profiling import collective_traffic
    from scripts.pod_scaling_torch import comm_bytes

    procs = dist.get_world_size()
    gmesh = rd.global_dsp_mesh(1, procs, ranks_per_process=1)
    mesh = gmesh.row(0)
    me = dist.get_rank()
    dev = mesh.ranks[me].device
    res = {"process": me, "device": torch.cuda.get_device_name(dev),
           "kinds": hr.mesh_plan(mesh)[1], "paths": {}, "digests": {},
           "traffic": {}, "step_ms": {}}
    across = ("cross_host_launches" if args.mode == "hosts"
              else "cross_process_launches")
    t_loc = args.t_loc
    for method, halo, channels in CZ_PATHS + CZ_TIMED:
        checked = (method, halo, channels) in CZ_PATHS
        channels = min(channels, args.channels)
        ch = Channelizer(fir_method=method, device=dev)
        path = f"config 5 {method} {halo} {channels}ch 1x{procs} processes"
        if path in res["step_ms"]:
            continue
        if checked:
            res["digests"][path], res["paths"][path] = _counted(
                lambda: cz_steps(ch, mesh, channels, t_loc, halo), across)
            hr.check_exchanges(mesh)
        parts = [mesh.run(r, lambda r, rank: rank_block(
            r, 0, channels, t_loc, rank.device), r, mesh.ranks[r])
            for r in range(procs)]
        step = ch.sharded_step(mesh, halo=halo)
        st0 = ch.init_state(channels, device=dev)
        moved = collective_traffic(lambda: step(parts, st0))["total_bytes"]
        model = comm_bytes(ch, 1, procs, channels, procs=procs)
        res["traffic"][path] = [moved, model]
        res["step_ms"][path] = _event_ms(lambda: step(parts, st0),
                                         args.iters)
        hr.check_exchanges(mesh)
        del parts, step
        torch.cuda.empty_cache()
    # ---- B3 and B4 alone, timed ----------------------------------------
    ch = Channelizer(fir_method="block2", device=dev)
    x = {r: rank_block(r, 0, args.channels, t_loc, dev)
         for r in range(procs) if mesh.local(r)}
    parts = [x.get(r) for r in range(procs)]
    res["b3_ms"] = _event_ms(_on(mesh, lambda: hr.left_halo_ring(
        parts, args.h, mesh)), 10)
    hr.check_exchanges(mesh)
    parts = [None if p is None else p[:args.b4_channels].contiguous()
             for p in parts]
    res["b4_ms"] = _event_ms(_on(mesh, lambda: hf.block2_fir_halo_fused(
        parts, ch.fir_taps, mesh, mode="highest")), 10)
    hr.check_exchanges(mesh)
    del x, parts
    torch.cuda.empty_cache()
    if procs == 2:  # ---- config 1 through the tap-parallel FIR ---------
        xs, taps = tap_inputs()
        path = f"config 1 fir_filter_tap_parallel 1x{procs} processes"
        got, res["paths"][path] = _counted(lambda: fir_filter_tap_parallel(
            torch.from_numpy(xs), taps, gmesh), across)
        res["digests"][path] = {f"rank{r}": digest(v)
                                for r, v in enumerate(got) if v is not None}
    return res


def worker(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["card", "cards", "hosts"])
    p.add_argument("out")
    p.add_argument("--channels", type=int, default=CZ_CHANNELS)
    p.add_argument("--t-loc", type=int, default=CZ_T_LOC)
    p.add_argument("--h", type=int, default=B3_H)
    p.add_argument("--b4-channels", type=int, default=CZ_FUSED_CHANNELS)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    os.environ["LLZ_MATMUL_PRECISION"] = "highest"

    import torch
    import torch.distributed as dist

    from llzlab_tpu_torch.runtime import distributed as rd

    if args.mode == "hosts":
        as_own_host()
    rd.init_distributed(device="cpu" if args.mode == "card" else "cuda")
    try:
        t0 = time.perf_counter()
        res = (card_run if args.mode == "card" else cards_run)(args)
        res["seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        dist.barrier()  # no process frees halo state a peer still uses
        with open(os.path.join(args.out, f"result_{res['process']}.json"),
                  "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(mode: str, procs: int, out: str, extra=(), attempts: int = 3
           ) -> list:
    """Start ``procs`` worker processes of ``mode`` on a free loopback port
    (``cards`` and ``hosts``: process ``p`` sees card ``p`` alone;
    ``hosts`` with :data:`NET_ENV`), wait for them, and return their
    results in process order (``hosts``: each with the transports of its
    NCCL log, ``nccl_transport``).  Raises with the workers' output if one
    fails, or if a ``hosts`` worker's NCCL connected otherwise than through
    its network transport; where another process took the port meanwhile
    (``EADDRINUSE``), starts again on a new one."""
    os.makedirs(out, exist_ok=True)
    for attempt in range(attempts):
        port = _free_port()
        ps = []
        for pid in range(procs):
            env = dict(os.environ)
            env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                       JAX_NUM_PROCESSES=str(procs), JAX_PROCESS_ID=str(pid),
                       PYTHONPATH=REPO + os.pathsep
                       + env.get("PYTHONPATH", ""))
            if mode in ("cards", "hosts"):
                env["CUDA_VISIBLE_DEVICES"] = str(pid)
            if mode == "hosts":
                env.update(NET_ENV, NCCL_DEBUG="INFO")
            ps.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, out,
                 *extra], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=REPO))
        try:
            logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in ps]
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in ps]
        if not any(codes):
            results = []
            for pid in range(procs):
                with open(os.path.join(out, f"result_{pid}.json")) as f:
                    results.append(json.load(f))
                if mode == "hosts":
                    via = nccl_transports(logs[pid])
                    if not via or any(not v.startswith("NET/") for v in via):
                        raise RuntimeError(
                            f"hosts worker {pid}: NCCL connected via {via}, "
                            f"not through its network transport alone:\n"
                            f"{logs[pid][-4000:]}")
                    results[-1]["nccl_transport"] = via
            return results
        if not any("EADDRINUSE" in log for log in logs) or \
                attempt + 1 == attempts:
            raise RuntimeError(
                f"{mode} workers exited {codes}:\n" + "\n".join(
                    f"--- process {pid} ---\n{log[-4000:]}"
                    for pid, log in enumerate(logs)))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "JAX_PROCESS_ID" in os.environ:
        return worker(argv)
    mode, procs, rest = argv[0], int(argv[1]), argv[2:]
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for res in launch(mode, procs, tmp, rest):
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

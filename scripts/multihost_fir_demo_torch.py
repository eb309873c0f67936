#!/usr/bin/env python
"""Multi-process demo of the PyTorch port, with a fault and a restart.

Orchestrator mode (no JAX_PROCESS_ID in the environment):

    python scripts/multihost_fir_demo_torch.py --procs 2 --ranks-per-proc 2
    python scripts/multihost_fir_demo_torch.py --procs 2 --inject-fault 1

starts ``--procs`` worker processes on this machine, joined over gloo on
loopback (CPU ranks standing in for hosts), that form one ``(1, procs ×
ranks)`` mesh (``runtime.distributed.global_dsp_mesh``).  The workers
stream ``fir_filter_sharded`` super-block by super-block, the halo and the
state tail crossing the process boundary, with a heartbeat on each
block's output, and process 0 checkpoints the state after each block
(``utils/checkpoint.py``).  With ``--inject-fault k`` worker 1 dies at
block ``k``; the orchestrator sees the failed run, stops the other
workers, and starts them again with ``--resume``, which continues from
the checkpoint.  The output must equal unsharded streaming at ``T_loc``
granularity bit for bit.  Then ``spectral_gain_sharded`` runs over the
same mesh (its lookahead and overlap-add tail cross the boundary) and is
held against the unsharded STFT → gain → iSTFT on the interior.

The launcher sets the JAX package's variables (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), which ``init_distributed``
reads; the worker mode is chosen by ``JAX_PROCESS_ID``.  Each worker
writes its ranks' outputs into ``--workdir``.
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

C, T_LOC, N_BLOCKS, NTAPS = 4, 3072, 4, 512
N_FFT, HOP = 2048, 512
#: the spectral chain against the unsharded one, away from the stream's
#: last n_fft samples (the port's floor, tests/test_torch_spectral_sp.py)
SPECTRAL_DB = 130.0


def _signal(n_ranks: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.standard_normal((C, T_LOC * n_ranks * N_BLOCKS)).astype(
        np.float32)


def _gain() -> np.ndarray:
    return np.linspace(1.0, 0.25, N_FFT // 2 + 1).astype(np.float32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def orchestrate(args) -> int:
    workdir = args.workdir or tempfile.mkdtemp(prefix="mh_demo_torch_")
    os.makedirs(workdir, exist_ok=True)
    n_ranks = args.procs * args.ranks_per_proc

    def launch(resume: bool):
        port = _free_port()
        procs = []
        for pid in range(args.procs):
            env = dict(os.environ)
            env.update(
                JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                JAX_NUM_PROCESSES=str(args.procs),
                JAX_PROCESS_ID=str(pid),
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
            )
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--workdir", workdir, "--procs", str(args.procs),
                   "--ranks-per-proc", str(args.ranks_per_proc)]
            if args.inject_fault is not None and not resume:
                cmd += ["--inject-fault", str(args.inject_fault)]
            if resume:
                cmd += ["--resume"]
            procs.append(subprocess.Popen(cmd, env=env))
        # a worker that fails leaves its peers waiting on it: stop them
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(2.0)
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.05)
        return [p.wait() for p in procs]

    codes = launch(resume=False)
    if args.inject_fault is not None:
        if not any(c != 0 for c in codes):
            print("FAULT INJECTION FAILED TO FIRE", file=sys.stderr)
            return 1
        print("[orchestrator] fault observed, relaunching with --resume",
              flush=True)
        codes = launch(resume=True)
    if any(c != 0 for c in codes):
        print(f"workers failed: {codes}", file=sys.stderr)
        return 1

    import torch

    from llzlab_tpu_torch.ops.fir import fir_filter, firwin
    from llzlab_tpu_torch.ops.spectral import istft, stft

    x_all = _signal(n_ranks)
    blk = T_LOC * n_ranks
    out = np.concatenate([
        np.load(os.path.join(workdir, f"y_b{bi}_r{r}.npy"))
        for bi in range(N_BLOCKS) for r in range(n_ranks)], axis=-1)
    taps = firwin(NTAPS, 0.3)
    zi, parts = None, []
    for j in range(N_BLOCKS * n_ranks):  # unsharded, at T_loc granularity
        y, zi = fir_filter(torch.from_numpy(
            x_all[:, j * T_LOC:(j + 1) * T_LOC]), taps, method="ols",
            zi=zi, return_zf=True)
        parts.append(y.numpy())
    ok = np.array_equal(out, np.concatenate(parts, axis=-1))
    print(f"[orchestrator] multihost == streaming-golden: {ok}", flush=True)

    y_sp = np.concatenate([np.load(os.path.join(workdir, f"sp_r{r}.npy"))
                           for r in range(n_ranks)], axis=-1)
    x0 = torch.from_numpy(x_all[:, :blk])
    ref = istft(stft(x0, n_fft=N_FFT, hop=HOP) * torch.from_numpy(_gain()),
                n_fft=N_FFT, hop=HOP, length=blk).numpy()
    cut = blk - N_FFT  # the last frames see zero lookahead past the end
    err = ref[:, :cut].astype(np.float64) - y_sp[:, :cut]
    snr = 10 * np.log10(np.sum(ref[:, :cut].astype(np.float64) ** 2)
                        / max(np.sum(err ** 2), 1e-300))
    sp_ok = snr >= SPECTRAL_DB
    print(f"[orchestrator] spectral sharded == unsharded: {sp_ok} "
          f"({snr:.1f} dB, floor {SPECTRAL_DB})", flush=True)
    return 0 if ok and sp_ok else 1


def worker(args) -> int:
    import torch
    import torch.distributed as dist

    from llzlab_tpu_torch.ops.fir import fir_state_len, firwin
    from llzlab_tpu_torch.parallel.mesh import TIME_MAJOR
    from llzlab_tpu_torch.parallel.sharded_ops import fir_filter_sharded
    from llzlab_tpu_torch.parallel.spectral_sp import spectral_gain_sharded
    from llzlab_tpu_torch.runtime.distributed import (global_dsp_mesh,
                                                      init_distributed,
                                                      make_global_array,
                                                      process_index)
    from llzlab_tpu_torch.runtime.health import Heartbeat
    from llzlab_tpu_torch.utils.checkpoint import load_state, save_state

    init_distributed(device="cpu")
    me = process_index()
    mesh = global_dsp_mesh(ranks_per_process=args.ranks_per_proc)
    n_ranks = len(mesh)
    taps = firwin(NTAPS, 0.3)
    blk = T_LOC * n_ranks
    x_all = _signal(n_ranks)
    ck = os.path.join(args.workdir, "state.npz")
    state = torch.zeros((C, fir_state_len(NTAPS)), dtype=torch.float32)
    start = 0
    if args.resume and os.path.exists(ck):
        (state,), start, _ = load_state(ck, like=(state,))
        if me == 0:
            print(f"[worker0] resumed at block {start}", file=sys.stderr)
    beat = Heartbeat(mesh, every=1)
    for bi in range(start, N_BLOCKS):
        if (args.inject_fault is not None and bi == args.inject_fault
                and me == 1 and not args.resume):
            print("[worker1] injected fault: dying", file=sys.stderr)
            sys.stderr.flush()
            os._exit(17)
        x = make_global_array(
            (C, blk), mesh, TIME_MAJOR,
            lambda idx, bi=bi: x_all[:, bi * blk:(bi + 1) * blk][idx])
        y, state = fir_filter_sharded(x, taps, mesh, state=state,
                                      return_state=True)
        beat.tick(y)
        mesh.map(lambda v, r: np.save(os.path.join(
            args.workdir, f"y_b{bi}_r{r}.npy"), v.numpy()), y, range(n_ranks))
        if me == 0:
            save_state(ck, (state,), block_index=bi + 1)

    xs = make_global_array((C, blk), mesh, TIME_MAJOR,
                           lambda idx: x_all[:, :blk][idx])
    y_sp = spectral_gain_sharded(xs, _gain(), mesh, n_fft=N_FFT, hop=HOP)
    mesh.map(lambda v, r: np.save(os.path.join(args.workdir, f"sp_r{r}.npy"),
                                  v.numpy()), y_sp, range(n_ranks))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--ranks-per-proc", type=int, default=2)
    p.add_argument("--inject-fault", type=int, default=None,
                   help="block index at which worker 1 dies")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--workdir", default=None)
    args = p.parse_args()
    if os.environ.get("JAX_PROCESS_ID") is None:
        return orchestrate(args)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())

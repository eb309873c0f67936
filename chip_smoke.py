#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llzlab_tpu_torch``) on one GPU.

Drives the port's main paths through the hand-written CUDA kernels and
checks them:

1. device: the GPU's name and power limit; all four kernels and the IIR
   scan kernel built with nvcc, in parallel;
2. each kernel against its plain PyTorch version on the card: B1 (fused
   FIR→resample) and B2 (block2 FIR) at a small shape, at the headline
   shape and at the shapes one rank of the channelizer gives them (1024 and
   256 channels of 327 680 samples, the 0.4 taps), in both precision modes;
   B1 streamed as 1 + 2 and 2 + 1 programs, and B2 as 1 + 2 and 2 + 1
   stretches of blocks, bitwise equal to one shot (the block grids
   differ); B3 (halo ring) bitwise at the channelizer's halo
   widths on a 4-rank time mesh, one launch per exchange, also with a
   rank's stream held back; B4 (halo-fused FIR) against its plain version
   and bitwise against B2 on the unsharded stream, over three epochs; a
   B4 receive whose sender is late must raise, from ``check_exchanges``
   and from the next ``rdma_fused`` sharded step;
3. the headline chain (64 channels, ``firwin(1024, 0.25)`` into 147/160
   with 64 taps per phase, 245 760 samples per block):
   ``Chain([FusedFirResampleStage])`` streams through B1 (bit-exact
   against one shot, SNR against a scipy float64 golden), then the unfused
   chain through B2, each timed over 20 blocks back to back;
4. the channelizer at full width (``configs/channelizer_1024ch.json``: 1024
   channels, 1024-tap 0.4 FIR, 147/160, 2048-point frames) on a 4-rank time
   mesh of 327 680 samples per rank: ``step`` (B1), ``sharded_step`` with
   ``halo="rdma"`` and ``"ppermute"`` for ``fir_method="fused"`` (B3 + B1)
   and ``"block2"`` (B3 + B2), and ``halo="rdma_fused"`` at 256 channels
   (B4 + B3), in both precision modes; rdma equals ppermute bitwise,
   sharded equals unsharded streaming, 8 channels agree with scipy
   float64, a second super-block carries the state; the launch counts of
   each path show its kernels ran;
5. CUDA-event times of each kernel, its plain version and one library call
   for the same function, beside the least time the card could take and
   the time the previous version of the kernel took, and of one sharded
   step per FIR method, halo mode and precision mode; the blocks of B2 and
   B4 that one SM holds, from the occupancy API;
6. configs 1 and 2 at their published size, each from its file in
   ``configs/``: config 1 (1 x 480 000, ``firwin(1024, 0.25, hamming)``)
   through ``Chain([FIRStage(method="auto")])``, one B2 launch on the row a
   call, streamed in the ``fir`` tool's blocks at ``highest`` and ``high``
   (bitwise one shot, the one-row launch, the launch on the row padded to 8
   and the JAX package's low-channel fold; B2 against its plain version on
   the one-shot row, a tool block's row and the fold's rows; SNR against
   scipy float64), and the preset's ``ols``, ``direct`` and ``im2col``;
   config 2 (8 x 480 000 through 147/160, K = 64, beta = 8) streamed
   against ``upfirdn``, with ``decimate`` and the FFT ``resample`` against
   scipy; the ``fir`` and ``resample`` tools in process on WAVs of the same
   signals; CUDA-event times of the one-row launch, the fold, the other
   engines and config 2's step, each beside its bound, and the host's time
   per ``FIRStage.apply``;
7. config 4 at its published size (``configs/stft_gain_256ch.json``: 256 x
   480 000, 2048-point frames, hop 512, periodic Hann) through
   ``SpectralGainStage`` with each of its three engines and the ``stft``
   tool's gain (-6 dB, a notch over 1-2 kHz): one shot and streamed in the
   tool's blocks (95 744), streamed == one shot at the JAX package's
   floors, 8 channels against a float64 WOLA computed here with numpy,
   ``istft(gain * stft(x))`` against the stage; ``"auto"`` against the
   fastest engine; the ``stft`` tool file to file on a WAV of the same
   signal; the ``channelizer`` tool (``--fir-method ols``, 2048-point
   frames) with 1024 channels on one rank, and with 256 channels on one
   rank and on 4 ranks of ``cuda:0``, those spectra against each other and
   each against ``Channelizer.step``; ``fir_filter(method="block2")`` at
   3001 taps, beyond B2's envelope, as tensor code with no launch; B2 on
   65 544 rows at both precisions, bitwise the launches of at most 65 535
   rows; CUDA-event times of each engine per tool block and one shot,
   beside the host's enqueue time and the bound, and both tools' rates;
8. config 3 at its published size (``configs/iir_eq_64ch.json``: 64 x
   480 000, the 8-section peaking EQ, scan blocks of 4096) through
   ``Chain([SOSStage])`` in one shot and streamed in the ``iir`` tool's
   blocks (94 208), and split three ways at other multiples of 4096, all
   bitwise equal, states too; 8 channels against scipy float64
   ``sosfilt`` for the scan engine and ``sosfilt_matmul``; the engines
   ``sosfilt_auto`` resolves (``min_snr_db=80``, ``bit_exact_carry``)
   checked against the packaged calibration artifact of the card, and
   its output bitwise the chosen engine's; the ``iir`` tool file to file
   on a WAV of the same signal, bitwise the streamed stage; the device
   memory a captured graph of ``sosfilt_matmul`` holds at the tool block
   (a one shot runs eagerly and captures none), given back by
   ``clear_graphs``; for both engines per tool block and one shot the
   CUDA-event time, the host's enqueue time, the device kernels and copies
   per call and the idle share under ``torch.profiler``, beside the
   bounds.  The scan engine's every call on the card is one launch of the
   scan kernel ``sos_scan`` (which replaces no TPU kernel: the JAX
   package's scan is ``lax`` code): its launches on the stage, the
   ``sosfilt_auto`` calls and the tool equal their ``sosfilt`` calls,
   counted before the kernel is timed alone; the four FIR kernels' stay
   0.  Alone, with CUDA events, at 64 x 4096 (a scan block), 64, 8 and 1
   x 480 000, and 64 x 480 000 in blocks of 16 384 (the wide variant),
   beside its bound (8 B a sample at the card's bandwidth) and beside the
   tensor cascade on the card (``ops.iir._cascade``), bitwise equal to
   it; the ``kernels`` line carries it as ``sos_scan``;
9. the remaining ops on the card at the BASELINE configs' widths (10 s at
   48 kHz), inputs made on the card from a seed: config 4's 256 channels
   through ``spectrogram`` (2048, hop 512, Hann), ``welch``, ``csd``,
   ``coherence`` (``nperseg`` 2048, 50 %) and ``periodogram``; config 3's
   64 through ``hilbert``, ``analytic_envelope``, ``detrend``,
   ``savgol_filter`` (101, 3), ``medfilt`` (5), ``wiener`` (5),
   ``fftconvolve``, ``correlate``, ``compat.convolve`` (and its direct
   path on one row) and ``oaconvolve`` with config 1's 1024 taps,
   ``zoom_fft`` (900-1100 Hz, m = 4096) and ``czt`` on one row; config 2's
   8 through ``mdct`` / ``imdct`` at N = 960 and the type-2 DCT / DST and
   their inverses on its coefficients, and ``upfirdn`` at 147/160 on one
   second (the one cut: the whole file needs a 2^27-point FFT a row);
   ``lombscargle`` at 4096 x 20 000; ``find_peaks``, the responses, the
   designers and conversions once on the host.  Each output lies on the
   card and is held against scipy / numpy float64 on 4 channels at the JAX
   package's floors, then timed with CUDA events beside its bound;
   ``StageTimer`` and ``roofline_report`` around the first ``welch``.  No
   hand kernel lies on this path: the launch counts of all four stay 0;
10. the sharded modules (``parallel/``, ``runtime/``) on ranks of the
   card: the channelizer on a (2, 2) ``(channel, time)`` mesh (fused through
   B1, block2 through B2, both precisions, two super-blocks against
   unsharded streaming, states bitwise), ``halo_overlap`` for both methods
   with ``ppermute`` and ``rdma`` (B3) against the exact step,
   ``frames="a2a"`` at 1024 channels (B1 + B3) and with ``rdma_fused`` at
   256 (B4 + B3) at per-rank lengths whose frames straddle the ranks,
   against the unsharded one-shot step, and the ``channelizer`` tool on a
   (2, 2) mesh; ``fft_frames_sharded`` against numpy float64; config 1
   through ``fir_filter_sharded`` (ols, and block2 through B2) streamed in
   two super-blocks bitwise unsharded streaming, and
   ``fir_filter_tap_parallel``; the headline's 64 channels through
   ``fir_filter_sharded(block2)`` on (2, 2); config 2 through
   ``resample_sharded``; config 3 through ``sosfilt_sharded`` on (1, 4) and
   (2, 2) against ``sosfilt``, streamed bitwise one call at the same
   ``T_loc``; ``stage_pipeline`` of 4 stages bitwise the serial
   composition; config 4 through ``spectral_gain_sharded`` (both engines,
   479 232 samples, the one cut); the heartbeat, with a NaN payload; and
   a NCCL process group of one (the global mesh, a heartbeat through
   ``all_reduce``, a channelizer step bitwise the same step on a local
   mesh).  Per path: the launch counts (each kernel nonzero exactly where
   the path meets it), the CUDA-event ms of the sharded call and of its
   unsharded counterpart, ``collective_traffic``'s bytes equal to the
   analytic model, and for ``halo_overlap`` and the pipeline the
   profiler's device time summed over streams against the event time;
11. several cards (``multicard_paths``): on one card B3's protocol with
   each rank launched alone, and B3 and B4 with every edge a ``NET`` edge
   (``_net=True``: the halo through a device copy on a transfer stream,
   the kernels' receive half alone), bitwise the ranks' normal launch; on
   two or more config 5 over 1-D meshes of 2 and 4 cards and (2, 2) /
   (4, 1), every mode bitwise the same ranks on one card, and every kind
   of cross-card edge of B3 and B4 once more in a process under
   ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``, bitwise
   (``--only-multicard`` runs phases 1 and 11 alone);
12. across processes (``process_paths``, workers of
   ``scripts/halo_ipc_worker_torch.py``): B3 and B4 between two processes
   of one card through CUDA IPC, bitwise the same ranks in one process;
   with two or more cards config 5's ``rdma`` / ``rdma_fused`` steps on 2
   and 4 processes a card, bitwise one process's mesh over the same
   cards, and the tap-parallel FIR on 2; then all of it again with each
   process a host of its own (``NET`` edges: the tails through NCCL held
   to its network transport) (``--only-processes`` runs phases 1 and 12
   alone).

Every phase raises on failure.  The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
A kernel's ``launches`` there sums the main paths it runs on, each counted
from 0 over one run (B2: the channelizer at ``high``, config 1 in each
mode and the ``fir`` tool); ``launches_by_path`` gives each count (a
path of phase 12 sums its worker processes'), and B3 and B4 carry
``ms_across_processes``, ``ms_across_hosts`` (None with one card) and
``ms_net_edges_one_card``.
Needs one CUDA GPU; exits non-zero, printing no result, without one.

    python3 chip_smoke.py
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

NTAPS, CUTOFF, UP, DOWN, K = 1024, 0.25, 147, 160, 64
CHANNELS, BLOCK_T, NBLOCKS = 64, 245760, 2
#: the channelizer of configs/channelizer_1024ch.json on a 4-rank time mesh
CZ_CHANNELS, CZ_RANKS, CZ_FUSED_CHANNELS, CZ_GOLDEN_CHANNELS = 1024, 4, 256, 8
#: sharded against unsharded streaming, on the spectra
SHARDED_FLOOR_DB = 140.0
#: the card's published peaks: fp32 outside the tensor cores, bf16 on them,
#: HBM3
FP32_PEAK, BF16_PEAK, HBM_RATE = 67e12, 989e12, 3.35e12
#: what the previous versions of the kernels read in this script on an H100
#: 80GB HBM3 at 700 W (PERF.md), printed beside the new readings: B1 before
#: wgmma (fp32 FMA at "highest", mma.sync at "high"), B3 before its second
#: design, B2 and B4 before "high" moved to the tensor cores
PREVIOUS = {
    "fused_fir_resample ms": {"highest": 1.149, "high": 0.529},
    "fused_fir_resample SNR dB": {"highest": 134.1, "high": 104.2},
    "fused chain SNR dB": {"highest": 134.0, "high": 104.7},
    "halo_ring ms": {"highest": 0.231}, "halo_ring host ms": 0.289,
    "fused sharded step ms": 109.2,
    "block2_fir ms": {"highest": 0.900, "high": 1.977},
    "block2_fir SNR dB": {"highest": 136.7, "high": 106.2},
    "halo_fir_fused ms": {"highest": 19.012, "high": 43.727},
    # the chain before this change, timed as phase 3 times it
    "unfused chain ms": {"highest": 1.385, "high": 2.463},
}
KERNEL_NAMES = ("block2_fir", "fused_fir_resample", "halo_ring",
                "halo_fir_fused")
#: the IIR scan kernel (phase 8) and config 4's frame-map kernel (phase 7),
#: built with the others in phase 1
SCAN_KERNEL, WOLA_KERNEL = "sos_scan", "wola_gain"
SMALL = dict(ntaps=129, cutoff=0.2, up=3, down=4, k=8, channels=8)
#: the channelizer tool's runs in phase 7, the config's 2048-point frames
#: through the ols FIR: its 1024 channels on one rank (983 040 samples, the
#: step's block_multiple), then 256 channels of 4 x 983 040 on one rank and
#: on 4 ranks, the same input twice.  Channels are cut for the pair because
#: one rank holds about 31 GiB a 10^9 samples through the step (PERF.md)
CZ_TOOL_ARGS = ["--fir-method", "ols", "--fft", "2048"]
CZ_TOOL_RUNS = (("--synth", "1024", "--seconds", "20.48"),
                ("--synth", "256", "--seconds", "81.92"),
                ("--synth", "256", "--seconds", "81.92", "--mesh-time", "4"))
#: config 4: streamed == one shot for the reference engine at every sample,
#: for the product engines on the interior; a float64 WOLA on the interior
#: (the JAX package's floors: tests/pipeline/test_chain.py
#: TestSpectralGainStreaming, tests/ops/test_golden_cpp.py)
STFT_STREAM_DB, STFT_INTERIOR_DB, STFT_GOLDEN_DB = 140.0, 120.0, 90.0
#: config 3 against scipy float64, min over channels: the scan engine at
#: the JAX package's floor (tests/ops/test_iir.py:64), the matrix-product
#: engine above it (tests/ops/test_iir_matmul.py:36)
IIR_SCAN_DB, IIR_MATMUL_DB = 120.0, 110.0
#: SNR floors of a kernel against its plain version run in float64
KERNEL_FLOOR_DB = {"highest": 130.0, "high": 75.0}
#: all-channel-min SNR floors of the chain against scipy float64
CHAIN_FLOOR_DB = {"highest": 110.0, "high": 80.0}
MODES = ("high", "highest")
#: phase 9: the BASELINE configs' signal widths (10 s at 48 kHz), by config
P9_SECONDS_RATE = (10.0, 48000)
P9_CHANNELS = {"config 4": 256, "config 3": 64, "config 2": 8}
#: channels of each phase-9 output held against float64 on the host
P9_HOST_CHANNELS = 4
#: the JAX package's floors against scipy / numpy float64: fftconvolve,
#: correlate and upfirdn (tests/ops/test_extras.py:25,42,
#: tests/ops/test_compat.py:162), hilbert (tests/ops/test_extras.py:152),
#: the spectral densities (:161,169), detrend, savgol, wiener and the CZT
#: (tests/ops/test_smooth_czt.py:25,42,63,70-87), the MDCT
#: (tests/ops/test_mdct.py:15); medfilt and the DCT by absolute error
#: (tests/ops/test_smooth_czt.py:55, tests/ops/test_dct.py:25)
P9_FLOOR_DB = {"conv": 110.0, "hilbert": 100.0, "psd": 90.0,
               "detrend": 120.0, "smooth": 100.0, "czt": 100.0,
               "mdct": 110.0}
P9_MEDFILT_ATOL, P9_DCT_ATOL = 1e-6, 2e-5
#: AAC's frame: divides 480 000 (1024 does not, and mdct raises there)
P9_MDCT_N = 960
#: upfirdn runs on this much of config 2's signal, the one cut of phase 9:
#: 147/160 zero-stuffs a 10 s row to 70.6 M samples, a 2^27-point FFT a row
P9_UPFIRDN_SECONDS = 1.0

#: phase 10: the channelizer's (channel, time) mesh, (2, 2) ranks of the
#: card: 1024 channels of 2 x 655 360 samples
P10_CZ_MESH = (2, 2)
#: frames="a2a": the per-rank lengths nearest 327 680 that are multiples
#: of block_multiple("a2a") and not of block_multiple("local"), so that
#: frames straddle the ranks (fused at 1024 channels, block2 at 256)
P10_A2A_T_LOC = {"fused": 307200, "block2": 322560}
#: the channelizer tool on a (2, 2) mesh: 64 channels, the shortest input
#: its 2048-point frames take on two time ranks (2 x 983 040 samples)
P10_CZ_TOOL = ("--synth", "64", "--seconds", "40.96", "--mesh-channel", "2",
               "--mesh-time", "2")
#: config 4 over (1, 4): the nearest length below 480 000 whose quarter is
#: a multiple of the hop (the one cut of phase 10)
P10_SPECTRAL_T = 479232
#: stage_pipeline's micro-block: 480 000 = 50 x 9 600
P10_MICRO_BLOCK = 9600
#: floors: frames="a2a" against the unsharded one-shot step, halo_overlap
#: against the exact step (tests/parallel/test_channelizer_sharded.py:194,
#: :303), the sharded IIR against sosfilt (tests/parallel/
#: test_sharded_ops.py:111), the sharded spectral chain's interior
#: against the unsharded one for both engines (tests/parallel/
#: test_spectral_sp.py:29), the tap-parallel FIR against fir_filter
#: (tests/parallel/test_tp_pp.py:20), fft_frames_sharded against numpy float64 (test_sharded_ops.py:178)
A2A_FLOOR_DB, OVERLAP_FLOOR_DB, IIR_SHARDED_FLOOR_DB = 110.0, 135.0, 135.0
SPECTRAL_SP_FLOOR_DB, TAP_FLOOR_DB, FFT_FRAMES_FLOOR_DB = 130.0, 120.0, 110.0


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def matmul_precision(mode: str):
    """``LLZ_MATMUL_PRECISION`` (what ops without a ``precision`` argument
    read) set to ``mode`` for the enclosed work, then back as it was."""
    before = os.environ.get("LLZ_MATMUL_PRECISION")
    os.environ["LLZ_MATMUL_PRECISION"] = mode
    try:
        yield
    finally:
        if before is None:
            del os.environ["LLZ_MATMUL_PRECISION"]
        else:
            os.environ["LLZ_MATMUL_PRECISION"] = before


def min_channel_snr_db(ref, y) -> float:
    """Least SNR over the channels (the first axis) of real or complex
    arrays."""
    cast = np.complex128 if np.iscomplexobj(ref) else np.float64
    ref = np.asarray(ref, cast)
    err = ref - np.asarray(y, cast)
    ref, err = ref.reshape(ref.shape[0], -1), err.reshape(err.shape[0], -1)
    return float(np.min(10.0 * np.log10(
        np.sum(np.abs(ref) ** 2, axis=-1) / np.sum(np.abs(err) ** 2,
                                                   axis=-1))))


def multicard_paths(dev, smi, wrappers):
    """Phase 11: the sharded channelizer on several cards of this machine.
    On one card: B3's send / wait protocol on ranks of the card each
    launched alone (no cross-card run).  On two or more: config 5 on 1-D
    meshes of 2 and 4 cards (one rank a card) and on (2, 2) and (4, 1),
    every mode; per path bitwise the same ranks on ``dev``, the floors of
    phase 10, launches by path (B3 and B4 across cards), CUDA-event ms of
    the step beside the same ranks on one card, and the bytes against the
    model; the tool's default mesh; B3 and B4 timed across cards.  Returns
    ``({kernel: {path: launches}}, {kernel: across-card ms})``.  Raises
    on any failure."""
    import tempfile

    import torch

    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.cli import channelizer as cz_cli
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.parallel.mesh import (CHANNEL_MAJOR, TIME_AXIS,
                                                DspMesh, gather,
                                                make_dsp_mesh, shard)
    from llzlab_tpu_torch.runtime.profiler import counters, profile_calls
    from llzlab_tpu_torch.utils.profiling import collective_traffic
    from scripts.pod_scaling_torch import comm_bytes

    B1, B2, B3, B4 = ("fused_fir_resample", "block2_fir", "halo_ring",
                      "halo_fir_fused")
    by_path = {name: {} for name in wrappers}
    across_ms = {}
    count = torch.cuda.device_count()
    gen = torch.Generator(device=dev).manual_seed(11)
    chans = {m: Channelizer(fir_method=m, device=dev)
             for m in ("fused", "block2")}
    t_loc = chans["fused"].block_multiple()

    def on_mesh(fn, m):
        def run():
            m.fork()
            out = fn()
            m.join()
            return out
        return run

    def fail(msg):
        raise RuntimeError(f"phase 11 {msg}")

    # ---- B3's protocol on one card ------------------------------------
    mesh1 = DspMesh([dev] * CZ_RANKS, (TIME_AXIS,))
    x = torch.randn((CZ_CHANNELS, CZ_RANKS * t_loc), generator=gen,
                    device=dev)
    parts1 = shard(x, mesh1)
    path = f"B3 protocol, {CZ_RANKS} ranks of {dev} each launched alone"
    for w in wrappers.values():
        w.launches = 0
    for h in (chans["block2"].h_rs, chans["block2"].h_fir,
              chans["fused"].h_fir):
        for carry in (None, torch.randn((CZ_CHANNELS, h), generator=gen,
                                        device=dev)):
            got = on_mesh(lambda: hr.left_halo_ring_cuda(
                parts1, h, mesh1, first_shard_value=carry, _per_rank=True),
                mesh1)()
            hr.check_exchanges(mesh1)
            plain = on_mesh(lambda: hr.left_halo_ring_plain(
                parts1, h, mesh1, first_shard_value=carry), mesh1)()
            torch.cuda.synchronize(dev)
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                fail(f"{path} h={h}: != plain version")
    got = {n: w.launches for n, w in wrappers.items()}
    if got[B3] != 6 * CZ_RANKS or sum(got.values()) != got[B3]:
        fail(f"{path}: launches {got}, expected {6 * CZ_RANKS} of B3 alone")
    by_path[B3][f"phase11 {path}"] = got[B3]
    log(f"[phase11] {path}: every edge through the send / wait protocol, "
        f"h = 63, 1024, 2048 with and without a carry, == plain version "
        f"bitwise, {got[B3]} launches (one card: not a cross-card run)")
    del got, plain

    # ---- the NET branch on one card: every edge through a transfer stream
    net_ms = net_edges_one_card(dev, smi, wrappers, x, parts1, mesh1, chans,
                                gen, by_path, fail)
    del parts1
    if count < 2:
        log(f"[phase11] one card visible ({count}): ran on one card, the "
            f"multi-card paths need two or more")
        del x
        torch.cuda.empty_cache()
        return by_path, across_ms, net_ms

    # ---- peer access: what PyTorch's copies leave, then made explicit ----
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.zeros(1, device=a).to(b)
    torch.zeros(1, device=b).to(a)
    rc = hr.enable_peer_access(a, b)
    log(f"[phase11] peer access {a} <-> {b} after PyTorch's copies between "
        f"them: cudaDeviceEnablePeerAccess returned "
        f"{['enabled now', 'already enabled'][rc[0] < 0]} / "
        f"{['enabled now', 'already enabled'][rc[1] < 0]}")

    # ---- the cross-card edges under PyTorch's expandable segments --------
    t0 = time.perf_counter()
    want = cross_card_digests(dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "digests.json")
        env = dict(os.environ,
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--cross-card-digests", out], env=env, capture_output=True,
            text=True, timeout=600, cwd=os.path.dirname(
                os.path.abspath(__file__)))
        if proc.returncode:
            fail(f"under expandable_segments: exit {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(out) as f:
            got = json.load(f)
    if got != want:
        fail(f"under expandable_segments: "
             f"{sorted(k for k in want if got.get(k) != want[k])} != the "
             f"default allocator's bitwise")
    log(f"[phase11] every cross-card edge of B3 and B4 under "
        f"PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True (another "
        f"process): {len(want)} outputs ({', '.join(sorted(want))}) == the "
        f"default allocator's bitwise, in "
        f"{time.perf_counter() - t0:.1f} s")

    def cz_run(path, ch, mesh, parts, state_c, halo, frames, overlap,
               expect):
        """Two super-blocks of the step on ``mesh``; the launches counted
        from 0 over them (each kernel nonzero exactly where ``expect``
        names it); returns the gathered spectra of each and the state."""
        step = ch.sharded_step(mesh, halo=halo, frames=frames,
                               halo_overlap=overlap)
        for w in wrappers.values():
            w.launches = 0
        cross0 = (hr.left_halo_ring_cuda.cross_card_launches,
                  hf.block2_fir_halo_fused_cuda.cross_card_launches)
        st = ch.init_state(state_c)
        outs = []
        for _ in range(2):
            spec, st = step(parts, st)
            outs.append(gather(spec, mesh, **(
                {"spec": CHANNEL_MAJOR} if frames == "a2a" else {"dim": 1})))
            del spec
        hr.check_exchanges(mesh)
        torch.cuda.synchronize()
        got = {n: w.launches for n, w in wrappers.items()}
        cross = (hr.left_halo_ring_cuda.cross_card_launches - cross0[0],
                 hf.block2_fir_halo_fused_cuda.cross_card_launches
                 - cross0[1])
        wrong = [n for n, k in got.items() if (n in expect) != (k > 0)]
        if wrong:
            fail(f"{path}: launches {got}, expected nonzero exactly on "
                 f"{sorted(expect)}")
        return outs, st, got, cross, step

    def cz_path(path, m, nc, nt, channels, t_rank, halo="ppermute",
                frames="local", overlap=False, profile=False):
        """One path at full width on ``nc x nt`` cards and on the same
        ranks of ``dev``."""
        ch = chans[m]
        n = nc * nt
        xs = x[:channels, :nt * t_rank]
        expect = {B1 if m == "fused" else B2}
        if halo == "rdma":
            expect.add(B3)
        elif halo == "rdma_fused":
            expect = {B3, B4}
        devs = [torch.device("cuda", i) for i in range(n)]

        def mesh_of(d):  # rdma needs a 1-D (time,) mesh
            return DspMesh(d, (TIME_AXIS,)) if nc == 1 else \
                make_dsp_mesh(nc, nt, devices=d)

        multi, one = mesh_of(devs), mesh_of([dev] * n)
        pm, po = shard(xs, multi), shard(xs, one)
        with matmul_precision("highest"):
            got, st, launches, cross, step = cz_run(
                path, ch, multi, pm, channels, halo, frames, overlap, expect)
            ref, st_ref, _, _, step_one = cz_run(
                path + " on one card", ch, one, po, channels, halo, frames,
                overlap, expect)
            for i in range(2):
                if got[i].shape != ref[i].shape or \
                        not torch.equal(got[i], ref[i]):
                    fail(f"{path} super-block {i + 1}: != the same ranks on "
                         f"{dev} bitwise")
            for u, v in zip(st, st_ref):
                if not torch.equal(u.to(dev), v):
                    fail(f"{path}: state != the same ranks on {dev}'s")
            first = got[0]
            del got, ref, st_ref
            model = comm_bytes(ch, nc, nt, channels, frames=frames,
                               t_total=nt * t_rank)
            moved = collective_traffic(lambda: step(
                pm, ch.init_state(channels)))["total_bytes"]
            hr.check_exchanges(multi)
            if moved != model:
                fail(f"{path}: traffic {moved} B != model {model} B")
            st0 = ch.init_state(channels)
            ms = cuda_ms(lambda: step(pm, st0), iters=3, warmup=1)
            ms_one = cuda_ms(lambda: step_one(po, st0), iters=3, warmup=1)
            enqueue = host_ms(lambda: step(pm, st0), iters=3, warmup=0)
            prof = profile_calls(lambda: step(pm, st0), 2) \
                if profile else None
            hr.check_exchanges(multi)
            hr.check_exchanges(one)
            # phase 10's floors: exact paths against unsharded streaming,
            # a2a against the one-shot step, overlap against the exact step
            if overlap:
                want, _ = ch.sharded_step(one, halo=halo)(
                    po, ch.init_state(channels))
                want = gather(want, one, dim=1)
                floor, what = OVERLAP_FLOOR_DB, "the exact step"
            del pm, po
            torch.cuda.empty_cache()
            if not overlap and frames == "a2a":
                want, _ = ch.step(xs, ch.init_state(channels))
                floor, what = A2A_FLOOR_DB, "the unsharded one-shot step"
            elif not overlap:
                st_u, want = ch.init_state(channels), []
                for j in range(nt):
                    s_, st_u = ch.step(xs[:, j * t_rank:(j + 1) * t_rank],
                                       st_u)
                    want.append(s_)
                want = torch.cat(want, dim=1)
                floor, what = SHARDED_FLOOR_DB, "unsharded streaming"
            snr = device_snr_db(want, first)
            if first.shape != want.shape or not snr >= floor:
                fail(f"{path}: {snr:.1f} dB against {what} (floor {floor})")
            del want, first
        if halo != "ppermute" and cross[0] == 0 or \
                halo == "rdma_fused" and cross[1] == 0:
            fail(f"{path}: no cross-card launch of B3 / B4 ({cross})")
        for name, k in launches.items():
            if k:
                by_path[name][f"phase11 {path}"] = k
        n_in = channels * nt * t_rank
        log(f"[phase11] {path} ({channels} x {nt} x {t_rank}, "
            f"{[str(d) for d in devs]}): == the same ranks on {dev} "
            f"bitwise (2 super-blocks, state), {snr:.1f} dB against {what} "
            f"(floor {floor}); launches {launches}, across cards B3 "
            f"{cross[0]} B4 {cross[1]}; traffic {moved} B == model")
        log(f"[time] phase11 {path}: {ms:.3f} ms a step on {n} cards "
            f"({n_in / ms / 1e3 / n:.0f} Msamples/s a card), {ms_one:.3f} "
            f"ms on {n} ranks of {dev} ({n_in / ms_one / 1e3:.0f} "
            f"Msamples/s); the host enqueues a step in {enqueue:.3f} ms; "
            f"on {smi}")
        if prof is not None:
            log(f"[time] phase11 {path} under torch.profiler: "
                f"{prof.event_ms:.3f} ms of events, host {prof.host_ms:.3f} "
                f"ms, device busy by card "
                f"{ {k: round(v, 3) for k, v in prof.busy_by_device.items()} }"
                f" ms; top {[(r[0][:40], round(r[1], 3)) for r in prof.rows[:4]]}")
        torch.cuda.empty_cache()

    ta_fused, ta_block2 = P10_A2A_T_LOC["fused"], P10_A2A_T_LOC["block2"]
    for n in (2, 4):
        if n > count:
            log(f"[phase11] {n} cards: {count} visible, skipped")
            continue
        w = f"1x{n}"
        cz_path(f"{w} fused ppermute", "fused", 1, n, CZ_CHANNELS, t_loc,
                profile=True)
        cz_path(f"{w} fused rdma", "fused", 1, n, CZ_CHANNELS, t_loc, "rdma")
        cz_path(f"{w} block2 ppermute", "block2", 1, n, CZ_CHANNELS, t_loc)
        cz_path(f"{w} block2 rdma", "block2", 1, n, CZ_CHANNELS, t_loc,
                "rdma")
        cz_path(f"{w} block2 rdma_fused {CZ_FUSED_CHANNELS}ch", "block2", 1,
                n, CZ_FUSED_CHANNELS, t_loc, "rdma_fused")
        cz_path(f"{w} fused rdma a2a", "fused", 1, n, CZ_CHANNELS, ta_fused,
                "rdma", "a2a")
        cz_path(f"{w} block2 ppermute a2a", "block2", 1, n, CZ_CHANNELS,
                ta_block2, "ppermute", "a2a")
        cz_path(f"{w} block2 rdma_fused a2a {CZ_FUSED_CHANNELS}ch", "block2",
                1, n, CZ_FUSED_CHANNELS, ta_block2, "rdma_fused", "a2a")
        cz_path(f"{w} halo_overlap fused rdma", "fused", 1, n, CZ_CHANNELS,
                t_loc, "rdma", overlap=True)
        cz_path(f"{w} halo_overlap block2 ppermute", "block2", 1, n,
                CZ_CHANNELS, t_loc, overlap=True)
    if count >= 4:
        for nc, nt in ((2, 2), (4, 1)):
            w = f"{nc}x{nt}"
            for m in ("fused", "block2"):
                cz_path(f"{w} {m} ppermute", m, nc, nt, CZ_CHANNELS,
                        4 * t_loc // nt)
            cz_path(f"{w} fused ppermute a2a", "fused", nc, nt, CZ_CHANNELS,
                    4 * ta_fused // nt, "ppermute", "a2a")

    # ---- B3 and B4 timed across cards, beside the same ranks on dev ------
    n = min(count, CZ_RANKS)
    cards = DspMesh([torch.device("cuda", i) for i in range(n)],
                    (TIME_AXIS,))
    one = DspMesh([dev] * n, (TIME_AXIS,))
    taps = chans["block2"].fir_taps
    for what, fn, cols in (
            ("halo_ring", lambda p, m: hr.left_halo_ring(
                p, chans["fused"].h_fir, m), CZ_CHANNELS),
            ("halo_fir_fused", lambda p, m: hf.block2_fir_halo_fused(
                p, taps, m, mode="highest"), CZ_FUSED_CHANNELS)):
        pc = shard(x[:cols, :n * t_loc], cards)
        po = shard(x[:cols, :n * t_loc], one)
        ms = cuda_ms(on_mesh(lambda: fn(pc, cards), cards), iters=10)
        ms_one = cuda_ms(on_mesh(lambda: fn(po, one), one), iters=10)
        hr.check_exchanges(cards)
        hr.check_exchanges(one)
        across_ms[what] = {"ms": ms, "cards": n, "same_ranks_one_card_ms":
                           ms_one}
        log(f"[time] phase11 {what} highest, {n} ranks one a card, "
            f"({cols}, {n * t_loc}): {ms:.3f} ms across cards, {ms_one:.3f} "
            f"ms on {n} ranks of {dev}, on {smi}")
        del pc, po
    del x
    torch.cuda.empty_cache()

    # ---- the channelizer tool's default mesh: one rank a card -----------
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "spec.npz")
        seconds = 20.48 * count  # 983 040 samples a rank, the ols frames
        cz_cli.main(["-o", out, "--synth", "64", "--seconds", str(seconds)]
                    + list(CZ_TOOL_ARGS))
        with np.load(out) as z:
            spec = torch.from_numpy(z["spectra"]).to(dev)
    ch = Channelizer(fir_taps=chans["fused"].fir_taps, fft_n=2048,
                     fir_method="ols", device=dev)
    t_use = int(seconds * 48000) // (ch.block_multiple() * count) \
        * ch.block_multiple() * count
    xt = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, int(seconds * 48000))).astype(np.float32)[:, :t_use]).to(dev)
    ref, _ = ch.step(xt, ch.init_state(64))
    snr = device_snr_db(ref, spec)
    if spec.shape != ref.shape or not snr >= SHARDED_FLOOR_DB:
        fail(f"the channelizer tool's default mesh: {snr:.1f} dB")
    log(f"[phase11] the channelizer tool with no mesh options on {count} "
        f"cards (one rank a card), {tuple(spec.shape)}: {snr:.1f} dB "
        f"against Channelizer.step (floor {SHARDED_FLOOR_DB})")
    del spec, ref, xt
    torch.cuda.empty_cache()
    return by_path, across_ms, net_ms


def net_edges_one_card(dev, smi, wrappers, x, parts1, mesh1, chans, gen,
                       by_path, fail):
    """Phase 11's ``NET`` branch on one card: B3 and B4 with every edge of
    ``mesh1`` (ranks of ``dev``, one process) a ``NET`` edge, whose
    transport is a device copy on each receiving rank's transfer stream
    (``_net=True``): B3 at the three halo widths with and without a carry
    bitwise the ranks' normal launch and the plain version, B4 at 256 x
    327 680 a rank at both precisions over three epochs bitwise the normal
    launch and at the kernel floors against the plain version in float64.
    The launches of the ``_net`` runs are counted (each across a ``NET``
    edge), the others not.  Returns ``{kernel: {"ms", "normal_ms"}}``,
    CUDA-event medians of the ``_net`` launch and the normal one."""
    import torch

    from llzlab_tpu_torch.kernels import block2_fir as bf
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.ops.fir import block2_block
    from llzlab_tpu_torch.parallel.mesh import shard

    def run(fn):
        mesh1.fork()
        out = fn()
        mesh1.join()
        hr.check_exchanges(mesh1)
        return out

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, "cross_host_launches"):
                w.cross_host_launches = 0
        out = run(fn)
        return out, {n: (w.launches, getattr(w, "cross_host_launches", 0))
                     for n, w in wrappers.items()}

    B3, B4 = "halo_ring", "halo_fir_fused"
    n = len(mesh1)
    for h in (chans["block2"].h_rs, chans["block2"].h_fir,
              chans["fused"].h_fir):
        for carry in (None, torch.randn((x.shape[0], h), generator=gen,
                                        device=dev)):
            normal = run(lambda: hr.left_halo_ring_cuda(
                parts1, h, mesh1, first_shard_value=carry))
            plain = run(lambda: hr.left_halo_ring_plain(
                parts1, h, mesh1, first_shard_value=carry))
            got, k = counted(lambda: hr.left_halo_ring_cuda(
                parts1, h, mesh1, first_shard_value=carry, _net=True))
            torch.cuda.synchronize(dev)
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(got, normal, plain)):
                fail(f"B3 NET edges h={h}: != the normal launch / the plain "
                     f"version")
            if k[B3] != (n, n) or sum(v[0] for v in k.values()) != n:
                fail(f"B3 NET edges h={h}: launches (all, across a NET "
                     f"edge) {k}, expected {n} of B3 alone, all across")
            by_path[B3]["phase11 NET edges on one card"] = by_path[B3].get(
                "phase11 NET edges on one card", 0) + n
    log(f"[phase11] B3 with every edge NET, {n} ranks of {dev} each "
        f"launched alone (the halo through a device copy on each receiving "
        f"rank's transfer stream, the epoch published by a kernel): h = 63, "
        f"1024, 2048 with and without a carry == the normal launch == plain "
        f"version bitwise, {n} launches an exchange, each across a NET edge")
    del got, normal, plain

    taps = chans["block2"].fir_taps
    block = block2_block(len(taps))
    t_loc = parts1[0].shape[1]
    stream = x[:CZ_FUSED_CHANNELS].contiguous()
    parts = shard(stream, mesh1)
    for mode in MODES:
        carry = None
        for epoch in (1, 2, 3):
            normal = run(lambda: hf.block2_fir_halo_fused_cuda(
                parts, taps, mesh1, first_shard_value=carry, mode=mode))
            got, k = counted(lambda: hf.block2_fir_halo_fused_cuda(
                parts, taps, mesh1, first_shard_value=carry, mode=mode,
                _net=True))
            lead = (torch.zeros((CZ_FUSED_CHANNELS, block), device=dev)
                    if carry is None else carry)
            ref64 = bf.block2_fir_plain(
                torch.cat([lead, stream], -1).double(), taps, block,
                "highest")
            torch.cuda.synchronize(dev)
            if not all(torch.equal(a, b) for a, b in zip(got, normal)):
                fail(f"B4 NET edges {mode} epoch {epoch}: != the normal "
                     f"launch bitwise")
            snr = device_snr_db(ref64, torch.cat(got, -1))
            if not snr >= KERNEL_FLOOR_DB[mode]:
                fail(f"B4 NET edges {mode}: {snr:.1f} dB against the plain "
                     f"version in float64 (floor {KERNEL_FLOOR_DB[mode]})")
            if k[B4] != (n, n) or sum(v[0] for v in k.values()) != n:
                fail(f"B4 NET edges {mode}: launches {k}, expected {n} of "
                     f"B4 alone, all across a NET edge")
            by_path[B4]["phase11 NET edges on one card"] = by_path[B4].get(
                "phase11 NET edges on one card", 0) + n
            log(f"[phase11] B4 {mode} with every edge NET, {n} ranks of "
                f"{dev}, {CZ_FUSED_CHANNELS} x {t_loc} a rank, epoch "
                f"{epoch}: == the normal launch bitwise, {snr:.1f} dB "
                f"against plain f64 (floor {KERNEL_FLOOR_DB[mode]})")
            carry = stream[:, -block:].contiguous()
            del got, normal, ref64
    net_ms = {}
    h = chans["fused"].h_fir
    for name, what, fn in (
            (B3, f"({x.shape[0]}, {h})", lambda net: hr.left_halo_ring_cuda(
                parts1, h, mesh1, _net=net)),
            (B4, f"{CZ_FUSED_CHANNELS} x {t_loc} a rank",
             lambda net: hf.block2_fir_halo_fused_cuda(
                 parts, taps, mesh1, mode="highest", _net=net))):
        def timed(net):
            mesh1.fork()
            fn(net)
            mesh1.join()
        ms = cuda_ms(lambda: timed(True), iters=10)
        normal_ms = cuda_ms(lambda: timed(False), iters=10)
        hr.check_exchanges(mesh1)
        net_ms[name] = {"ms": ms, "normal_ms": normal_ms}
        log(f"[time] phase11 {name} highest {what} on {n} ranks of {dev}, "
            f"every edge NET: {ms:.3f} ms, the normal launch "
            f"{normal_ms:.3f} ms; on {smi}")
    del parts, stream
    torch.cuda.empty_cache()
    return net_ms


def cross_card_digests(dev) -> dict:
    """Fingerprints (``halo_ipc_worker_torch.digest``) of what every kind
    of cross-card edge of B3 and B4 gives, from seeded inputs on up to four
    cards: B3 at ``(1024, 2048)`` on ``[0, 0, 1, 1]`` and a rank a card,
    B4 a rank a card at 256 x 327 680 at both precisions, and two
    super-blocks of the channelizer's fused ``rdma`` (1024 channels) and
    block2 ``rdma_fused`` (256) steps a rank a card.  Phase 11 runs it in
    this process and in one started under PyTorch's expandable segments,
    and holds the two bitwise."""
    import torch

    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh, shard
    from scripts import halo_ipc_worker_torch as hw

    count = min(torch.cuda.device_count(), CZ_RANKS)
    ch = {m: Channelizer(fir_method=m, device=dev)
          for m in ("fused", "block2")}
    t_loc = ch["fused"].block_multiple()
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((CZ_CHANNELS, count * t_loc), generator=gen, device=dev)
    out = {}

    def mesh_of(layout):
        return DspMesh([torch.device("cuda", i) for i in layout],
                       (TIME_AXIS,))

    def on(mesh, fn):
        mesh.fork()
        got = fn()
        mesh.join()
        hr.check_exchanges(mesh)
        return got

    for layout in ([0, 0, 1, 1], list(range(count))):
        mesh = mesh_of(layout)
        xs = x[:, :len(layout) * (x.shape[1] // len(layout))]
        got = on(mesh, lambda: hr.left_halo_ring(
            shard(xs, mesh), ch["fused"].h_fir, mesh))
        out[f"B3 {layout}"] = hw.digest(torch.cat([g.to(dev) for g in got]))
    mesh = mesh_of(range(count))
    parts = shard(x[:CZ_FUSED_CHANNELS].contiguous(), mesh)
    for mode in MODES:
        got = on(mesh, lambda: hf.block2_fir_halo_fused(
            parts, ch["block2"].fir_taps, mesh, mode=mode))
        out[f"B4 {mode}"] = hw.digest(torch.cat([g.to(dev) for g in got],
                                                -1))
    with matmul_precision("highest"):
        for m, halo, c in (("fused", "rdma", CZ_CHANNELS),
                           ("block2", "rdma_fused", CZ_FUSED_CHANNELS)):
            step = ch[m].sharded_step(mesh, halo=halo)
            st = ch[m].init_state(c)
            xp = shard(x[:c].contiguous(), mesh)
            for i in range(2):
                spec, st = step(xp, st)
                hr.check_exchanges(mesh)
                out[f"{m} {halo} step {i}"] = hw.digest(torch.cat(
                    [s.to(dev) for s in spec], 1))
            out[f"{m} {halo} state"] = [hw.digest(v) for v in st]
    torch.cuda.synchronize()
    return out


def process_paths(dev, smi, wrappers):
    """Phase 12: kernels B3 and B4 between processes, through CUDA IPC
    (``scripts/halo_ipc_worker_torch.py`` starts the workers).  Always:
    two processes on ``dev`` over gloo, the mesh ``[P0, P0, P1, P1]``, B3
    at config 5's ``(1024, 2048)`` tails over three epochs with a carry and
    B4 at 256 x 327 680 a rank at both precisions, each process bitwise
    the same ranks in one process and the plain version (B4 at the kernel
    floors), no error word set.  With two or more cards: config 5 at full
    width on 2 and 4 processes a card over NCCL, fused ``rdma``, block2
    ``rdma`` and block2 ``rdma_fused`` at 256 channels, two super-blocks
    and each process's state bitwise the same steps on one process's mesh
    over the same cards, traffic equal to ``comm_bytes(..., procs=n)``,
    the steps timed beside ``ppermute``; B3 and B4 timed; config 1 through
    ``fir_filter_tap_parallel`` on 2 processes, bitwise.  The same again
    with each process a host of its own (the ``hosts`` mode: every edge a
    ``NET`` edge, NCCL held to its network transport, which the log
    names), bitwise the same reference.  Returns ``({kernel: {path:
    launches}}, {kernel: {what: ms}, "nccl_transport": [...]})``.  Raises
    on any failure."""
    import tempfile

    import torch

    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.parallel.mesh import (TIME_AXIS, DspMesh,
                                                make_dsp_mesh)
    from llzlab_tpu_torch.parallel.tap_tp import fir_filter_tap_parallel
    from scripts import halo_ipc_worker_torch as hw

    by_path = {name: {} for name in wrappers}
    across = {"halo_ring": {}, "halo_fir_fused": {}}
    count = torch.cuda.device_count()

    def fail(msg):
        raise RuntimeError(f"phase 12 {msg}")

    def launches(results, expect, suffix=""):
        """Sum each path's launches over the processes; each kernel of
        ``expect(path)`` launched, across processes (or hosts) too, and no
        other; ``by_path``'s key is the path and ``suffix``."""
        for path in results[0]["paths"]:
            got = {k: [sum(r["paths"][path][k][i] for r in results)
                       for i in (0, 1)] for k in results[0]["paths"][path]}
            want = expect(path)
            if any((k in want) != (n > 0 and x > 0)
                   for k, (n, x) in got.items()):
                fail(f"{path}: launches, across processes {got}, expected "
                     f"nonzero exactly on {sorted(want)}")
            for k, (n, _) in got.items():
                if n:
                    by_path[k][f"phase12 {path}{suffix}"] = n
            log(f"[phase12] {path}{suffix}: launches (all, across "
                f"{'hosts' if suffix else 'processes'}) {got}")

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res = hw.launch("card", 2, os.path.join(tmp, "card"))
    launches(res, lambda path: {"halo_ring"} if path.startswith("B3")
             else {"halo_fir_fused"})
    r0 = res[0]
    log(f"[phase12] two processes on {dev} (gloo for the handshake, the "
        f"mesh [P0, P0, P1, P1]): B3 (1024, 2048) over 3 epochs with a "
        f"carry and B4 256 x 327 680 a rank at highest / high, each "
        f"process == the same ranks in one process bitwise, B3 == plain "
        f"bitwise, B4 against plain float64 "
        f"{min(r['b4_snr_db']['highest'] for r in res):.1f} / "
        f"{min(r['b4_snr_db']['high'] for r in res):.1f} dB, no error word")
    log(f"[time] phase12 two processes of one card (time-sliced, not a "
        f"speed): B3 {r0['b3_ms']:.3f} ms an exchange (the same ranks in "
        f"one process {r0['b3_one_process_ms']:.3f}); B4 highest / high "
        f"{r0['b4_ms']['highest']:.3f} / {r0['b4_ms']['high']:.3f} ms "
        f"({r0['b4_one_process_ms']['highest']:.3f} / "
        f"{r0['b4_one_process_ms']['high']:.3f}); on {smi}")
    across["halo_ring"]["2 processes of one card"] = r0["b3_ms"]
    across["halo_fir_fused"]["2 processes of one card"] = \
        r0["b4_ms"]["highest"]
    if count < 2:
        log(f"[phase12] one card visible ({count}): a process a card needs "
            f"two or more")
        return by_path, across

    for n in (2, 4):
        if n > count:
            log(f"[phase12] {n} processes a card: {count} cards, skipped")
            continue
        cards = [torch.device("cuda", i) for i in range(n)]
        mesh = DspMesh(cards, (TIME_AXIS,))
        want = {}
        with matmul_precision("highest"):
            for method, halo, channels in hw.CZ_PATHS:
                path = (f"config 5 {method} {halo} {channels}ch 1x{n} "
                        f"processes")
                want[path] = hw.cz_steps(
                    Channelizer(fir_method=method, device=dev), mesh,
                    channels, hw.CZ_T_LOC, halo)
                hr.check_exchanges(mesh)
                torch.cuda.empty_cache()
            if n == 2:
                xs, taps = hw.tap_inputs()
                path = f"config 1 fir_filter_tap_parallel 1x{n} processes"
                got = fir_filter_tap_parallel(
                    torch.from_numpy(xs), taps,
                    make_dsp_mesh(1, n, devices=cards))
                want[path] = {f"rank{r}": hw.digest(v)
                              for r, v in enumerate(got)}
                del got
        del mesh
        torch.cuda.empty_cache()
        for mode, kind, where in (("cards", hr.PROCESS, "processes"),
                                  ("hosts", hr.NET, "hosts")):
            with tempfile.TemporaryDirectory() as tmp:
                res = hw.launch(mode, n, os.path.join(tmp, mode))
            launches(res, lambda path: {"halo_ring"} if " rdma " in path
                     else {"halo_ring", "halo_fir_fused"} if "rdma_fused" in
                     path else set(), " as hosts" if mode == "hosts" else "")
            for r in res:
                if r["kinds"] != [kind] * (n - 1):
                    fail(f"{mode} mode on {n} processes: process "
                         f"{r['process']} planned its edges {r['kinds']}, "
                         f"not {kind}")
            for path, ref in want.items():
                for r in res:
                    for k, v in r["digests"][path].items():
                        if ref[k] != v:
                            fail(f"{path} ({mode}): process {r['process']} "
                                 f"{k} != the same steps of one process's "
                                 f"mesh over {n} cards")
                    if path in r["traffic"]:
                        moved, model = r["traffic"][path]
                        if moved != model:
                            fail(f"{path} ({mode}): traffic {moved} B != "
                                 f"model {model} B")
                log(f"[phase12] {path}, a process a card as {n} {where} "
                    f"(edges {kind}): "
                    + (f"2 super-blocks of {path.split()[4][:-2]} x "
                       f"{hw.CZ_T_LOC} a rank and each process's state == "
                       f"the same steps of one process over {n} cards "
                       f"bitwise; traffic {res[0]['traffic'][path][0]} B == "
                       f"model" if path in res[0]["traffic"] else
                       "each rank's replica == one process's mesh over "
                       f"{n} cards bitwise"))
            via = sorted({v for r in res for v in r.get("nccl_transport",
                                                        [])})
            r0 = res[0]
            steps = ", ".join(f"{p.split(' 1x')[0][9:]} {ms:.3f}"
                              for p, ms in r0["step_ms"].items())
            log(f"[time] phase12 config 5 a step, {n} processes a card as "
                f"{n} {where} (1 x {n}, {hw.CZ_T_LOC} a rank; the slowest "
                f"process's CUDA events"
                + (f"; NCCL via {', '.join(via)}" if via else "")
                + f"): {steps} ms; B3 (1024, 2048) {r0['b3_ms']:.3f} ms, "
                f"B4 highest 256 x {hw.CZ_T_LOC} a rank {r0['b4_ms']:.3f} "
                f"ms; on {smi}")
            label = (f"{n} processes a card" if mode == "cards"
                     else f"{n} hosts, a process a card")
            across["halo_ring"][label] = r0["b3_ms"]
            across["halo_fir_fused"][label] = r0["b4_ms"]
            if via:
                across["nccl_transport"] = via
    return by_path, across


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_snr_db(ref, y) -> float:
    """SNR of ``y`` against ``ref`` (real or complex tensors on the card),
    summed in float64 channel by channel to bound the temporaries."""
    import torch

    psig = perr = 0.0
    for r, v in zip(ref, y):
        psig += float(torch.sum(r.abs().double() ** 2))
        perr += float(torch.sum((r - v).abs().double() ** 2))
    return float("inf") if perr == 0.0 else 10.0 * np.log10(psig / perr)


def fir_bound_ms(flop: float, nbytes: float, peak: float = FP32_PEAK):
    """Least time for ``flop`` operations at ``peak`` (fp32 outside the
    tensor cores by default) and ``nbytes`` of device memory traffic, and
    which of the two sets it."""
    t_op, t_by = flop / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of enqueuing ``fn()`` in milliseconds,
    without waiting for the card (which is drained between calls)."""
    import torch

    times = []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times[warmup:]))


def fold_geometry(b: int, t: int, block: int):
    """``(L, R)`` of the JAX package's low-channel block2 fold
    (``_fir_filter_block2_pallas_folded``): ``R`` rows of ``L`` outputs, ``L``
    a multiple of the block, at most ``max(8, 1024 // b)`` rows.  The port
    does not fold (a launch takes any row count); phase 6 holds the fold
    against the one-row launch and times both."""
    l = -(-t // (block * max(8, 1024 // b))) * block
    return l, -(-t // l)


def fold_rows(xpad, block: int, l: int):
    """``(B, block + T)`` -> ``(B·R, block + l)``: row ``r`` of channel ``c``
    holds its outputs ``r·l … r·l + l − 1`` with the block of input before
    them (zeros past the end), ``R = ⌈T / l⌉``."""
    import torch.nn.functional as F

    b, tp = xpad.shape
    r = -(-(tp - block) // l)
    xp = F.pad(xpad, (0, block + r * l - tp))
    return xp.unfold(-1, block + l, l).reshape(b * r, block + l).contiguous()


def load_config(name: str):
    """``configs/<name>.json`` of this checkout as the port's ChainConfig."""
    from llzlab_tpu_torch.utils.config import from_json

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", name + ".json")) as f:
        return from_json(f.read())


def configs_1_and_2(dev, smi, rng, reset_launches, read_launches):
    """Phase 6: configs 1 and 2 at their published size, each from its file
    in ``configs/``, through the entry points their users call, then the
    ``fir`` and ``resample`` tools on WAVs of the same signals.  Returns the
    launches of B2 on each of these paths (config 1's chain in each mode,
    the ``fir`` tool) and B2's largest max |kernel - plain| here."""
    import tempfile

    import scipy.signal as ss
    import torch
    import torch.nn.functional as F

    from llzlab_tpu_torch import (Chain, FIRStage, ResampleStage, decimate,
                                  firwin, resample, resample_taps)
    from llzlab_tpu_torch.cli import fir as fir_cli
    from llzlab_tpu_torch.cli import resample as resample_cli
    from llzlab_tpu_torch.io.wav import read_wav, write_wav
    from llzlab_tpu_torch.kernels import block2_fir as bf
    from llzlab_tpu_torch.ops import fir as fir_ops
    from llzlab_tpu_torch.ops.resample import resample_output_len

    def snr(ref, y):
        return min_channel_snr_db(ref[:, :y.shape[-1]], y)

    def check(what, got_db, floor):
        log(f"[config] {what}: min-channel SNR vs scipy f64 {got_db:.1f} dB "
            f"(floor {floor})")
        if not got_db >= floor:
            raise RuntimeError(f"{what}: SNR {got_db:.1f} dB below {floor}")

    # ---- config 1: FIR alone, 1 x 480 000, firwin(1024, 0.25, hamming) ----
    cfg1 = load_config("fir_lowpass_1ch")
    f1 = cfg1.fir
    t1 = int(cfg1.sample_rate * cfg1.seconds)
    taps = firwin(f1.numtaps, f1.cutoff if len(f1.cutoff) > 1 else
                  f1.cutoff[0], window=f1.window, pass_zero=f1.kind)
    block = fir_ops.block2_block(len(taps))
    x1_np = rng.standard_normal((cfg1.channels, t1)).astype(np.float32)
    gold1 = ss.lfilter(taps, [1.0], x1_np.astype(np.float64), axis=-1)
    x1 = torch.from_numpy(x1_np).to(dev)
    chain1 = Chain([FIRStage(taps)])
    if chain1.stages[0].method != "block2":
        raise RuntimeError(f"FIRStage(method='auto') resolved to "
                           f"{chain1.stages[0].method!r} at {len(taps)} taps")
    # the fir tool's blocks: two seconds, cut to the stage's grid
    m1 = chain1.block_multiple
    blk1 = int(2.0 * cfg1.sample_rate) // m1 * m1
    blocks1 = [x1[:, i:i + blk1] for i in range(0, t1, blk1)]
    lw, rw = fold_geometry(cfg1.channels, t1, block)
    log(f"[config] config 1 ({cfg1.name}): {cfg1.channels} x {t1}, "
        f"{len(taps)} taps, FIRStage(auto) -> block2, one B2 launch on the "
        f"row a call, streamed in {len(blocks1)} blocks of {blk1} (the fir "
        f"tool's)")
    xpad1 = F.pad(x1, (block, 0))
    rows1 = fold_rows(xpad1, block, lw)

    def against_plain(what, xp, mode):
        """B2 on ``xp`` against its plain version: max |kernel - plain|,
        and the SNR against the plain version in float64."""
        got = bf.block2_fir_cuda(xp, taps, block, mode)
        plain = bf.block2_fir_plain(xp, taps, block, mode)
        ref64 = bf.block2_fir_plain(xp.double(), taps, block, "highest")
        err = float((got - plain).abs().max())
        db = device_snr_db(ref64, got)
        log(f"[kernel] block2_fir {mode:7s} config 1, {what} "
            f"{tuple(xp.shape)}: max|kernel-plain| {err:.3e}, SNR vs plain "
            f"f64 {db:.1f} dB (floor {KERNEL_FLOOR_DB[mode]})")
        if not (torch.isfinite(got).all() and db >= KERNEL_FLOOR_DB[mode]):
            raise RuntimeError(f"block2_fir {mode} config 1, {what}: SNR "
                               f"{db:.1f} dB below {KERNEL_FLOOR_DB[mode]}")
        return got, err

    launches, b2_err = {}, 0.0
    for mode in MODES[::-1]:
        with matmul_precision(mode):
            reset_launches()
            streamed = torch.cat(list(chain1.stream(blocks1)), dim=-1)
            one = chain1(x1)
            launches[f"config 1 {mode}"] = read_launches(
                ("block2_fir",), f"config 1 {mode}")["block2_fir"]
        # B2 at the shapes this path gives it (the one-shot row, the first
        # tool block's, which has no history), and on the JAX package's
        # fold of the one-shot row, which the port does not make
        row, e1 = against_plain("the one-shot row", xpad1, mode)
        _, e2 = against_plain("a fir tool block's row",
                              xpad1[:, :block + blk1], mode)
        fold, e3 = against_plain(f"the JAX package's fold ({rw} rows of "
                                 f"L = {lw})", rows1, mode)
        b2_err = max(b2_err, e1, e2, e3)
        fold = fold.reshape(cfg1.channels, -1)[:, :t1]
        pad8 = bf.block2_fir_cuda(
            F.pad(xpad1, (0, 0, 0, 8 - cfg1.channels)), taps, block,
            mode)[:cfg1.channels]
        torch.cuda.synchronize()
        for what, a, b in (("streamed != one shot", streamed, one),
                           ("one shot != the one-row launch", one, row),
                           ("the one-row launch != the launch on 8 rows",
                            row, pad8),
                           ("the JAX package's fold != the one-row launch",
                            fold, row)):
            if not torch.equal(a, b):
                raise RuntimeError(f"config 1 {mode}: {what}")
        log(f"[config] config 1 {mode:7s}: streamed == one shot == the "
            f"one-row launch == that row padded to 8 rows == the JAX "
            f"package's fold, bitwise")
        check(f"config 1 FIRStage(block2) {mode}", snr(gold1,
              streamed.cpu().numpy()), CHAIN_FLOOR_DB[mode])
        del row, fold, pad8, streamed, one
    outs = {}
    for method in ("ols", "direct", "im2col"):
        st = FIRStage(taps, method=method,
                      nfft=f1.nfft if method == "ols" else None)
        outs[method] = Chain([st])(x1)
        check(f"config 1 FIRStage({method})"
              + (" (the preset's method)" if method == f1.method else ""),
              snr(gold1, outs[method].cpu().numpy()), 80.0)

    # ---- config 2: resample 147/160, K = 64, beta = 8, 8 x 480 000 -------
    cfg2 = load_config("resample_8ch")
    rc = cfg2.resample
    t2 = int(cfg2.sample_rate * cfg2.seconds)
    rtaps = resample_taps(rc.up, rc.down, rc.taps_per_phase,
                          window=("kaiser", rc.kaiser_beta))
    x2_np = rng.standard_normal((cfg2.channels, t2)).astype(np.float32)
    x64 = x2_np.astype(np.float64)
    gold2 = ss.upfirdn(rtaps, x64, rc.up, rc.down, axis=-1)
    x2 = torch.from_numpy(x2_np).to(dev)
    chain2 = Chain([ResampleStage(rc.up, rc.down, taps=rtaps)])
    m2 = chain2.block_multiple
    blk2 = int(2.0 * cfg2.sample_rate) // m2 * m2
    blocks2 = [x2[:, i:i + blk2] for i in range(0, t2, blk2)]
    streamed2 = torch.cat(list(chain2.stream(blocks2)), dim=-1)
    if not torch.equal(streamed2, chain2(x2)):
        raise RuntimeError("config 2: streamed != one shot")
    log(f"[config] config 2 ({cfg2.name}): {cfg2.channels} x {t2} -> "
        f"{tuple(streamed2.shape)}, {len(blocks2)} blocks of {blk2}, "
        f"streamed == one shot bitwise")
    check("config 2 ResampleStage(147, 160)", snr(gold2,
          streamed2.cpu().numpy()), 80.0)
    q = 4
    check(f"decimate(x, {q}) vs upfirdn", snr(
        ss.upfirdn(resample_taps(1, q), x64, 1, q, axis=-1),
        decimate(x2, q).cpu().numpy()), 80.0)
    num = int(round(t2 * 44100 / cfg2.sample_rate))
    check(f"resample(x, {num}) vs scipy.signal.resample", snr(
        ss.resample(x64, num, axis=-1), resample(x2, num).cpu().numpy()),
        80.0)

    # ---- the tools, in process, on WAVs of the same signals ------------
    with tempfile.TemporaryDirectory() as tmp:
        wav1, wav2 = os.path.join(tmp, "c1.wav"), os.path.join(tmp, "c2.wav")
        write_wav(wav1, x1_np, int(cfg1.sample_rate))
        write_wav(wav2, x2_np, int(cfg2.sample_rate))
        reset_launches()
        _, msps = fir_cli.main(["-i", wav1, "-o", wav1 + ".out", "--taps",
                                str(f1.numtaps), "--cutoff",
                                str(f1.cutoff[0])])
        launches["fir tool"] = read_launches(("block2_fir",),
                                             "fir tool")["block2_fir"]
        y, rate = read_wav(wav1 + ".out")
        check(f"fir tool ({msps:.1f} Msamples/s of its own clock, file to "
              f"file), {y.shape} at {rate} Hz", snr(gold1, y),
              CHAIN_FLOOR_DB["highest"])
        _, msps = resample_cli.main(["-i", wav2, "-o", wav2 + ".out",
                                     "--rate", "44100"])
        y, rate = read_wav(wav2 + ".out")
        if rate != 44100 or y.shape != tuple(streamed2.shape):
            raise RuntimeError(f"resample tool: {y.shape} at {rate} Hz")
        check(f"resample tool ({msps:.1f} Msamples/s), {y.shape} at {rate} "
              f"Hz", snr(gold2, y), 80.0)

    # ---- times: CUDA events, each beside its bound ----------------------
    n1 = cfg1.channels * t1
    by1 = 4.0 * (xpad1.numel() + n1)
    bound1 = {"highest": fir_bound_ms(2.0 * len(taps) * n1, by1),
              "high": fir_bound_ms(3 * 2.0 * len(taps) * n1, by1, BF16_PEAK)}
    for mode in MODES[::-1]:
        fns = {"row": lambda: bf.block2_fir_cuda(xpad1, taps, block, mode),
               "fold": lambda: bf.block2_fir_cuda(
                   fold_rows(xpad1, block, lw), taps, block,
                   mode).reshape(cfg1.channels, -1)[:, :t1],
               "rows": lambda: bf.block2_fir_cuda(rows1, taps, block, mode)}
        reads = {k: [] for k in fns}
        for _ in range(2):  # in turns, twice
            for k, f in fns.items():
                reads[k].append(cuda_ms(f))
        ms = {k: float(np.median(v)) for k, v in reads.items()}
        plain_ms = cuda_ms(lambda: bf.block2_fir_plain(xpad1, taps, block,
                                                       mode))
        b, by = bound1[mode]
        log(f"[time] config 1 block2 {mode:7s} {cfg1.channels}x{t1}: "
            f"one-row launch (the port's) {ms['row']:.4f} ms, the JAX "
            f"package's fold {ms['fold']:.4f} ms (framing + B2 on {rw} rows; "
            f"B2 alone {ms['rows']:.4f} ms), plain on the row {plain_ms:.4f} "
            f"ms, bound {b:.4f} ms ({by}) on {smi}")
    b, by = bound1["highest"]
    for method in ("ols", "direct", "im2col"):
        ms = cuda_ms(lambda: fir_ops.fir_filter(x1, taps, method=method))
        log(f"[time] config 1 fir_filter({method}) {cfg1.channels}x{t1}: "
            f"{ms:.4f} ms, bound {b:.4f} ms ({by}, the FIR's own work in "
            f"fp32) on {smi}")
    st2 = chain2.init_state((cfg2.channels,), device=dev)
    n_out = resample_output_len(blk2, rc.up, rc.down)
    b, by = fir_bound_ms(2.0 * rc.taps_per_phase * cfg2.channels * n_out,
                         4.0 * cfg2.channels * (blk2 + n_out))
    ms = cuda_ms(lambda: chain2.apply(blocks2[0], st2))
    log(f"[time] config 2 step {cfg2.channels}x{blk2}: {ms:.4f} ms "
        f"({cfg2.channels * blk2 / ms / 1e3:.0f} Msamples/s), bound "
        f"{b:.4f} ms ({by}, K products per output) on {smi}")
    ms = cuda_ms(lambda: chain2(x2))
    log(f"[time] config 2 one shot {cfg2.channels}x{t2}: {ms:.4f} ms on "
        f"{smi}")
    for mode in MODES[::-1]:
        with matmul_precision(mode):
            st1 = chain1.init_state((cfg1.channels,), device=dev)
            ms = host_ms(lambda: chain1.apply(blocks1[0], st1))
            dev_ms = cuda_ms(lambda: chain1.apply(blocks1[0], st1))
        log(f"[time] config 1 FIRStage.apply {mode:7s} at the fir tool's "
            f"block ({cfg1.channels}x{blk1}): the host takes {ms:.4f} ms to "
            f"enqueue it, the card {dev_ms:.4f} ms back to back, on {smi}")
    return launches, b2_err


def wola_f64(x, gain, n_fft: int, hop: int, window: str):
    """Float64 WOLA: frame, window, rfft, per-bin gain, irfft, window,
    overlap-add frame by frame, divide by the window-square envelope;
    ``x (C, T)`` → ``(C, n_fft + (nf − 1)·hop)``.  Numpy and scipy only:
    phase 7's golden, independent of the port's code."""
    import scipy.signal as ss
    from numpy.lib.stride_tricks import sliding_window_view

    w = ss.get_window(window, n_fft, fftbins=True).astype(np.float64)
    frames = sliding_window_view(np.asarray(x, np.float64), n_fft,
                                 axis=-1)[..., ::hop, :] * w
    y = np.fft.irfft(np.fft.rfft(frames, axis=-1) * gain, n_fft,
                     axis=-1) * w
    nf = frames.shape[-2]
    out = np.zeros(frames.shape[:-2] + (n_fft + (nf - 1) * hop,))
    env = np.zeros(out.shape[-1])
    for i in range(nf):
        out[..., i * hop:i * hop + n_fft] += y[..., i, :]
        env[i * hop:i * hop + n_fft] += w * w
    return out / np.maximum(env, 1e-8)


#: the wola_gain kernel's error against float64 over a stream, its start
#: included, as a multiple of the error of the same WOLA on cuFFT (the
#: composite path, or the sharded path on it), on the same input: two
#: float32 computations whose error sits in the few positions where the
#: envelope nears zero.  On the CPU the kernel's plain version reads 0.81
#: to 1.31 times the composite path's, two steps of 8 rows from the
#: stream's start, on 6 seeds with either gain.
WOLA_VS_CUFFT = 2.0


def composite_path(gain, n_fft: int, hop: int, window: str, dev):
    """``SpectralGainStage``'s reference engine on cuFFT (frame, window,
    rfft, gain, irfft, window, overlap-add as separate launches) on the
    card.  A callable gain keeps that path, where a static one takes the
    wola_gain kernel; the callable returns the static gain, so the
    products are the same."""
    import torch

    from llzlab_tpu_torch import SpectralGainStage

    g = torch.from_numpy(np.asarray(gain, np.float32)).to(dev)
    return SpectralGainStage(lambda spec: g, n_fft=n_fft, hop=hop,
                             window=window)


def held_to_cufft(what, got, yardstick, want, limit=None) -> float:
    """Log the relative L2 errors of ``got`` (the wola_gain kernel's) and of
    ``yardstick`` (the same WOLA on cuFFT) against float64 ``want``; raise
    unless the kernel's is at most :data:`WOLA_VS_CUFFT` times the
    yardstick's, and at most ``limit`` where one is given.  Returns the
    kernel's."""
    def rel(y):
        return float((y.double() - want).norm() / want.norm())

    mine, theirs = rel(got), rel(yardstick)
    cap = WOLA_VS_CUFFT * theirs if limit is None else min(
        limit, WOLA_VS_CUFFT * theirs)
    log(f"[config4] {what} vs float64, relative L2: the wola_gain kernel "
        f"{mine:.3e}, on cuFFT {theirs:.3e} (ratio {mine / theirs:.3f}; "
        f"limit {WOLA_VS_CUFFT} x cuFFT's"
        + ("" if limit is None else f" and {limit:g}") + ")")
    if not mine <= cap:
        raise RuntimeError(f"{what}: the wola_gain kernel {mine:.3e} vs "
                           f"float64, above {cap:.3e}")
    return mine


def wola_gain_at_the_step(dev, smi, xb, tool_gain, n_fft: int, hop: int,
                          window: str) -> dict:
    """Phase 7: the wola_gain kernel (config 4's frame map in one launch)
    at a step of the benchmark's cell, ``xb`` (256 × 95 744, the ``stft``
    tool's block).  Two steps of 8 channels from the stream's start
    against the benchmark's float64 WOLA (``portbench/reference_stft.py``),
    with the ``stft`` tool's gain (``tool_gain``, -6 dB with a notch) and
    with the benchmark's, each held to the composite path's error on cuFFT
    (:func:`held_to_cufft`), the benchmark's also to 1e-6.  The cell's path,
    ``Chain([SpectralGainStage])`` over steps from a fresh state, counted
    launch by launch; from a state in the stream's interior, bit for bit its
    plain version and the same over two runs; timed beside its plain
    version, the composite path on cuFFT (``library_ms``, the yardstick
    only) and its least time.  Returns the ``kernels`` line's entry."""
    import torch

    from llzlab_tpu_torch import Chain, SpectralGainStage
    from llzlab_tpu_torch.kernels import wola_gain as wg
    from portbench import checks_stft, reference_stft

    c, t = xb.shape
    bench_gain = checks_stft.gain({"stft": {"n_fft": n_fft}}, 26)
    rows = CZ_GOLDEN_CHANNELS
    x2 = torch.cat([xb[:rows], xb[:rows].flip(-1)], -1)
    rel = {}
    for name, gain, limit in (("the stft tool's gain", tool_gain, None),
                              ("the benchmark's gain", bench_gain, 1e-6)):
        want = reference_stft.stream(x2, gain.astype(np.float64), n_fft, hop)
        outs = []
        for path in (SpectralGainStage(gain, n_fft=n_fft, hop=hop,
                                       window=window),
                     composite_path(gain, n_fft, hop, window, dev)):
            st, ys = path.init_state((rows,), device=dev), []
            for piece in (x2[:, :t], x2[:, t:]):
                y, st = path.apply(piece, st)
                ys.append(y)
            outs.append(torch.cat(ys, -1))
        rel[name] = held_to_cufft(
            f"two steps of {rows} x {t} from the stream's start, {name},",
            *outs, want, limit)
    del x2, want, outs, ys

    # the cell's path: a Chain of the stage, steps from a fresh state, one
    # launch each
    stage = SpectralGainStage(bench_gain, n_fft=n_fft, hop=hop, window=window)
    chain, steps = Chain([stage]), 4
    sts = chain.init_state((c,), device=dev)
    wg.wola_gain_cuda.launches = 0
    for _ in range(steps):
        _, sts = chain.apply(xb, sts)
    torch.cuda.synchronize()
    launches = wg.wola_gain_cuda.launches
    log(f"[config4] Chain([SpectralGainStage]) over {steps} steps of {c} x "
        f"{t}: {launches} wola_gain launches")
    if launches != steps:
        raise RuntimeError(f"the cell's path launched wola_gain {launches} "
                           f"times in {steps} steps")
    st = sts[0]
    tables = stage._tables_on(dev)
    args = (xb, st["x_hist"], st["ola"], st["env"], st["pos"], tables)
    got, again = wg.wola_gain_cuda(*args), wg.wola_gain_cuda(*args)
    plain = wg.wola_gain_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, plain))
    same = all(torch.equal(a, b) for a, b in zip(got, plain))
    rerun = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[config4] wola_gain at {c} x {t} from a state in the stream's "
        f"interior: outputs and state bitwise its plain version {same} (max "
        f"|kernel - plain| {err:.3e}), bitwise over two runs {rerun}")
    if not (same and rerun):
        raise RuntimeError("wola_gain: not bitwise its plain version or "
                           "not the same over two runs")
    del got, again, plain
    composite = composite_path(bench_gain, n_fft, hop, window, dev)
    ms = cuda_ms(lambda: wg.wola_gain_cuda(*args))
    plain_ms = cuda_ms(lambda: wg.wola_gain_plain(*args), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: composite.apply(xb, st))
    enqueue_ms = host_ms(lambda: stage.apply(xb, st))
    # the configuration's work (portbench/roofline_stft.py): two real FFTs
    # of 2.5 N log2 N and the window, gain and overlap-add products a
    # frame, or each sample read and written once
    frames = c * (t // hop)
    flop = frames * (5 * n_fft * np.log2(n_fft) + 4 * n_fft + 2)
    bound, by = fir_bound_ms(flop, 8.0 * c * t)
    log(f"[time] wola_gain {c}x{t}: {ms:.4f} ms ({c * t / ms / 1e3:.0f} "
        f"Msamples/s; the stage enqueues it in {enqueue_ms:.3f} ms), plain "
        f"{plain_ms:.3f} ms, the composite path on cuFFT {library_ms:.4f} "
        f"ms, bound {bound:.4f} ms ({by}) on {smi}")
    return {"name": WOLA_KERNEL, "route": "cuda",
            "source": f"llzlab_tpu_torch/csrc/{WOLA_KERNEL}.cu",
            "replaces": None, "launches": launches,
            "launches_by_path": {"config 4 (stage)": launches},
            "max_abs_err": err,
            "rel_err_f64": rel["the benchmark's gain"],
            "rel_err_f64_tool_gain": rel["the stft tool's gain"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms,
            "enqueue_ms": enqueue_ms}


def config_4_and_tools(dev, smi):
    """Phase 7: config 4 at its published size through the three engines
    of ``SpectralGainStage`` (the reference one on the wola_gain kernel),
    the kernel at the benchmark's step, the ``stft`` and ``channelizer``
    tools, and kernel B2 beyond its former limits.  Returns the largest max
    |kernel - plain| of B2 here and the wola_gain kernel's entry."""
    import tempfile

    import torch
    import torch.nn.functional as F

    from llzlab_tpu_torch import (Channelizer, SpectralGainStage, firwin,
                                  istft, stft)
    from llzlab_tpu_torch.cli import channelizer as cz_cli
    from llzlab_tpu_torch.cli import stft as stft_cli
    from llzlab_tpu_torch.io.wav import read_wav, write_wav
    from llzlab_tpu_torch.kernels import block2_fir as bf
    from llzlab_tpu_torch.ops.fir import block2_block, fir_filter
    from portbench import reference_stft

    def check(what, got_db, floor):
        log(f"[config4] {what}: {got_db:.1f} dB (floor {floor})")
        if not got_db >= floor:
            raise RuntimeError(f"{what}: {got_db:.1f} dB below {floor}")

    # ---- config 4: 256 x 480 000, the stft tool's gain ------------------
    cfg = load_config("stft_gain_256ch")
    c, t, rate = cfg.channels, int(cfg.sample_rate * cfg.seconds), \
        int(cfg.sample_rate)
    n_fft, hop, window = cfg.stft.n_fft, cfg.stft.hop, cfg.stft.window
    lat, bins = n_fft - hop, n_fft // 2 + 1
    gain = np.full(bins, 10.0 ** (-6.0 / 20.0), np.float32)
    f = np.arange(bins) * rate / n_fft
    gain[(f >= 1000.0) & (f <= 2000.0)] = 0.0
    blk = int(2.0 * rate) // hop * hop  # the stft tool's block
    nblk = -(-t // blk)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((c, t), generator=gen, device=dev)
    xp = F.pad(x, (0, nblk * blk - t))  # the tool pads its last block
    blocks = [xp[:, i * blk:(i + 1) * blk] for i in range(nblk)]
    x_host = x.cpu().numpy()
    t0 = time.perf_counter()
    golden = wola_f64(x_host[:CZ_GOLDEN_CHANNELS], gain.astype(np.float64),
                      n_fft, hop, window)
    glo, ghi = n_fft + lat, golden.shape[-1] - 2 * n_fft
    log(f"[config4] config 4 ({cfg.name}): {c} x {t}, n_fft {n_fft}, hop "
        f"{hop}, periodic {window}, gain -6 dB with a 1-2 kHz notch; "
        f"streamed in {nblk} blocks of {blk} (the stft tool's, the last "
        f"zero-padded); float64 WOLA of {CZ_GOLDEN_CHANNELS} channels in "
        f"{time.perf_counter() - t0:.1f} s")
    lo, hi = lat + n_fft, t - n_fft  # the interior, in stream samples

    def run(stage, pieces):
        st = stage.init_state((c,), device=dev)
        outs = []
        for piece in pieces:
            y, st = stage.apply(piece, st)
            outs.append(y)
        outs.append(stage.flush(st))
        return torch.cat(outs, -1)

    times, one_ref, streamed_ref = {}, None, None
    nf_blk, nf_one = blk // hop, nblk * blk // hop
    for engine in ("reference", "wdft", "cwola"):
        stage = SpectralGainStage(gain, n_fft=n_fft, hop=hop, window=window,
                                  engine=engine)
        one = run(stage, [xp])
        streamed = run(stage, blocks)
        torch.cuda.synchronize()
        if streamed.shape != (c, nblk * blk + lat) or not (
                bool(torch.isfinite(streamed).all())
                and bool((streamed[:, :lat] == 0).all())):
            raise RuntimeError(f"config 4 {engine}: bad output "
                               f"{tuple(streamed.shape)}")
        if engine == "reference":
            check(f"{engine}: streamed vs one shot, every sample",
                  device_snr_db(one[:, lat:lat + t],
                                streamed[:, lat:lat + t]), STFT_STREAM_DB)
            comp = run(composite_path(gain, n_fft, hop, window, dev),
                       blocks)
            spec = stft(x, n_fft=n_fft, hop=hop, window=window)
            y_ops = istft(spec * torch.from_numpy(gain).to(dev), n_fft=n_fft,
                          hop=hop, window=window, length=t)
            # up to T - n_fft: beyond it the stage's frames reach into the
            # tool's zero padding, and istft's stop at the signal's end
            check(f"istft(gain * stft(x)) vs the streamed stage's composite "
                  f"path on cuFFT, samples [0, {t - n_fft})", device_snr_db(
                      y_ops[:, :t - n_fft], comp[:, lat:lat + t - n_fft]),
                  STFT_STREAM_DB)
            # the stage runs the wola_gain kernel, whose FFT is its own: on
            # the interior two float32 computations of the same WOLA (held
            # as two engines are), and every sample of the stream, its start
            # included, held to cuFFT's error against float64
            check(f"istft(gain * stft(x)) (cuFFT) vs the streamed stage "
                  f"(the wola_gain kernel), interior [{lo}, {hi})",
                  device_snr_db(y_ops[:, lo:hi],
                                streamed[:, lat + lo:lat + hi]),
                  STFT_INTERIOR_DB)
            rows = CZ_GOLDEN_CHANNELS
            held_to_cufft(
                f"the stage streamed in the tool's blocks, {rows} channels, "
                f"every sample", streamed[:rows, :nblk * blk],
                comp[:rows, :nblk * blk], reference_stft.stream(
                    xp[:rows], gain.astype(np.float64), n_fft, hop))
            del spec, y_ops, comp
            one_ref, streamed_ref = one[:, :t].cpu(), streamed[:, :t].cpu()
        else:
            check(f"{engine}: streamed vs one shot, interior [{lo}, {hi})",
                  device_snr_db(one[:, lo:hi], streamed[:, lo:hi]),
                  STFT_INTERIOR_DB)
        ys = streamed[:CZ_GOLDEN_CHANNELS, lat:lat + golden.shape[-1]]
        check(f"{engine}: {CZ_GOLDEN_CHANNELS} channels vs float64 WOLA, "
              f"min channel, interior", min_channel_snr_db(
                  golden[:, glo:ghi], ys.cpu().numpy()[:, glo:ghi]),
              STFT_GOLDEN_DB)
        del one, streamed
        st = stage.init_state((c,), device=dev)
        block_ms = cuda_ms(lambda: stage.apply(blocks[1], st), iters=10)
        enqueue_ms = host_ms(lambda: stage.apply(blocks[1], st), iters=10)
        one_ms = cuda_ms(lambda: stage.apply(
            xp, stage.init_state((c,), device=dev)), iters=3, warmup=1)
        times[engine] = block_ms
        # bounds: the input read and the output written once; the
        # products a frame (a real FFT ~2.5 n log2 n operations, the wdft
        # tables 2 x n x 2 bins MACs, the composed map n^2 MACs), fp32
        fft_ops = 2 * 2.5 * n_fft * np.log2(n_fft)
        ops = {"reference": fft_ops, "wdft": 2 * 2 * n_fft * 2 * bins,
               "cwola": 2 * n_fft * n_fft}[engine]
        for what, ms, nf, n_in in (
                (f"tool block (the host enqueues it in {enqueue_ms:.3f} ms)",
                 block_ms, nf_blk, blk),
                ("one shot", one_ms, nf_one, nblk * blk)):
            b, by = fir_bound_ms(ops * nf * c, 2 * 4.0 * c * n_in)
            log(f"[time] config 4 {engine:9s} {c}x{n_in} {what}: {ms:.3f} ms "
                f"({c * n_in / ms / 1e3:.0f} Msamples/s), bound {b:.3f} ms "
                f"({by}) on {smi}")
        torch.cuda.empty_cache()
    auto = SpectralGainStage(gain, n_fft=n_fft, hop=hop).engine
    fastest = min(times, key=times.get)
    log(f"[config4] engine='auto' takes {auto!r}; the fastest at the tool's "
        f"block is {fastest!r} ({times[fastest]:.3f} ms, {auto!r} "
        f"{times[auto]:.3f} ms)")
    if times[auto] > 1.5 * times[fastest]:
        raise RuntimeError(f"engine='auto' takes {auto!r}, 1.5x slower than "
                           f"{fastest!r} on this card")
    # the frames each engine synthesised, and which one a block through
    # engine="auto" counts under
    from llzlab_tpu_torch.runtime.profiler import counters

    auto_stage = SpectralGainStage(gain, n_fft=n_fft, hop=hop)
    before = counters()["frames"]
    auto_stage.apply(blocks[1], auto_stage.init_state((c,), device=dev))
    frames = counters()["frames"]
    took = {k: v - before.get(k, 0) for k, v in frames.items()
            if v != before.get(k, 0)}
    log(f"[config4] frames by engine so far {frames}; a tool block through "
        f"engine='auto' counts {took} ({c} x {nf_blk}); a tool block takes "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    if took != {auto: c * nf_blk}:
        raise RuntimeError(f"engine='auto' counted {took}, not {auto!r}")
    wola_entry = wola_gain_at_the_step(dev, smi, blocks[1], gain, n_fft,
                                       hop, window)
    del xp, blocks, x, auto_stage
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # ---- the stft tool, file to file --------------------------------
        wav = os.path.join(tmp, "c4.wav")
        write_wav(wav, x_host, rate)
        _, msps = stft_cli.main(["-i", wav, "-o", wav + ".out", "--gain-db",
                                 "-6", "--notch", "1000", "2000"])
        y, r = read_wav(wav + ".out")
        if r != rate or y.shape != (c, t):
            raise RuntimeError(f"stft tool: {y.shape} at {r} Hz")
        same = bool(np.array_equal(y, streamed_ref.numpy()))
        check(f"stft tool ({msps:.1f} Msamples/s file to file, its own "
              f"clock) vs the stage's one shot, {y.shape}; bitwise the "
              f"stage streamed in its blocks: {same}",
              min_channel_snr_db(one_ref.numpy()[:, lat:], y[:, lat:]),
              STFT_STREAM_DB)
        del y, one_ref, streamed_ref, x_host

        # ---- the channelizer tool: 1 rank, and 4 ranks of cuda:0 --------
        ch = Channelizer(fir_taps=firwin(1024, 0.4, window="hamming"),
                         fft_n=2048, fir_method="ols", device=dev)
        specs = []
        for run in CZ_TOOL_RUNS:
            args = list(run) + CZ_TOOL_ARGS
            out, mlog = (os.path.join(tmp, f"cz{len(specs)}{e}")
                         for e in (".npz", ".jsonl"))
            t0 = time.perf_counter()
            cz_cli.main(["-o", out, "--metrics", mlog] + args)
            wall = time.perf_counter() - t0
            with open(mlog) as fh:
                step = [json.loads(v) for v in fh if '"stage"' in v][0]
            with np.load(out) as z:
                spec = torch.from_numpy(z["spectra"]).to(dev)
                if (int(z["rate"]), int(z["fft_n"])) != (rate * 147 // 160,
                                                        2048):
                    raise RuntimeError(f"channelizer tool: rate "
                                       f"{int(z['rate'])}, fft_n "
                                       f"{int(z['fft_n'])}")
            c_in, n = int(run[1]), int(float(run[3]) * rate)
            log(f"[time] channelizer tool {' '.join(args)}: the step "
                f"{step['seconds']:.3f} s ({step['msps']:.0f} Msamples/s, "
                f"the step's first call), file to file {wall:.1f} s "
                f"({c_in * n / wall / 1e6:.1f} Msamples/s) with the "
                f"synthesis of its input, on {smi}")
            # the tool's noise: its first rows are the first draws of the
            # seed, and it keeps a multiple of the step's block_multiple
            m = ch.block_multiple() * (4 if "--mesh-time" in run else 1)
            x8 = np.random.default_rng(0).standard_normal(
                (CZ_GOLDEN_CHANNELS, n)).astype(np.float32)[:, :n // m * m]
            got, _ = ch.step(torch.from_numpy(x8).to(dev),
                             ch.init_state(CZ_GOLDEN_CHANNELS))
            check(f"channelizer tool {' '.join(run)}, spectra "
                  f"{tuple(spec.shape)}, vs Channelizer.step on its first "
                  f"{CZ_GOLDEN_CHANNELS} channels",
                  device_snr_db(got, spec[:CZ_GOLDEN_CHANNELS]),
                  SHARDED_FLOOR_DB)
            specs.append(spec)
            del got, x8
        if specs[1].shape != specs[2].shape:
            raise RuntimeError(f"channelizer tool: {tuple(specs[1].shape)} "
                               f"on 1 rank, {tuple(specs[2].shape)} on 4")
        check(f"channelizer tool, 4 ranks vs 1 rank, spectra "
              f"{tuple(specs[1].shape)}", device_snr_db(specs[1], specs[2]),
              SHARDED_FLOOR_DB)
        del specs, spec
        torch.cuda.empty_cache()

    # ---- fir_filter(block2) beyond B2's envelope: tensor code ----------
    taps = firwin(3001, 0.2)
    block = block2_block(len(taps))
    xa = torch.randn((2, 9000), generator=gen, device=dev)
    before = bf.block2_fir_cuda.launches
    ya = fir_filter(xa, taps, method="block2")
    if bf.block2_fir_cuda.launches != before or bf.cuda_supports(
            2, len(taps), block, 9000):
        raise RuntimeError("fir_filter(block2) at 3001 taps launched B2")
    ref = bf.block2_fir_plain(F.pad(xa, (block, 0)).double(), taps, block,
                              "highest")
    check("fir_filter(block2) at 3001 taps on the card, no B2 launch, vs "
          "float64", device_snr_db(ref, ya), 120.0)
    check("the same vs its CPU run", device_snr_db(
        fir_filter(xa.cpu(), taps, method="block2").to(dev), ya), 120.0)

    # ---- B2 on 65 536 + 8 rows of 1152 samples -------------------------
    taps = firwin(NTAPS, CUTOFF, window="hamming")
    block = block2_block(NTAPS)
    rows = 65536 + 8
    xr = torch.randn((rows, block + 1152), generator=gen, device=dev)
    err = 0.0
    for mode in MODES:
        chunks = bf.row_chunks(rows, mode)
        before = bf.block2_fir_cuda.launches
        y = bf.block2_fir_cuda(xr, taps, block, mode)
        if bf.block2_fir_cuda.launches != before + len(chunks):
            raise RuntimeError(f"block2_fir {mode}: {rows} rows counted "
                               f"{bf.block2_fir_cuda.launches - before} "
                               f"launches, ran {len(chunks)}")
        for r0, r1 in ((0, bf.MAX_ROWS), (bf.MAX_ROWS, rows)):
            if not torch.equal(y[r0:r1], bf.block2_fir_cuda(
                    xr[r0:r1], taps, block, mode)):
                raise RuntimeError(f"block2_fir {mode}: rows {r0}:{r1} of "
                                   f"one call != their own launch")
        tail = xr[-64:]
        err = max(err, float((y[-64:] - bf.block2_fir_plain(
            tail, taps, block, mode)).abs().max()))
        check(f"block2_fir {mode} on {rows} rows in {len(chunks)} "
              f"launch(es), bitwise launches of <= {bf.MAX_ROWS} rows; last "
              f"64 rows vs plain f64", device_snr_db(bf.block2_fir_plain(
                  tail.double(), taps, block, "highest"), y[-64:]),
              KERNEL_FLOOR_DB[mode])
    del xr, y
    torch.cuda.empty_cache()
    return err, wola_entry


def config_3_and_tool(dev, smi):
    """Phase 8: config 3 at its published size through ``SOSStage`` (the
    scan engine, on the scan kernel), ``sosfilt_matmul``, ``sosfilt_auto``
    and the ``iir`` tool, with their times, and the scan kernel alone
    beside its bound and the tensor cascade.  Returns the scan kernel's
    entry of the ``kernels`` line: its launches on those paths (each
    ``sosfilt`` call on the card one, raises otherwise) and its times;
    raises on any failure."""
    import tempfile

    import scipy.signal as ss
    import torch
    import torch.nn.functional as F

    from llzlab_tpu_torch import (Chain, SOSStage, peaking_eq_sos,
                                  sosfilt_matmul)
    from llzlab_tpu_torch.cli import iir as iir_cli
    from llzlab_tpu_torch.io.wav import read_wav, write_wav
    from llzlab_tpu_torch.kernels import sos_scan
    from llzlab_tpu_torch.ops import iir, iir_matmul, iir_select
    from llzlab_tpu_torch.ops.iir import sos_plan
    from llzlab_tpu_torch.runtime.profiler import counters, profile_calls

    def check(what, got_db, floor, strict=False):
        log(f"[config3] {what}: {got_db:.1f} dB (floor {floor})")
        if not (got_db > floor if strict else got_db >= floor):
            raise RuntimeError(f"{what}: {got_db:.1f} dB below {floor}")

    cfg = load_config("iir_eq_64ch")
    ic = cfg.iir
    c, t, rate = cfg.channels, int(cfg.sample_rate * cfg.seconds), \
        int(cfg.sample_rate)
    L = ic.block_size
    sos = peaking_eq_sos(ic.freqs, ic.gains_db, ic.sample_rate, q=ic.q)
    ns = len(sos)
    blk = int(2.0 * rate) // L * L  # the iir tool's block
    nblk = -(-t // blk)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((c, t), generator=gen, device=dev)
    xp = F.pad(x, (0, nblk * blk - t))  # the tool pads its last block
    blocks = [xp[:, i * blk:(i + 1) * blk] for i in range(nblk)]
    stage = SOSStage(sos, block_size=L)
    chain = Chain([stage])
    # every sosfilt call of the paths below, up to the iir tool, is on the
    # card: one launch of the scan kernel each
    launches0 = sos_scan.sos_scan_cuda.launches
    applies0 = counters()["calls"].get("Chain.apply", 0)
    log(f"[config3] config 3 ({cfg.name}): {c} x {t}, {ns} peaking "
        f"sections ({', '.join(sorted(set(sos_plan(sos)[0])))} form), "
        f"scan blocks of {L}; streamed in {nblk} blocks of {blk} (the iir "
        f"tool's, the last zero-padded)")

    def run(pieces):
        st = chain.init_state((c,), device=dev)
        outs = []
        for piece in pieces:
            y, st = chain.apply(piece, st)
            outs.append(y)
        return torch.cat(outs, -1), st[0]

    one, zf_one = run([x])
    streamed, _ = run(blocks)
    cuts = (30 * L, 77 * L)
    three, zf_three = run([x[:, :cuts[0]], x[:, cuts[0]:cuts[1]],
                           x[:, cuts[1]:]])
    if one.shape != (c, t) or not bool(torch.isfinite(one).all()):
        raise RuntimeError(f"config 3: bad output {tuple(one.shape)}")
    same = bool(torch.equal(streamed[:, :t], one))
    same3 = bool(torch.equal(three, one)) and bool(torch.equal(zf_three,
                                                               zf_one))
    log(f"[config3] streamed in the tool's blocks == one shot bitwise: "
        f"{same}; split at {cuts[0]} and {cuts[1]} == one shot bitwise, "
        f"output and states: {same3}")
    if not (same and same3):
        raise RuntimeError("config 3: streamed != one shot")
    del three, zf_three

    ref = ss.sosfilt(sos, x[:CZ_GOLDEN_CHANNELS].double().cpu().numpy(),
                     axis=-1)
    check(f"scan engine (SOSStage), {CZ_GOLDEN_CHANNELS} channels vs scipy "
          f"float64 sosfilt, min channel",
          min_channel_snr_db(ref, one[:CZ_GOLDEN_CHANNELS].cpu().numpy()),
          IIR_SCAN_DB)
    y_mm = sosfilt_matmul(sos, x)
    check(f"sosfilt_matmul (L = 254), {CZ_GOLDEN_CHANNELS} channels vs "
          f"scipy float64 sosfilt, min channel",
          min_channel_snr_db(ref, y_mm[:CZ_GOLDEN_CHANNELS].cpu().numpy()),
          IIR_MATMUL_DB, strict=True)

    # ---- sosfilt_auto against the packaged artifact of this card -------
    kind = torch.cuda.get_device_name(dev)
    path = iir_select.calib_path(kind)
    if not os.path.exists(path):
        raise RuntimeError(f"no calibration artifact for {kind!r} ({path})")
    with open(path) as f:
        art = json.load(f)
    meets = [r for r in art["measured"]
             if r["snr"] - iir_select.SNR_MARGIN_DB >= 80.0]
    best = max(meets, key=lambda r: r["msps"])
    expect = (best["engine"], best["precision"])
    got = iir_select.select_engine(dev, min_snr_db=80.0)
    got_exact = iir_select.select_engine(dev, bit_exact_carry=True)
    log(f"[config3] sosfilt_auto on {kind}: min_snr_db=80 -> {got} (the "
        f"artifact's fastest row meeting it: {expect}, "
        f"{best['msps']} Msamples/s, {best['snr']} dB); "
        f"bit_exact_carry=True -> {got_exact}")
    if got != expect or got_exact != ("scan", "f32"):
        raise RuntimeError(f"sosfilt_auto took {got} / {got_exact}")
    direct = one if got[0] == "scan" else sosfilt_matmul(sos, x,
                                                         precision=got[1])
    if not (torch.equal(iir_select.sosfilt_auto(sos, x, min_snr_db=80.0),
                        direct)
            and torch.equal(iir_select.sosfilt_auto(
                sos, x, bit_exact_carry=True, block_size=L), one)):
        raise RuntimeError("sosfilt_auto's output != its engine's")
    del direct, y_mm

    # ---- the iir tool, file to file --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "c3.wav")
        write_wav(wav, x.cpu().numpy(), rate)
        eq = [f"{f}:{g}" for f, g in zip(ic.freqs, ic.gains_db)]
        _, msps = iir_cli.main(["-i", wav, "-o", wav + ".out", "--eq", *eq,
                                "--q", str(ic.q), "--block-size", str(L)])
        y, r = read_wav(wav + ".out")
    same = r == rate and bool(np.array_equal(
        y, streamed[:, :t].cpu().numpy()))
    log(f"[config3] iir tool file to file: {msps:.1f} Msamples/s (its own "
        f"clock), {y.shape} at {r} Hz, bitwise the streamed stage: {same}")
    if not same:
        raise RuntimeError("iir tool output != the streamed stage")
    del y, streamed, one
    scans = sos_scan.sos_scan_cuda.launches - launches0
    calls = (counters()["calls"].get("Chain.apply", 0) - applies0
             + (got[0] == "scan") + 1)  # the two sosfilt_auto calls
    log(f"[config3] {SCAN_KERNEL} launches on the stage, sosfilt_auto and "
        f"the iir tool: {scans}, for {calls} sosfilt calls on the card")
    if scans != calls:
        raise RuntimeError(f"{SCAN_KERNEL}: {scans} launches for {calls} "
                           f"sosfilt calls")

    # ---- the memory a captured graph of the matmul engine holds ---------
    st = stage.init_state((c,), device=dev)

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    iir_matmul.clear_graphs()
    before = reserved()  # a first capture also makes the capture stream's
    sosfilt_matmul(sos, blocks[1], zi=st, return_zf=True)  # cuBLAS
    iir_matmul.clear_graphs()  # workspace, which it keeps for the process
    log(f"[config3] sosfilt_matmul's capture stream keeps "
        f"{(reserved() - before) / 2**20:.1f} MiB reserved once a process "
        f"(its cuBLAS workspace)")
    for what, v in (("tool block", blocks[1]), ("one shot", x)):
        before = reserved()
        sosfilt_matmul(sos, v, zi=st, return_zf=True)
        graphs, held = len(iir_matmul._graphs), reserved() - before
        dropped = iir_matmul.clear_graphs()
        back = reserved() - before
        log(f"[config3] sosfilt_matmul {what} {tuple(v.shape)}: {graphs} "
            f"graph(s) captured (at most {iir_matmul.GRAPH_MAX_SAMPLES} "
            f"samples), holding {held / 2**20:.1f} MiB reserved; after "
            f"clear_graphs() ({dropped} dropped) {back / 2**20:.1f} MiB")
        if graphs != int(c * v.shape[-1] <= iir_matmul.GRAPH_MAX_SAMPLES) \
                or dropped != graphs or back != 0:
            raise RuntimeError(f"sosfilt_matmul {what}: {graphs} graphs, "
                               f"{dropped} dropped, {back} bytes kept")

    # ---- times: per tool block and per one shot -------------------------
    engines = (
        ("scan (SOSStage.apply)", lambda v: stage.apply(v, st)),
        ("matmul (sosfilt_matmul)",
         lambda v: sosfilt_matmul(sos, v, zi=st, return_zf=True)),
    )
    for name, fn in engines:
        for what, v, iters in (("tool block", blocks[1], 10),
                               ("one shot", x, 3)):
            ms = cuda_ms(lambda: fn(v), iters=iters, warmup=1)
            enqueue_ms = host_ms(lambda: fn(v), iters=iters, warmup=0)
            prof = profile_calls(lambda: fn(v))
            seen = ("not measured (the profiler saw no device time)"
                    if prof is None else
                    f"{prof.kernels:.0f} kernels and {prof.copies:.0f} "
                    f"copies, {prof.busy_ms:.3f} ms of device time in "
                    f"{prof.event_ms:.3f} ms, idle {prof.idle_pct:.0f} %")
            path = ("" if name.startswith("scan") else
                    ", a CUDA graph replayed" if c * v.shape[-1]
                    <= iir_matmul.GRAPH_MAX_SAMPLES else ", eager")
            n = v.shape[-1]
            # the function reads x and writes y once (5 multiply-adds a
            # sample a section, fp32); a pass per section moves both ns
            # times
            b, by = fir_bound_ms(2.0 * 5 * ns * c * n, 2 * 4.0 * c * n)
            log(f"[time] config 3 {name} {c}x{n} {what}{path}, host "
                f"enqueue {enqueue_ms:.3f} ms, per apply under the "
                f"profiler {seen}: {ms:.3f} ms ({c * n / ms / 1e3:.0f} "
                f"Msamples/s), bound {b:.4f} ms ({by}); a pass per section "
                f"{ns * b:.3f} ms; on {smi}")

    # ---- the scan kernel alone, beside its bound and the tensor cascade -
    kinds, params = sos_plan(sos)
    zi = torch.randn((c, ns, 2), generator=gen, device=dev)
    wide = 4 * L
    shapes = (("a scan block", c, L, L, 50), ("one shot", c, t, L, 5),
              ("8 channels", 8, t, L, 5), ("one channel", 1, t, L, 5),
              (f"one shot in blocks of {wide}, the wide variant", c, t,
               wide, 5))
    times = {}
    for what, rows, n, blk_n, iters in shapes:
        v = x[:rows, :n].contiguous()
        zr = zi[:rows].contiguous()
        tables = sos_scan.scan_tables(sos, blk_n, dev)
        y_k, zf_k = sos_scan.sos_scan_cuda(v, tables, zr, return_zf=True)
        y_t, zf_t = iir._cascade(kinds, params, v, zr, blk_n)
        same = bool(torch.equal(y_k, y_t)) and bool(torch.equal(zf_k, zf_t))
        del y_k, zf_k, y_t, zf_t
        ms = cuda_ms(lambda: sos_scan.sos_scan_cuda(v, tables, zr, True),
                     iters=iters)
        tensor_ms = cuda_ms(lambda: iir._cascade(kinds, params, v, zr,
                                                 blk_n), iters=3, warmup=1)
        bound = 8.0 * rows * n / HBM_RATE * 1e3  # x read, y written, fp32
        times[f"{rows}x{n} L={blk_n}"] = (ms, tensor_ms, bound)
        log(f"[time] config 3 scan kernel {SCAN_KERNEL} {rows}x{n} {what}, "
            f"blocks of {blk_n}{' (wide)' if tables.wide else ''}: "
            f"{ms:.4f} ms, one launch ({rows * n / ms / 1e3:.0f} "
            f"Msamples/s), bound {bound:.5f} ms (bytes: 8 B a sample), "
            f"{100 * bound / ms:.3f} % of it; the tensor cascade on the "
            f"card {tensor_ms:.3f} ms ({tensor_ms / ms:.2f}x the kernel's); "
            f"bitwise equal, output and states: {same}; on {smi}")
        if not same:
            raise RuntimeError(f"scan kernel != tensor cascade at "
                               f"{rows}x{n}, blocks of {blk_n}")
    del x, xp, blocks
    torch.cuda.empty_cache()
    ms, tensor_ms, bound = times[f"{c}x{L} L={L}"]
    return {"launches": scans,
            "launches_by_path": {"config 3 (stage, sosfilt_auto, iir tool)":
                                 scans},
            "max_abs_err": 0.0, "ms": ms, "plain_ms": tensor_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "ms_by_shape": {k: v[0] for k, v in times.items()},
            "plain_ms_by_shape": {k: v[1] for k, v in times.items()},
            "bound_ms_by_shape": {k: v[2] for k, v in times.items()}}


def remaining_ops(dev, smi):
    """Phase 9: every device op of queue A slice 7 on the card ``dev`` at
    the BASELINE configs' widths, each output held against scipy / numpy
    float64 on the host (``P9_HOST_CHANNELS`` channels of it), then timed
    with CUDA events beside its bound.  Raises on any failure."""
    import scipy.fft as sf
    import scipy.signal as ss
    import torch

    import llzlab_tpu_torch as lt
    from llzlab_tpu_torch.ops import compat
    from llzlab_tpu_torch.ops.dct import dct, dst, idct, idst
    from llzlab_tpu_torch.ops.mdct import imdct, mdct, mdct_matrix, sine_window
    from llzlab_tpu_torch.utils.profiling import StageTimer, roofline_report

    hc = P9_HOST_CHANNELS
    t = int(P9_SECONDS_RATE[0] * P9_SECONDS_RATE[1])
    fs = float(P9_SECONDS_RATE[1])

    def host(v, n=hc):
        """The first ``n`` rows of ``v`` (all of a 1-D ``v``) in float64
        or complex128 on the host."""
        v = v[:n] if v.dim() > 1 else v
        return v.detach().cpu().numpy().astype(
            np.complex128 if v.is_complex() else np.float64)

    def on_dev(what, *outs):
        for o in outs:
            if not isinstance(o, torch.Tensor) or o.device != dev:
                raise RuntimeError(f"{what}: output not on {dev}")

    def check_db(what, ref, out, floor):
        """``out`` (on ``dev``) against the float64 ``ref`` of its first
        channels (of all of a 1-D ``out``)."""
        got = host(out)
        if got.ndim == 1:
            ref, got = np.asarray(ref)[None], got[None]
        got_db = min_channel_snr_db(ref, got)
        log(f"[phase9] {what}: min-channel SNR vs float64 {got_db:.1f} dB "
            f"(floor {floor})")
        if not got_db >= floor:
            raise RuntimeError(f"{what}: {got_db:.1f} dB below {floor}")

    def check_abs(what, got, want, atol):
        err = float(np.max(np.abs(got - want)))
        log(f"[phase9] {what}: max abs error vs float64 {err:.3g} (atol "
            f"{atol:.3g})")
        if not err <= atol:
            raise RuntimeError(f"{what}: max abs error {err} above {atol}")

    def time_op(what, shape, fn, nbytes, flop, method_flop=None, iters=5):
        """``flop`` counts the function's own least work; ``method_flop``,
        where given, the work of the method the port runs for it."""
        ms = cuda_ms(fn, iters=iters, warmup=1)
        b, by = fir_bound_ms(flop, nbytes)
        method = ""
        if method_flop is not None:
            mb, mby = fir_bound_ms(method_flop, nbytes)
            method = (f"; the port's method's own bound {mb:.4g} ms ({mby}; "
                      f"{100.0 * mb / ms:.3g} %)")
        log(f"[time] phase 9 {what} {shape}: {ms:.4f} ms, bound {b:.4g} ms "
            f"({by}; {100.0 * b / ms:.3g} % of it){method} on {smi}")

    def fft_flop(n, real=True):
        return (2.5 if real else 5.0) * n * np.log2(n)

    gen = torch.Generator(device=dev).manual_seed(9)
    c4, c3, c2 = (P9_CHANNELS[k] for k in ("config 4", "config 3",
                                            "config 2"))
    x4 = torch.randn((c4, t), generator=gen, device=dev)
    y4 = 0.5 * x4 + torch.randn((c4, t), generator=gen, device=dev)
    x3 = torch.randn((c3, t), generator=gen, device=dev)
    x2 = torch.randn((c2, t), generator=gen, device=dev)
    log(f"[phase9] inputs: torch.randn on {dev} from torch.Generator seed "
        f"9, in this order: x {c4}x{t} (config 4), y = 0.5 x + noise, "
        f"{c3}x{t} (config 3), {c2}x{t} (config 2); float64 checks on the "
        f"first {hc} channels of each output")

    # ---- config 4's 256 x 480 000: spectrogram, PSDs --------------------
    n_fft, hop = 2048, 512
    S = lt.spectrogram(x4, n_fft=n_fft, hop=hop, window="hann")
    on_dev("spectrogram", S)
    w = lt.get_window("hann", n_fft, periodic=True)
    fr = np.lib.stride_tricks.sliding_window_view(host(x4), n_fft,
                                                  axis=-1)[:, ::hop]
    check_db(f"spectrogram {tuple(S.shape)} (n_fft {n_fft}, hop {hop}, "
             f"Hann)", np.abs(np.fft.rfft(fr * w)) ** 2, S,
             P9_FLOOR_DB["psd"])
    nf = S.shape[-2]
    time_op("spectrogram", f"{c4}x{t}",
            lambda: lt.spectrogram(x4, n_fft=n_fft, hop=hop),
            4.0 * (x4.numel() + S.numel()), c4 * nf * fft_flop(n_fft))
    del S, fr
    kw = dict(fs=fs, nperseg=2048)
    nseg = (t - 2048) // 1024 + 1
    timer = StageTimer()
    f, p = timer.time_fn("welch", lt.welch, x4, **kw)
    on_dev("welch", p)
    check_db(f"welch {tuple(p.shape)} (nperseg 2048, 50 %)",
             ss.welch(host(x4), **kw)[1], p, P9_FLOOR_DB["psd"])
    _, pxy = lt.csd(x4, y4, **kw)
    on_dev("csd", pxy)
    check_db("csd", ss.csd(host(x4), host(y4), **kw)[1], pxy,
             P9_FLOOR_DB["psd"])
    _, coh = lt.coherence(x4, y4, **kw)
    on_dev("coherence", coh)
    check_db("coherence", ss.coherence(host(x4), host(y4), **kw)[1], coh,
             P9_FLOOR_DB["psd"])
    fp, pp = lt.periodogram(x4, fs=fs)
    on_dev("periodogram", pp)
    check_db(f"periodogram {tuple(pp.shape)}",
             ss.periodogram(host(x4), fs=fs)[1], pp, P9_FLOOR_DB["psd"])
    psd0 = host(p, 1)[0]
    peaks, _ = compat.find_peaks(psd0, distance=8)
    want, _ = ss.find_peaks(psd0, distance=8)
    log(f"[phase9] find_peaks on channel 0's Welch PSD (host): "
        f"{len(peaks)} peaks, scipy's: {np.array_equal(peaks, want)}")
    if not np.array_equal(peaks, want):
        raise RuntimeError("find_peaks != scipy.signal.find_peaks")
    welch_bytes = 4.0 * x4.numel()
    time_op("welch", f"{c4}x{t}", lambda: lt.welch(x4, **kw), welch_bytes,
            c4 * nseg * fft_flop(2048))
    time_op("csd", f"{c4}x{t}", lambda: lt.csd(x4, y4, **kw),
            2 * welch_bytes, 2 * c4 * nseg * fft_flop(2048))
    time_op("coherence", f"{c4}x{t}", lambda: lt.coherence(x4, y4, **kw),
            2 * welch_bytes, 2 * c4 * nseg * fft_flop(2048))
    time_op("periodogram", f"{c4}x{t}", lambda: lt.periodogram(x4, fs=fs),
            4.0 * (x4.numel() + pp.numel()), c4 * fft_flop(t))
    rep = roofline_report(seconds=timer.totals["welch"],
                          bytes_moved=welch_bytes,
                          device_kind=torch.cuda.get_device_name(dev))
    log(f"[phase9] StageTimer around the first welch call (host clock, "
        f"synchronised): {timer.report().strip()}; roofline_report: "
        f"{rep['achieved_gbps']:.1f} of {rep['peak_gbps']:.0f} GB/s")
    del x4, y4, p, pxy, coh, pp

    # ---- config 3's 64 x 480 000 ----------------------------------------
    xs = host(x3)
    a = lt.hilbert(x3)
    env = lt.analytic_envelope(x3)
    on_dev("hilbert", a, env)
    golden = ss.hilbert(xs, axis=-1)
    check_db(f"hilbert {tuple(a.shape)}", golden, a, P9_FLOOR_DB["hilbert"])
    check_db("analytic_envelope", np.abs(golden), env,
             P9_FLOOR_DB["hilbert"])
    time_op("hilbert", f"{c3}x{t}", lambda: lt.hilbert(x3),
            4.0 * x3.numel() * 3, 2 * c3 * fft_flop(t, real=False))
    time_op("analytic_envelope", f"{c3}x{t}",
            lambda: compat.analytic_envelope(x3), 4.0 * x3.numel() * 2,
            2 * c3 * fft_flop(t, real=False))
    del a, env, golden
    ramp = x3 + torch.linspace(-1.0, 1.0, t, device=dev)
    d = lt.detrend(ramp)
    on_dev("detrend", d)
    check_db("detrend (linear; the input plus a ramp)",
             ss.detrend(host(ramp), type="linear"), d, P9_FLOOR_DB["detrend"])
    time_op("detrend", f"{c3}x{t}", lambda: lt.detrend(ramp),
            4.0 * x3.numel() * 2, 5.0 * x3.numel())
    del ramp, d
    sg = lt.savgol_filter(x3, 101, 3)
    on_dev("savgol_filter", sg)
    check_db("savgol_filter (101, 3, interp)",
             ss.savgol_filter(xs, 101, 3, axis=-1), sg, P9_FLOOR_DB["smooth"])
    nfft = 1 << (t + 200 - 1).bit_length()
    time_op("savgol_filter", f"{c3}x{t}",
            lambda: lt.savgol_filter(x3, 101, 3), 4.0 * x3.numel() * 2,
            3 * c3 * fft_flop(nfft))
    del sg
    med = lt.medfilt(x3, 5)
    on_dev("medfilt", med)
    check_abs("medfilt (5)", host(med),
              np.stack([ss.medfilt(r, 5) for r in xs]), P9_MEDFILT_ATOL)
    # a sorting network of 5: 9 compare-exchanges an output
    time_op("medfilt", f"{c3}x{t}", lambda: lt.medfilt(x3, 5),
            4.0 * x3.numel() * 2, 9.0 * x3.numel())
    del med
    wn = lt.wiener(x3, 5)
    on_dev("wiener", wn)
    check_db("wiener (5)", np.stack([ss.wiener(r, 5) for r in xs]), wn,
             P9_FLOOR_DB["smooth"])
    time_op("wiener", f"{c3}x{t}", lambda: lt.wiener(x3, 5),
            4.0 * x3.numel() * 2, 16.0 * x3.numel())
    del wn
    taps = lt.firwin(1024, 0.25, window="hamming")
    nfft = 1 << (t + 1024 - 1 - 1).bit_length()
    conv_flop = 3 * c3 * fft_flop(nfft)
    for what, fn, golden in (
            ("fftconvolve", lambda: lt.fftconvolve(x3, taps),
             lambda: ss.fftconvolve(xs, taps[None], axes=-1)),
            ("correlate", lambda: lt.correlate(x3, taps),
             lambda: ss.correlate(xs, taps[None], method="fft")),
            ("compat.convolve (same)",
             lambda: compat.convolve(x3, taps, mode="same"),
             lambda: ss.fftconvolve(xs, taps[None], mode="same", axes=-1)),
            ("oaconvolve (valid)",
             lambda: compat.oaconvolve(x3, taps, mode="valid"),
             lambda: ss.oaconvolve(xs, taps[None], mode="valid", axes=-1))):
        y = fn()
        on_dev(what, y)
        check_db(f"{what} {tuple(y.shape)}, config 1's firwin(1024, 0.25)",
                 golden(), y, P9_FLOOR_DB["conv"])
        time_op(what, f"{c3}x{t}", fn, 4.0 * (x3.numel() + y.numel()),
                conv_flop)
    y = compat.convolve(x3[0], taps, method="direct")
    on_dev("compat.convolve (direct)", y)
    check_db("compat.convolve (direct, one row, conv1d)",
             np.convolve(xs[0], taps), y, P9_FLOOR_DB["conv"])
    time_op("compat.convolve (direct)", f"1x{t}",
            lambda: compat.convolve(x3[0], taps, method="direct"),
            4.0 * (t + y.numel()), 2.0 * 1024 * y.numel())
    del y
    m = 4096
    z = lt.zoom_fft(x3, [900.0, 1100.0], m, fs=fs)
    on_dev("zoom_fft", z)
    check_db(f"zoom_fft {tuple(z.shape)} (900-1100 Hz, m {m})",
             ss.zoom_fft(xs, [900.0, 1100.0], m=m, fs=fs, axis=-1), z,
             P9_FLOOR_DB["czt"])
    nfft = 1 << (t + m - 1 - 1).bit_length()
    time_op("zoom_fft", f"{c3}x{t}",
            lambda: lt.zoom_fft(x3, [900.0, 1100.0], m, fs=fs),
            4.0 * x3.numel() + 8.0 * z.numel(),
            2 * c3 * fft_flop(nfft, real=False))
    z = lt.czt(x3[0])
    on_dev("czt", z)
    check_db(f"czt {tuple(z.shape)} (its defaults: the DFT) vs numpy's "
             f"FFT", np.fft.fft(xs[0]), z, P9_FLOOR_DB["czt"])
    nfft = 1 << (2 * t - 1 - 1).bit_length()
    time_op("czt", f"1x{t}", lambda: lt.czt(x3[0]), 4.0 * t + 8.0 * t,
            2 * fft_flop(nfft, real=False))
    del z, x3, xs

    # ---- config 2's 8 x 480 000 -----------------------------------------
    n = P9_MDCT_N
    X = mdct(x2, n)
    on_dev("mdct", X)
    x2h = host(x2)
    frames = np.lib.stride_tricks.sliding_window_view(
        x2h, 2 * n, axis=-1)[:, ::n] * sine_window(2 * n)
    check_db(f"mdct {tuple(X.shape)} (N {n})", frames @ mdct_matrix(n).T,
             X, P9_FLOOR_DB["mdct"])
    del frames
    back = imdct(X, length=t)
    on_dev("imdct", back)
    check_db("imdct(mdct(x)) away from the first and last N",
             x2h[:, n:-n], back[:, n:-n], P9_FLOOR_DB["mdct"])
    nfr = X.shape[-2]
    # the fast MDCT a frame: window and fold 2N samples to N (3N), then an
    # N/2-point complex FFT between two twiddle passes (6N); the port runs
    # the dense (N, 2N) product
    fast_flop = c2 * nfr * (fft_flop(n // 2, real=False) + 9.0 * n)
    mm_flop = 2.0 * c2 * nfr * 2 * n * n
    time_op("mdct", f"{c2}x{t}", lambda: mdct(x2, n),
            4.0 * (x2.numel() + X.numel()), fast_flop, mm_flop)
    time_op("imdct", f"{c2}x{nfr}x{n}", lambda: imdct(X, length=t),
            4.0 * (x2.numel() + X.numel()), fast_flop, mm_flop)
    Xh = host(X)
    for name, fn, inv, golden in (("dct", dct, idct, sf.dct),
                                  ("dst", dst, idst, sf.dst)):
        D = fn(X, type=2, norm="ortho")
        B = inv(D, type=2, norm="ortho")
        on_dev(name, D, B)
        want = golden(Xh, type=2, norm="ortho", axis=-1)
        check_abs(f"{name} (type 2, ortho) {tuple(D.shape)}", host(D), want,
                  P9_DCT_ATOL * np.max(np.abs(want)))
        check_abs(f"i{name}({name}(X))", host(B), Xh,
                  P9_DCT_ATOL * np.max(np.abs(Xh)))
        # the fast DCT / DST a row: a real N-point FFT's work; the port
        # runs the dense (N, N) product
        for what, f_, v in ((name, fn, X), (f"i{name}", inv, D)):
            time_op(what, f"{c2}x{nfr}x{n}",
                    lambda: f_(v, type=2, norm="ortho"),
                    8.0 * X.numel(), c2 * nfr * fft_flop(n),
                    2.0 * c2 * nfr * n * n)
    del X, back, Xh, D, B
    tu = int(P9_UPFIRDN_SECONDS * P9_SECONDS_RATE[1])
    h = lt.resample_taps(147, 160, 64)
    u = compat.upfirdn(h, x2[:, :tu], 147, 160)
    on_dev("upfirdn", u)
    log(f"[phase9] cut: upfirdn runs on {P9_UPFIRDN_SECONDS:g} s of config "
        f"2's signal ({c2}x{tu}), not its 10 s: 147/160 zero-stuffs a row "
        f"to {(tu - 1) * 147 + 1} samples here, {(t - 1) * 147 + 1} on the "
        f"whole file (a 2^27-point FFT a row)")
    check_db(f"upfirdn(resample_taps(147, 160, 64)) {tuple(u.shape)}",
             ss.upfirdn(h, host(x2[:, :tu]), 147, 160), u,
             P9_FLOOR_DB["conv"])
    # the polyphase filter: ceil(len(h) / 147) taps an output sample; the
    # port zero-stuffs and runs three FFTs at nfft
    nfft = 1 << ((tu - 1) * 147 + len(h) - 1).bit_length()
    time_op("upfirdn", f"{c2}x{tu}",
            lambda: compat.upfirdn(h, x2[:, :tu], 147, 160),
            4.0 * (c2 * tu + u.numel() + len(h)),
            2.0 * u.numel() * -(-len(h) // 147), 3 * c2 * fft_flop(nfft))
    del u, x2

    # ---- the rest: lombscargle, and the host functions once each --------
    rng = np.random.default_rng(9)
    tl = np.sort(rng.uniform(0.0, 10.0, 20000))
    yl = np.sin(2 * np.pi * 1.5 * tl) + 0.1 * rng.standard_normal(20000)
    wl = np.linspace(0.5, 30.0, 4096)
    tl_d = torch.from_numpy(tl).to(dev)
    pl = lt.lombscargle(tl_d, yl, wl)
    on_dev("lombscargle", pl)
    want = ss.lombscargle(tl, yl, wl)
    rel = float(np.max(np.abs(host(pl) - want)) / want.max())
    log(f"[phase9] lombscargle (4096 frequencies, 20000 uneven samples from "
        f"numpy's default_rng(9)): max error {rel:.3g} of the peak (JAX "
        f"package's bound 1e-3)")
    if not rel < 1e-3:
        raise RuntimeError(f"lombscargle: {rel} of the peak")
    # sin and cos of 2wt, of wt - tau, and 8 multiply-adds a (f, n) pair
    time_op("lombscargle", "4096x20000", lambda: lt.lombscargle(tl_d, yl, wl),
            8.0 * 3 * 20000 + 4.0 * 4096, 12.0 * 4096 * 20000)
    b, a = ss.butter(6, 0.3)
    sos = lt.butter(8, 0.3, output="sos")
    gd = lt.group_delay(taps, worN=512)[1]
    host_ok = {
        "freqz": np.allclose(lt.freqz(taps, worN=512)[1],
                             ss.freqz(taps, worN=512)[1], atol=1e-12),
        "sosfreqz": np.allclose(lt.sosfreqz(sos, worN=512)[1],
                                ss.freqz(*ss.butter(8, 0.3), worN=512)[1],
                                atol=1e-9),
        "group_delay": np.allclose(gd[5:100], 511.5, atol=0.1),
        "butter/cheby1/ellip (ba)": all(np.allclose(
            ss.freqz(*getattr(lt, n_)(*args, 0.3))[1],
            ss.freqz(*getattr(ss, n_)(*args, 0.3))[1], atol=1e-9)
            for n_, args in (("butter", (6,)), ("cheby1", (5, 1.0)),
                             ("ellip", (4, 1.0, 40.0)))),
        "tf2zpk/zpk2tf": all(np.allclose(u_, v_) for u_, v_ in zip(
            lt.zpk2tf(*lt.tf2zpk(b, a)), (b, a))),
        "sos2tf": all(np.allclose(u_, v_) for u_, v_ in zip(
            lt.sos2tf(sos), ss.sos2tf(sos))),
    }
    log(f"[phase9] host functions against scipy: {host_ok}")
    if not all(host_ok.values()):
        raise RuntimeError(f"host functions: {host_ok}")
    torch.cuda.empty_cache()


def parallel_paths(dev, smi, wrappers):
    """Phase 10: every path of the sharded modules (``parallel/`` and
    ``runtime/``) on ranks of the card ``dev`` at the configs' widths,
    each against its unsharded counterpart; per path the kernel launch
    counts (each kernel nonzero exactly where the path meets it), the
    CUDA-event ms of the sharded call and of the unsharded one, and
    ``collective_traffic``'s bytes beside the analytic model.  Returns
    ``{kernel: {path: launches}}``.  Raises on any failure."""
    import socket
    import tempfile

    import torch

    from llzlab_tpu_torch import (Channelizer, SpectralGainStage, firwin,
                                  peaking_eq_sos, resample_taps, sosfilt)
    from llzlab_tpu_torch.cli import channelizer as cz_cli
    from llzlab_tpu_torch.kernels.halo_ring import check_exchanges
    from llzlab_tpu_torch.ops.fir import fir_filter, fir_state_len
    from llzlab_tpu_torch.ops.resample import resample_poly
    from llzlab_tpu_torch.parallel import sharded_ops as so
    from llzlab_tpu_torch.parallel.mesh import (CHANNEL_MAJOR, TIME_AXIS,
                                                DspMesh, channel_time_spec,
                                                gather, make_dsp_mesh, shard)
    from llzlab_tpu_torch.parallel.spectral_sp import spectral_gain_sharded
    from llzlab_tpu_torch.parallel.stage_pp import (make_stage_mesh,
                                                    stage_pipeline)
    from llzlab_tpu_torch.parallel.tap_tp import fir_filter_tap_parallel
    from llzlab_tpu_torch.runtime import distributed as rd
    from llzlab_tpu_torch.runtime.health import heartbeat
    from llzlab_tpu_torch.runtime.profiler import counters, profile_calls
    from llzlab_tpu_torch.utils.profiling import collective_traffic
    from portbench import reference_stft

    by_path = {name: {} for name in wrappers}
    B1, B2, B3, B4 = ("fused_fir_resample", "block2_fir", "halo_ring",
                      "halo_fir_fused")
    gen = torch.Generator(device=dev).manual_seed(10)

    def run_path(path, expect, fn):
        """``fn()`` with the launch counts set to 0 before and read after;
        each kernel must have run exactly where ``expect`` names it."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize(dev)
        got = {n: w.launches for n, w in wrappers.items()}
        log(f"[phase10] {path}: kernel launches {got}")
        wrong = [n for n, k in got.items() if (n in expect) != (k > 0)]
        if wrong:
            raise RuntimeError(f"phase 10 {path}: launches {got}, expected "
                               f"nonzero exactly on {sorted(expect)}")
        for n, k in got.items():
            if k:
                by_path[n][f"phase10 {path}"] = k
        return out

    def traffic(path, fn, model):
        got = collective_traffic(fn)
        kinds = sorted({o["op"] for o in got["ops"]})
        log(f"[phase10] {path}: collective_traffic {got['total_bytes']} B "
            f"({', '.join(kinds) or 'none'}), analytic model {model} B")
        if got["total_bytes"] != model:
            raise RuntimeError(f"phase 10 {path}: traffic "
                               f"{got['total_bytes']} B != model {model} B")

    def times(path, sharded_fn, plain_fn, what="unsharded", iters=3):
        ms = cuda_ms(sharded_fn, iters=iters, warmup=1)
        pms = cuda_ms(plain_fn, iters=iters, warmup=1)
        log(f"[time] phase10 {path}: sharded {ms:.3f} ms, {what} {pms:.3f} "
            f"ms on {smi}")
        return ms, pms

    def check(path, snr, floor):
        log(f"[phase10] {path}: {snr:.1f} dB (floor {floor})")
        if not snr >= floor:
            raise RuntimeError(f"phase 10 {path}: {snr:.1f} dB below {floor}")

    def equal(path, a, b, what):
        if not (a.shape == b.shape and torch.equal(a, b)):
            raise RuntimeError(f"phase 10 {path}: != {what} bitwise")
        log(f"[phase10] {path}: == {what} bitwise")

    # ---- the channelizer at 1024 channels -----------------------------
    chans = {m: Channelizer(fir_method=m, device=dev)
             for m in ("fused", "block2")}
    t_loc = chans["fused"].block_multiple()
    nc, nt = P10_CZ_MESH
    t2 = t_loc * 4 // nt
    x = torch.randn((CZ_CHANNELS, 4 * t_loc), generator=gen, device=dev)
    mesh22 = make_dsp_mesh(nc, nt, devices=[dev] * (nc * nt))
    parts22 = shard(x, mesh22)
    for mode in ("highest", "high"):
        for m, kern in (("fused", B1), ("block2", B2)):
            ch, path = chans[m], f"channelizer {nc}x{nt} {m} {mode}"
            with matmul_precision(mode):
                step = ch.sharded_step(mesh22)
                st = ch.init_state(CZ_CHANNELS)
                st_ref = ch.init_state(CZ_CHANNELS)
                for i in range(2):  # the second consumes the carried state
                    spec, st = run_path(f"{path} super-block {i + 1}",
                                        {kern}, lambda: step(parts22, st))
                    got = gather(spec, mesh22, dim=1)
                    del spec
                    ref = []
                    for j in range(nt):
                        s_, st_ref = ch.step(x[:, j * t2:(j + 1) * t2],
                                             st_ref)
                        ref.append(s_)
                    ref = torch.cat(ref, dim=1)
                    check(f"{path} super-block {i + 1} vs unsharded "
                          f"streaming", device_snr_db(ref, got),
                          SHARDED_FLOOR_DB)
                    del got, ref
                for a, b in zip(st, st_ref):
                    equal(f"{path} state", a, b, "unsharded streaming's")
                if mode == "highest":
                    h = ch.h_fir + ch.h_rs
                    traffic(path, lambda: step(parts22, ch.init_state(
                        CZ_CHANNELS)), nt * CZ_CHANNELS * h * 4)
                    times(path, lambda: step(parts22, st),
                          lambda: ch.step(x, ch.init_state(CZ_CHANNELS)),
                          "unsharded one-shot step")
            torch.cuda.empty_cache()
    del parts22

    # fft_frames_sharded on the channelizer's input, (2, 2), 2048 points
    parts22 = shard(x, mesh22)
    path = "fft_frames_sharded 2048"
    spec = run_path(path, set(), lambda: so.fft_frames_sharded(
        parts22, 2048, mesh22, window="hann"))
    got = gather(spec, mesh22, dim=1)[:CZ_GOLDEN_CHANNELS].cpu().numpy()
    w = np.hanning(2049)[:-1]
    xh = x[:CZ_GOLDEN_CHANNELS].cpu().numpy().astype(np.float64)
    ref = np.fft.rfft(xh.reshape(CZ_GOLDEN_CHANNELS, -1, 2048) * w, axis=-1)
    check(f"{path} vs numpy f64 ({CZ_GOLDEN_CHANNELS} channels)",
          min_channel_snr_db(ref, got), FFT_FRAMES_FLOOR_DB)
    traffic(path, lambda: so.fft_frames_sharded(parts22, 2048, mesh22,
                                                window="hann"), 0)
    times(path, lambda: so.fft_frames_sharded(parts22, 2048, mesh22,
                                              window="hann"),
          lambda: torch.fft.rfft(x.reshape(CZ_CHANNELS, -1, 2048)
                                 * torch.hann_window(2048, device=dev)))
    del parts22, spec, got
    torch.cuda.empty_cache()

    # halo_overlap on the 4-rank time mesh, against the exact step
    mesh4 = DspMesh([dev] * 4, (TIME_AXIS,))
    parts4 = shard(x, mesh4)
    with matmul_precision("highest"):
        for m, halo in (("fused", "ppermute"), ("fused", "rdma"),
                        ("block2", "ppermute"), ("block2", "rdma")):
            ch = chans[m]
            path = f"halo_overlap {m} {halo}"
            expect = {B1 if m == "fused" else B2} | (
                {B3} if halo == "rdma" else set())
            over = ch.sharded_step(mesh4, halo=halo, halo_overlap=True)
            exact = ch.sharded_step(mesh4, halo=halo)
            st_o = st_e = ch.init_state(CZ_CHANNELS)
            for i in range(2):
                spec_o, st_o = run_path(f"{path} super-block {i + 1}", expect,
                                        lambda: over(parts4, st_o))
                spec_e, st_e = exact(parts4, st_e)
                check_exchanges(mesh4)
                check(f"{path} super-block {i + 1} vs the exact step",
                      device_snr_db(spec_e, spec_o), OVERLAP_FLOOR_DB)
                del spec_o, spec_e
            st0 = ch.init_state(CZ_CHANNELS)
            ms_o, ms_e = times(path, lambda: over(parts4, st0),
                               lambda: exact(parts4, st0), "exact step")
            po = profile_calls(lambda: over(parts4, st0))
            pe = profile_calls(lambda: exact(parts4, st0))
            check_exchanges(mesh4)
            for what, p in (("overlapped", po), ("exact", pe)):
                if p is None:
                    log(f"[phase10] {path} {what}: the profiler saw no "
                        f"device time")
                    continue
                log(f"[phase10] {path} {what}: device busy "
                    f"{p.busy_ms:.3f} ms summed over streams in "
                    f"{p.event_ms:.3f} ms of events (concurrency "
                    f"{p.busy_ms / p.event_ms:.2f}), {p.kernels:.0f} "
                    f"kernels, {p.copies:.0f} copies, on {smi}")
            torch.cuda.empty_cache()

        # frames="a2a" on the 4-rank time mesh: fused through B3
        ch = chans["fused"]
        ta = P10_A2A_T_LOC["fused"]
        xa = x[:, :4 * ta]
        pa = shard(xa, mesh4)
        path = "a2a fused rdma"
        step = ch.sharded_step(mesh4, halo="rdma", frames="a2a")
        spec, _ = run_path(path, {B1, B3}, lambda: step(
            pa, ch.init_state(CZ_CHANNELS)))
        check_exchanges(mesh4)
        got = gather(spec, mesh4, spec=CHANNEL_MAJOR)
        del spec
        ref, _ = ch.step(xa, ch.init_state(CZ_CHANNELS))
        if got.shape != ref.shape:
            raise RuntimeError(f"{path}: {tuple(got.shape)} != "
                               f"{tuple(ref.shape)}")
        check(f"{path} {tuple(got.shape)} vs the unsharded one-shot step",
              device_snr_db(ref, got), A2A_FLOOR_DB)
        del got, ref
        tz = 4 * ta * UP // DOWN
        traffic(path, lambda: step(pa, ch.init_state(CZ_CHANNELS)),
                4 * CZ_CHANNELS * ch.h_fir * 4 + CZ_CHANNELS * tz * 4)
        check_exchanges(mesh4)
        st0 = ch.init_state(CZ_CHANNELS)
        times(path, lambda: step(pa, st0),
              lambda: ch.step(xa, st0), "unsharded one-shot step")
        check_exchanges(mesh4)
        del pa, xa, parts4
        torch.cuda.empty_cache()

        # rdma_fused with frames="a2a" at 256 channels: B4 + B3
        ch = chans["block2"]
        ta = P10_A2A_T_LOC["block2"]
        xa = x[:CZ_FUSED_CHANNELS, :4 * ta]
        pa = shard(xa, mesh4)
        path = "a2a block2 rdma_fused"
        step = ch.sharded_step(mesh4, halo="rdma_fused", frames="a2a")
        spec, _ = run_path(path, {B4, B3}, lambda: step(
            pa, ch.init_state(CZ_FUSED_CHANNELS)))
        check_exchanges(mesh4)
        got = gather(spec, mesh4, spec=CHANNEL_MAJOR)
        ref, _ = ch.step(xa, ch.init_state(CZ_FUSED_CHANNELS))
        check(f"{path} {tuple(got.shape)} vs the unsharded one-shot step",
              device_snr_db(ref, got), A2A_FLOOR_DB)
        tz = 4 * ta * UP // DOWN
        traffic(path, lambda: step(pa, ch.init_state(CZ_FUSED_CHANNELS)),
                4 * CZ_FUSED_CHANNELS * (ch.h_fir + ch.h_rs) * 4
                + CZ_FUSED_CHANNELS * tz * 4)
        check_exchanges(mesh4)
        st0 = ch.init_state(CZ_FUSED_CHANNELS)
        times(path, lambda: step(pa, st0), lambda: ch.step(xa, st0),
              "unsharded one-shot step")
        check_exchanges(mesh4)
        del pa, xa, spec, got, ref, x
        torch.cuda.empty_cache()

    # the channelizer tool on a (2, 2) mesh against Channelizer.step
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "spec.npz")
        run_path("channelizer tool 2x2", set(), lambda: cz_cli.main(
            ["-o", out] + list(CZ_TOOL_ARGS) + list(P10_CZ_TOOL)))
        with np.load(out) as z:
            spec = torch.from_numpy(z["spectra"]).to(dev)
    args = list(CZ_TOOL_ARGS) + list(P10_CZ_TOOL)

    def arg(name, default):
        return args[args.index(name) + 1] if name in args else default

    c_t = int(arg("--synth", 8))
    t_t = int(float(arg("--seconds", 2.0)) * 48000)
    xt = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (c_t, t_t)).astype(np.float32)).to(dev)
    ch = Channelizer(fir_taps=firwin(int(arg("--fir-taps", 1024)), 0.4,
                                     window="hamming"),
                     fft_n=int(arg("--fft", 2048)), fir_method="ols",
                     device=dev)
    t_use = t_t // (ch.block_multiple() * 2) * ch.block_multiple() * 2
    xt = xt[:, :t_use]
    ref, _ = ch.step(xt, ch.init_state(c_t))
    check(f"channelizer tool 2x2 {tuple(spec.shape)} vs Channelizer.step",
          device_snr_db(ref, spec), SHARDED_FLOOR_DB)
    del spec, ref, xt
    torch.cuda.empty_cache()

    # ---- config 1: fir_filter_sharded and the tap-parallel FIR ----------
    cfg1 = load_config("fir_lowpass_1ch")
    f1 = cfg1.fir
    t1 = int(cfg1.sample_rate * cfg1.seconds)
    taps1 = firwin(f1.numtaps, f1.cutoff[0], window=f1.window,
                   pass_zero=f1.kind)
    x1 = torch.randn((cfg1.channels, t1), generator=gen, device=dev)
    mesh14 = make_dsp_mesh(1, 4, devices=[dev] * 4)

    def fir_stream(method, mesh, x, taps, n_super):
        """``x`` through ``fir_filter_sharded`` in ``n_super`` super-blocks,
        the state carried; returns the output joined and the state."""
        tb = x.shape[-1] // n_super
        st, outs = None, []
        for i in range(n_super):
            y, st = so.fir_filter_sharded(
                shard(x[:, i * tb:(i + 1) * tb], mesh), taps, mesh,
                method=method, state=st, return_state=True)
            outs.append(gather(y, mesh))
        return torch.cat(outs, dim=-1), st

    def fir_golden(method, x, taps, t_l):
        zi, outs = None, []
        for j in range(x.shape[-1] // t_l):
            y, zi = fir_filter(x[:, j * t_l:(j + 1) * t_l], taps,
                               method=method, zi=zi, return_zf=True)
            outs.append(y)
        return torch.cat(outs, dim=-1), zi

    for method, expect in (("ols", set()), ("block2", {B2})):
        path = f"config 1 fir_filter_sharded {method} 1x4"
        got, st = run_path(path, expect, lambda: fir_stream(
            method, mesh14, x1, taps1, 2))
        ref, zf = fir_golden(method, x1, taps1, t1 // 8)
        equal(f"{path}, 2 super-blocks", got, ref,
              "unsharded streaming at T_loc")
        equal(f"{path} state", st, zf, "unsharded streaming's")
        h = fir_state_len(len(taps1), method=method)
        p1 = shard(x1, mesh14)
        traffic(path, lambda: so.fir_filter_sharded(p1, taps1, mesh14,
                                                    method=method),
                2 * 3 * cfg1.channels * h * 4)
        times(path, lambda: so.fir_filter_sharded(p1, taps1, mesh14,
                                                  method=method),
              lambda: fir_filter(x1, taps1, method=method))
    path = "config 1 fir_filter_tap_parallel 4 ranks"
    got = run_path(path, set(), lambda: fir_filter_tap_parallel(
        x1, taps1, mesh14))
    ref = fir_filter(x1, taps1, method="direct")
    for g in got:
        check(f"{path} vs fir_filter", device_snr_db(ref, g), TAP_FLOOR_DB)
    traffic(path, lambda: fir_filter_tap_parallel(x1, taps1, mesh14),
            4 * x1.numel() * 4)
    times(path, lambda: fir_filter_tap_parallel(x1, taps1, mesh14),
          lambda: fir_filter(x1, taps1, method="direct"))

    # the headline's 64 channels through B2 on a (2, 2) mesh
    taps_h = firwin(NTAPS, CUTOFF, window="hamming")
    xh = torch.randn((CHANNELS, 2 * BLOCK_T), generator=gen, device=dev)
    path = f"headline {CHANNELS}ch fir_filter_sharded block2 2x2"
    got, st = run_path(path, {B2}, lambda: fir_stream(
        "block2", mesh22, xh, taps_h, 1))
    ref, zf = fir_golden("block2", xh, taps_h, BLOCK_T)
    equal(path, got, ref, "unsharded streaming at T_loc")
    equal(f"{path} state", st, zf, "unsharded streaming's")
    ph = shard(xh, mesh22)
    traffic(path, lambda: so.fir_filter_sharded(ph, taps_h, mesh22,
                                                method="block2"),
            2 * CHANNELS * 1024 * 4)
    times(path, lambda: so.fir_filter_sharded(ph, taps_h, mesh22,
                                              method="block2"),
          lambda: fir_filter(xh, taps_h, method="block2"))
    del xh, ph, got, ref

    # ---- config 2: resample_sharded on (1, 4) ---------------------------
    cfg2 = load_config("resample_8ch")
    rc = cfg2.resample
    t2c = int(cfg2.sample_rate * cfg2.seconds)
    rtaps = resample_taps(rc.up, rc.down, rc.taps_per_phase,
                          window=("kaiser", rc.kaiser_beta))
    x2 = torch.randn((cfg2.channels, t2c), generator=gen, device=dev)
    path = "config 2 resample_sharded 1x4"
    y2 = run_path(path, set(), lambda: gather(so.resample_sharded(
        shard(x2, mesh14), rc.up, rc.down, mesh14, taps=rtaps), mesh14))
    zi, ref = None, []
    for j in range(4):
        yj, zi = resample_poly(x2[:, j * (t2c // 4):(j + 1) * (t2c // 4)],
                               rc.up, rc.down, taps=rtaps, zi=zi,
                               return_zf=True)
        ref.append(yj)
    equal(path, y2, torch.cat(ref, dim=-1), "unsharded streaming at T_loc")
    p2 = shard(x2, mesh14)
    k2 = len(rtaps) // rc.up
    traffic(path, lambda: so.resample_sharded(p2, rc.up, rc.down, mesh14,
                                              taps=rtaps),
            2 * 3 * cfg2.channels * (k2 - 1) * 4)
    times(path, lambda: so.resample_sharded(p2, rc.up, rc.down, mesh14,
                                            taps=rtaps),
          lambda: resample_poly(x2, rc.up, rc.down, taps=rtaps))

    # ---- config 3: sosfilt_sharded on (1, 4) and (2, 2) ----------------
    cfg3 = load_config("iir_eq_64ch")
    ic = cfg3.iir
    t3 = int(cfg3.sample_rate * cfg3.seconds)
    sos = peaking_eq_sos(ic.freqs, ic.gains_db, ic.sample_rate, q=ic.q)
    x3 = torch.randn((cfg3.channels, t3), generator=gen, device=dev)
    y_ref = sosfilt(sos, x3, block_size=ic.block_size)
    for shape in ((1, 4), (2, 2)):
        mesh = make_dsp_mesh(*shape, devices=[dev] * 4)
        wide = make_dsp_mesh(shape[0], 2 * shape[1],
                             devices=[dev] * 8)  # the same T_loc, one call
        path = f"config 3 sosfilt_sharded {shape[0]}x{shape[1]}"
        p3 = shard(x3, mesh)
        y = run_path(path, set(), lambda: gather(so.sosfilt_sharded(
            p3, sos, mesh, block_size=ic.block_size), mesh))
        check(f"{path} vs sosfilt", device_snr_db(y_ref, y),
              IIR_SHARDED_FLOOR_DB)
        half = t3 // 2
        a, st = so.sosfilt_sharded(shard(x3[:, :half], mesh), sos, mesh,
                                   block_size=ic.block_size,
                                   return_state=True)
        b = so.sosfilt_sharded(shard(x3[:, half:], mesh), sos, mesh,
                               block_size=ic.block_size, state=st)
        one = so.sosfilt_sharded(shard(x3, wide), sos, wide,
                                 block_size=ic.block_size)
        equal(f"{path} 2 super-blocks",
              torch.cat([gather(a, mesh), gather(b, mesh)], dim=-1),
              gather(one, wide), "one call at the same T_loc")
        traffic(path, lambda: so.sosfilt_sharded(
            p3, sos, mesh, block_size=ic.block_size),
            len(sos) * 8 * cfg3.channels * shape[1])
        times(path, lambda: so.sosfilt_sharded(p3, sos, mesh,
                                               block_size=ic.block_size),
              lambda: sosfilt(sos, x3, block_size=ic.block_size))
    del p3, y, a, b, one

    # stage_pipeline: 4 stateless blockwise stages on config 3's channels
    band = firwin(1024, 0.25, window="hamming")
    high = firwin(1023, 0.02, window="hamming", pass_zero=False)
    fns = [lambda v: fir_filter(v, band, method="ols"),
           lambda v: v * 0.5 + 0.25,
           lambda v: fir_filter(v, high, method="ols"),
           torch.tanh]
    smesh = make_stage_mesh(4, devices=[dev] * 4)
    path = f"stage_pipeline 4 stages, micro-blocks of {P10_MICRO_BLOCK}"
    y = run_path(path, set(), lambda: stage_pipeline(
        fns, smesh, x3, micro_block=P10_MICRO_BLOCK))

    def serial():
        out = []
        for i in range(t3 // P10_MICRO_BLOCK):
            v = x3[:, i * P10_MICRO_BLOCK:(i + 1) * P10_MICRO_BLOCK]
            for f in fns:
                v = f(v)
            out.append(v)
        return torch.cat(out, dim=-1)

    equal(path, y, serial(), "the serial blockwise composition")
    traffic(path, lambda: stage_pipeline(fns, smesh, x3,
                                         micro_block=P10_MICRO_BLOCK),
            3 * (t3 // P10_MICRO_BLOCK) * cfg3.channels * P10_MICRO_BLOCK
            * 4)
    times(path, lambda: stage_pipeline(fns, smesh, x3,
                                       micro_block=P10_MICRO_BLOCK),
          serial, "serial composition")
    for what, fn in (("pipelined", lambda: stage_pipeline(
            fns, smesh, x3, micro_block=P10_MICRO_BLOCK)),
            ("serial", serial)):
        p = profile_calls(fn)
        if p is not None:
            log(f"[phase10] {path} {what}: device busy {p.busy_ms:.3f} ms "
                f"summed over streams in {p.event_ms:.3f} ms of events "
                f"(concurrency {p.busy_ms / p.event_ms:.2f}), host "
                f"{p.host_ms:.3f} ms, on {smi}")
    del x3, y_ref, y

    # ---- config 4: spectral_gain_sharded on (1, 4) ----------------------
    cfg4 = load_config("stft_gain_256ch")
    sc = cfg4.stft
    n_fft, hop = sc.n_fft, sc.hop
    rate = cfg4.sample_rate
    gain = np.full(n_fft // 2 + 1, 10.0 ** (-6 / 20), np.float32)
    fk = np.arange(n_fft // 2 + 1) * rate / n_fft
    gain[(fk >= 1000) & (fk <= 2000)] = 0.0
    x4 = torch.randn((cfg4.channels, P10_SPECTRAL_T), generator=gen,
                     device=dev)
    p4 = shard(x4, mesh14)
    ov = n_fft - hop
    cut = P10_SPECTRAL_T - n_fft
    rows = CZ_GOLDEN_CHANNELS
    want4 = reference_stft.stream(x4[:rows], gain.astype(np.float64), n_fft,
                                  hop)[:, ov:cut + ov]
    for engine in ("reference", "cwola"):
        path = f"config 4 spectral_gain_sharded {engine} 1x4"
        stage = SpectralGainStage(gain, n_fft=n_fft, hop=hop,
                                  window=sc.window, engine=engine)
        # held to the same arithmetic unsharded: for the reference engine
        # the stage's composite path on cuFFT, the sharded path's own
        same = stage if engine == "cwola" else composite_path(
            gain, n_fft, hop, sc.window, dev)
        st0 = stage.init_state((cfg4.channels,), device=dev)
        # the stage's output lags its input by n_fft - hop samples
        y_ref = same.apply(x4, st0)[0][:, ov:cut + ov]
        y = run_path(path, set(), lambda: gather(spectral_gain_sharded(
            p4, gain, mesh14, n_fft=n_fft, hop=hop, window=sc.window,
            engine=engine), mesh14))
        check(f"{path} interior (all but the last {n_fft}) vs the unsharded "
              f"stage" + ("'s composite path" if same is not stage else ""),
              device_snr_db(y_ref, y[:, :cut]), SPECTRAL_SP_FLOOR_DB)
        if same is not stage:
            # the stage as it runs on the card, on the wola_gain kernel
            held_to_cufft(f"{path}: the unsharded stage and the sharded path "
                          f"on {rows} channels, all but the last {n_fft}",
                          stage.apply(x4, st0)[0][:rows, ov:cut + ov],
                          y[:rows, :cut], want4)
        traffic(path, lambda: spectral_gain_sharded(
            p4, gain, mesh14, n_fft=n_fft, hop=hop, window=sc.window,
            engine=engine), 3 * (2 * cfg4.channels * ov * 4 + ov * 4))
        times(path, lambda: spectral_gain_sharded(
            p4, gain, mesh14, n_fft=n_fft, hop=hop, window=sc.window,
            engine=engine), lambda: stage.apply(x4, st0),
            "unsharded stage")
    del x4, p4, y, y_ref, same, want4
    torch.cuda.empty_cache()

    # ---- the heartbeat on the (2, 2) mesh -------------------------------
    path = "heartbeat 2x2"
    ok = run_path(path, set(), lambda: heartbeat(mesh22))
    bad = torch.randn(4 * 1024, generator=gen, device=dev)
    bad[3000] = float("nan")
    nan = heartbeat(mesh22, bad)
    log(f"[phase10] {path}: clean {ok}, NaN payload {nan}")
    if not ok["ok"] or nan["ok"] or ok["devices"] != 4:
        raise RuntimeError(f"phase 10 {path}: {ok}, {nan}")
    traffic(path, lambda: heartbeat(mesh22), 8 * 4)

    # ---- the NCCL process group of one ---------------------------------
    # NCCL will not put two processes on one card, so this group has one
    # process and every rank of its mesh is local: it runs the bootstrap
    # and NCCL's all_reduce (the heartbeat), and no NCCL point-to-point
    # call (the halo, reshard and carry sends run only between processes)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    rd.init_distributed(f"localhost:{port}", 1, 0, device="cuda")
    import torch.distributed as dist

    try:
        gmesh = rd.global_dsp_mesh(1, 4, ranks_per_process=4)
        beat = heartbeat(gmesh, bad)
        log(f"[phase10] NCCL group of one ({dist.get_backend()}; "
            f"all_reduce only, no point-to-point): global mesh "
            f"{gmesh.shape}, local slice "
            f"{rd.host_local_shard(CZ_FUSED_CHANNELS, 4 * t_loc, gmesh)}"
            f", heartbeat on a NaN payload {beat}")
        if beat["ok"] or dist.get_backend() != "nccl":
            raise RuntimeError(f"NCCL group of one: {beat}")
        xg = torch.randn((CZ_FUSED_CHANNELS, 4 * t_loc), generator=gen,
                         device=dev)
        ch = chans["fused"]
        path = "NCCL group of one channelizer fused"
        gparts = rd.make_global_array(
            tuple(xg.shape), gmesh, channel_time_spec(),
            lambda idx: xg[idx].cpu().numpy())
        spec, _ = run_path(path, {B1}, lambda: ch.sharded_step(gmesh)(
            gparts, ch.init_state(CZ_FUSED_CHANNELS)))
        ref, _ = ch.sharded_step(mesh4)(
            shard(xg, mesh4), ch.init_state(CZ_FUSED_CHANNELS))
        equal(path, gather(spec, gmesh, dim=1), gather(ref, mesh4, dim=1),
              "the same step on a mesh of this process")
    finally:
        dist.destroy_process_group()
    return by_path


def main() -> int:
    import scipy.signal as ss
    import torch
    import torch.nn.functional as F

    # One process runs every phase, and tables cached by the early phases
    # stay allocated: with fixed segments they pin a free remainder a phase
    # before left (a 2.19 GiB one where phase 7's cwola one-shot product
    # stood), and phase 10's 4.6 GiB steps find 26 GiB free but none in
    # one piece.  Segments that grow and shrink hold no such remainder.
    # Set before the first allocation, in this process only: the workers
    # of phases 1 and 12 choose their own.
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")

    from llzlab_tpu_torch import (Chain, Channelizer, FIRStage,
                                  FusedFirResampleStage, ResampleStage,
                                  firwin, gather_time, irfft, resample_taps,
                                  shard_time)
    from llzlab_tpu_torch.kernels import _build
    from llzlab_tpu_torch.kernels import block2_fir as bf
    from llzlab_tpu_torch.kernels import fused_fir_resample as ff
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.ops.fir import block2_block
    from llzlab_tpu_torch.parallel.halo import left_halo
    from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh
    from llzlab_tpu_torch.runtime.platform import require_cuda

    wrappers = {"block2_fir": bf.block2_fir_cuda,
                "fused_fir_resample": ff.fused_fir_resample_cuda,
                "halo_ring": hr.left_halo_ring_cuda,
                "halo_fir_fused": hf.block2_fir_halo_fused_cuda}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def read_launches(names, what):
        got = {name: wrappers[name].launches for name in names}
        log(f"[{what}] kernel launches on this path: {got}")
        if min(got.values()) < 1:
            raise RuntimeError(f"{what}: a kernel of the path never ran: "
                               f"{got}")
        return got

    # ---- phase 1: device and build ------------------------------------
    dev = require_cuda()
    if sys.argv[1:2] == ["--cross-card-digests"]:
        # phase 11's process under PyTorch's expandable segments
        with open(sys.argv[2], "w") as f:
            json.dump(cross_card_digests(dev), f)
        return 0
    kind = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index or 0]
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi name, power.limit:")
    log(smi)
    t0 = time.perf_counter()
    built = KERNEL_NAMES + (SCAN_KERNEL, WOLA_KERNEL)
    with concurrent.futures.ThreadPoolExecutor(len(built)) as pool:
        list(pool.map(_build.build, built))  # one nvcc each, together
    log(f"[build] {', '.join(n + '.cu' for n in built)} for sm_90a "
        f"in {time.perf_counter() - t0:.2f} s")

    log(f"[build] blocks an SM holds at {NTAPS} taps (occupancy API): "
        f"block2_fir high {bf.blocks_per_sm(NTAPS)}; halo_fir_fused high "
        f"{hf.blocks_per_sm(NTAPS, 'high')}, highest "
        f"{hf.blocks_per_sm(NTAPS, 'highest')}")

    if "--only-processes" in sys.argv[1:]:
        # phase 12 alone, without the kernels line of a whole run
        t0 = time.perf_counter()
        by_path, across = process_paths(dev, smi, wrappers)
        log(f"[phase12] all paths in {time.perf_counter() - t0:.1f} s; "
            f"launches by path {json.dumps(by_path)}; across processes "
            f"{json.dumps(across)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if "--only-multicard" in sys.argv[1:]:
        # phase 11 alone (a rehearsal on several cards), without the
        # kernels line of a whole run
        t0 = time.perf_counter()
        by_path, across, net = multicard_paths(dev, smi, wrappers)
        log(f"[phase11] all paths in {time.perf_counter() - t0:.1f} s; "
            f"launches by path {json.dumps(by_path)}; across cards "
            f"{json.dumps(across)}; NET edges on one card {json.dumps(net)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    errors = dict.fromkeys(KERNEL_NAMES, 0.0)
    chain_times = {}

    # ---- phase 2a: B1 and B2 against their plain versions --------------
    def check_kernels(label, ntaps, cutoff, up, down, k, channels, t):
        taps = firwin(ntaps, cutoff, window="hamming")
        rtaps = resample_taps(up, down, k)
        block = block2_block(ntaps)
        x = torch.from_numpy(
            rng.standard_normal((channels, t)).astype(np.float32)).to(dev)
        hist = torch.from_numpy(rng.standard_normal(
            (channels, 2 * block)).astype(np.float32)).to(dev)
        xpad = torch.cat([hist[:, :block], x], dim=-1).contiguous()
        ref_b2 = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
        ref_b1 = ff.fused_fir_resample_plain(x.double(), hist.double(), taps,
                                             up, down, rtaps, "highest")
        for mode in MODES:
            for name, run_kernel, run_plain, ref in (
                ("block2_fir",
                 lambda: bf.block2_fir_cuda(xpad, taps, block, mode),
                 lambda: bf.block2_fir_plain(xpad, taps, block, mode),
                 ref_b2),
                ("fused_fir_resample",
                 lambda: ff.fused_fir_resample_cuda(x, hist, taps, up, down,
                                                    rtaps, mode),
                 lambda: ff.fused_fir_resample_plain(x, hist, taps, up, down,
                                                     rtaps, mode),
                 ref_b1),
            ):
                got = run_kernel()
                torch.cuda.synchronize()
                plain = run_plain()
                if got.shape != plain.shape or not torch.isfinite(got).all():
                    raise RuntimeError(f"{name} {mode} {label}: bad output "
                                       f"{tuple(got.shape)}")
                err = float((got - plain).abs().max())
                snr = device_snr_db(ref, got)
                del got, plain
                errors[name] = max(errors[name], err)
                was = (f", was >= {PREVIOUS[name + ' SNR dB'][mode]}"
                       if name + " SNR dB" in PREVIOUS else "")
                log(f"[kernel] {name} {mode:7s} {label}: max|kernel-plain| "
                    f"{err:.3e}, SNR vs plain f64 {snr:.1f} dB "
                    f"(floor {KERNEL_FLOOR_DB[mode]}{was})")
                if not snr >= KERNEL_FLOOR_DB[mode]:
                    raise RuntimeError(f"{name} {mode} {label}: SNR {snr:.1f}"
                                       f" dB below {KERNEL_FLOOR_DB[mode]}")

    s = SMALL
    check_kernels("small", s["ntaps"], s["cutoff"], s["up"], s["down"],
                  s["k"], s["channels"],
                  3 * ff.fused_program_in(s["ntaps"], s["up"], s["down"]))
    check_kernels("headline", NTAPS, CUTOFF, UP, DOWN, K, CHANNELS, BLOCK_T)

    # B1 over three programs: one shot, 1 + 2 and 2 + 1.  The three calls'
    # block grids differ; the outputs must not (the y windows start at
    # multiples of 8 of the stream index)
    for label, ntaps, cutoff, up, down, k, channels in (
            ("small", s["ntaps"], s["cutoff"], s["up"], s["down"], s["k"],
             s["channels"]),
            ("headline", NTAPS, CUTOFF, UP, DOWN, K, CHANNELS)):
        args = (firwin(ntaps, cutoff, window="hamming"), up, down,
                resample_taps(up, down, k))
        prog = ff.fused_program_in(ntaps, up, down)
        x = torch.from_numpy(rng.standard_normal(
            (channels, 3 * prog)).astype(np.float32)).to(dev)
        zi = torch.from_numpy(rng.standard_normal(
            (channels, ff.fused_state_len(ntaps))).astype(np.float32)).to(dev)
        for mode in MODES:
            one = ff.fused_fir_resample(x, *args, zi=zi, mode=mode)
            for cut in (prog, 2 * prog):
                za, zf = ff.fused_fir_resample(
                    x[:, :cut].contiguous(), *args, zi=zi, return_zf=True,
                    mode=mode)
                zb = ff.fused_fir_resample(x[:, cut:].contiguous(), *args,
                                           zi=zf, mode=mode)
                torch.cuda.synchronize()
                if not torch.equal(torch.cat([za, zb], -1), one):
                    raise RuntimeError(
                        f"fused_fir_resample {mode} {label}: streamed "
                        f"{cut // prog} + {3 - cut // prog} programs != one "
                        f"shot")
            log(f"[kernel] fused_fir_resample {mode:7s} {label}: 3 programs "
                f"of {prog} streamed 1 + 2 and 2 + 1 == one shot bitwise")

    # B2 over three stretches of five blocks, each call with the block before
    # it as history: one shot, 1 + 2 and 2 + 1.  The cuts are multiples of
    # the block, so of 8: the tensor-core passes of the later call start
    # elsewhere in the stream, their sums must not
    for label, ntaps, cutoff, channels in (
            ("small", s["ntaps"], s["cutoff"], s["channels"]),
            ("headline", NTAPS, CUTOFF, CHANNELS)):
        taps = firwin(ntaps, cutoff, window="hamming")
        block = block2_block(ntaps)
        part = 5 * block
        xpad = torch.from_numpy(rng.standard_normal(
            (channels, block + 3 * part)).astype(np.float32)).to(dev)
        for mode in MODES:
            one = bf.block2_fir_cuda(xpad, taps, block, mode)
            for cut in (part, 2 * part):
                ya = bf.block2_fir_cuda(xpad[:, :block + cut].contiguous(),
                                        taps, block, mode)
                yb = bf.block2_fir_cuda(xpad[:, cut:].contiguous(), taps,
                                        block, mode)
                torch.cuda.synchronize()
                if not torch.equal(torch.cat([ya, yb], -1), one):
                    raise RuntimeError(
                        f"block2_fir {mode} {label}: streamed "
                        f"{cut // part} + {3 - cut // part} stretches != one "
                        f"shot")
            log(f"[kernel] block2_fir {mode:7s} {label}: 3 stretches of "
                f"{part} streamed 1 + 2 and 2 + 1 == one shot bitwise")

    # ---- the channelizer, its mesh and its data --------------------------
    chan = {m: Channelizer(fir_method=m, device=dev)
            for m in ("fused", "block2")}
    if Channelizer(device=dev).fir_method != "fused":
        raise RuntimeError("Channelizer(fir_method='auto') did not resolve "
                           "to 'fused' on the card")
    t_loc = chan["fused"].block_multiple()
    if t_loc != chan["block2"].block_multiple() or t_loc != 327680:
        raise RuntimeError(f"block_multiple {t_loc} is not the config's")
    cz_taps = chan["block2"].fir_taps
    cz_block = block2_block(len(cz_taps))
    # B1 and B2 at the shapes each rank of the channelizer gives them: all
    # 1024 channels (and the 256 of the rdma_fused path) of one shard, with
    # the channelizer's taps
    for c in (CZ_CHANNELS, CZ_FUSED_CHANNELS):
        check_kernels(f"channelizer {c}ch", len(cz_taps), 0.4, UP, DOWN, K,
                      c, t_loc)
        torch.cuda.empty_cache()
    mesh = DspMesh([dev] * CZ_RANKS, (TIME_AXIS,))
    x_cz = torch.randn((CZ_CHANNELS, CZ_RANKS * t_loc), generator=gen,
                       device=dev, dtype=torch.float32)
    parts = shard_time(x_cz, mesh)
    parts_f = shard_time(x_cz[:CZ_FUSED_CHANNELS], mesh)
    torch.cuda.synchronize()

    def on_mesh(fn, m=mesh):
        """``fn()`` with the mesh ordered behind the current stream before
        and the current stream behind the mesh after."""
        def run():
            m.fork()
            out = fn()
            m.join()
            return out
        return run

    # ---- phase 2b: B3 against its plain version, bitwise ----------------
    halo_widths = (chan["block2"].h_rs, chan["block2"].h_fir,
                   chan["fused"].h_fir)  # 63, 1024, 2048
    for h in halo_widths:
        for carry in (None, torch.randn((CZ_CHANNELS, h), generator=gen,
                                        device=dev)):
            before = hr.left_halo_ring_cuda.launches
            got = on_mesh(lambda: hr.left_halo_ring(
                parts, h, mesh, first_shard_value=carry))()
            if hr.left_halo_ring_cuda.launches != before + 1:
                raise RuntimeError(
                    f"halo_ring: {hr.left_halo_ring_cuda.launches - before} "
                    f"launches for one exchange on one card, expected 1")
            plain = on_mesh(lambda: hr.left_halo_ring_plain(
                parts, h, mesh, first_shard_value=carry))()
            hr.check_exchanges(mesh)
            torch.cuda.synchronize()
            for r in range(CZ_RANKS):
                if got[r].shape != (CZ_CHANNELS, h) or \
                        not torch.equal(got[r], plain[r]):
                    raise RuntimeError(f"halo_ring h={h} rank {r}: kernel "
                                       f"!= plain version")
                errors["halo_ring"] = max(errors["halo_ring"], float(
                    (got[r] - plain[r]).abs().max()))
            log(f"[kernel] halo_ring h={h:4d} carry={carry is not None}: "
                f"{CZ_RANKS} ranks x ({CZ_CHANNELS}, {h}) == plain version "
                f"bitwise, 1 launch")

    # ---- phase 2c: B4 against its plain version and against B2 ----------
    for n in (2, CZ_RANKS):
        sub = DspMesh([dev] * n, (TIME_AXIS,))
        sub_parts = [p for p in parts_f[:n]]
        stream = x_cz[:CZ_FUSED_CHANNELS, : n * t_loc]
        for mode in MODES:
            carry = None
            for epoch in (1, 2, 3):  # no carry, then twice a nonzero one
                got = on_mesh(lambda: hf.block2_fir_halo_fused(
                    sub_parts, cz_taps, sub, first_shard_value=carry,
                    mode=mode), sub)()
                hr.check_exchanges(sub)
                plain = on_mesh(lambda: hf.block2_fir_halo_fused_plain(
                    sub_parts, cz_taps, sub, first_shard_value=carry,
                    mode=mode), sub)()
                lead = (torch.zeros((CZ_FUSED_CHANNELS, cz_block), device=dev)
                        if carry is None else carry)
                xpad = torch.cat([lead, stream], dim=-1)
                whole = bf.block2_fir_cuda(xpad, cz_taps, cz_block, mode)
                ref64 = bf.block2_fir_plain(xpad.double(), cz_taps, cz_block,
                                            "highest")
                torch.cuda.synchronize()
                got, plain = torch.cat(got, -1), torch.cat(plain, -1)
                if not torch.equal(got, whole):
                    raise RuntimeError(
                        f"halo_fir_fused n={n} {mode} epoch {epoch}: shards "
                        f"!= block2_fir_cuda on the unsharded stream")
                err = float((got - plain).abs().max())
                snr = device_snr_db(ref64, got)
                errors["halo_fir_fused"] = max(errors["halo_fir_fused"], err)
                log(f"[kernel] halo_fir_fused {mode:7s} n={n} epoch {epoch}: "
                    f"== block2_fir_cuda unsharded bitwise, max|kernel-plain|"
                    f" {err:.3e}, SNR vs plain f64 {snr:.1f} dB (floor "
                    f"{KERNEL_FLOOR_DB[mode]})")
                if not snr >= KERNEL_FLOOR_DB[mode]:
                    raise RuntimeError(f"halo_fir_fused {mode}: SNR {snr:.1f}")
                # the next epoch starts from this stream's last block
                carry = stream[:, -cz_block:].contiguous()
                del whole, ref64, xpad, got, plain
    torch.cuda.empty_cache()

    # ---- phase 2d: a late sender --------------------------------------
    # B3 on one card waits for nothing but stream order: with rank 0's
    # stream held back about a second the halo is still right
    late = DspMesh([dev] * 2, (TIME_AXIS,))
    with late.on(0):
        torch.cuda._sleep(int(2e9))
    t0 = time.perf_counter()
    got = on_mesh(lambda: hr.left_halo_ring(parts[:2], 63, late), late)()
    hr.check_exchanges(late)
    torch.cuda.synchronize()
    if not (torch.equal(got[1], parts[0][:, -63:])
            and not bool(got[0].any())):
        raise RuntimeError("halo_ring with rank 0's stream held back "
                           "returned a wrong halo")
    log(f"[kernel] halo_ring with rank 0's stream held back "
        f"{time.perf_counter() - t0:.2f} s: halo right (stream order alone)")
    # B4 does wait for its sender: a receive whose sender comes later than
    # the limit must raise, and the exchange must work again afterwards
    fused = on_mesh(lambda: hf.block2_fir_halo_fused(
        parts_f[:2], cz_taps, late, mode="highest"), late)
    fused()
    hr.check_exchanges(late)
    limit, hr.WAIT_LIMIT_S = hr.WAIT_LIMIT_S, 0.2
    t0 = time.perf_counter()
    with late.on(0):
        torch.cuda._sleep(int(2e9))  # about a second of rank 0's stream
    fused()
    try:
        hr.check_exchanges(late)
    except RuntimeError as exc:
        log(f"[kernel] halo_fir_fused with its sender held back raised "
            f"after {time.perf_counter() - t0:.2f} s: {exc}")
    else:
        raise RuntimeError("a halo receive whose sender came late by more "
                           "than the wait limit did not raise")
    finally:
        hr.WAIT_LIMIT_S = limit
    y = fused()
    hr.check_exchanges(late)  # and the exchange works again afterwards
    whole = bf.block2_fir_cuda(
        torch.cat([torch.zeros((CZ_FUSED_CHANNELS, cz_block), device=dev),
                   x_cz[:CZ_FUSED_CHANNELS, :2 * t_loc]], -1), cz_taps,
        cz_block, "highest")
    if not torch.equal(torch.cat(y, -1), whole):
        raise RuntimeError("halo_fir_fused after a timed-out receive: "
                           "shards != block2_fir_cuda unsharded")
    del y, whole
    # the same through the channelizer: the step after the one whose
    # receive timed out raises, with no check_exchanges by the caller
    step = chan["block2"].sharded_step(late, halo="rdma_fused")
    st = chan["block2"].init_state(CZ_FUSED_CHANNELS)
    step(parts_f[:2], st)
    hr.WAIT_LIMIT_S = 0.2
    with late.on(0):
        torch.cuda._sleep(int(2e9))
    try:
        step(parts_f[:2], st)  # times out on the card, returns all the same
        try:
            step(parts_f[:2], st)
        except RuntimeError as exc:
            log(f"[channelizer] the rdma_fused sharded step after one whose "
                f"halo never arrived raised: {exc}")
        else:
            raise RuntimeError("a sharded step whose halo receive timed out "
                               "was not reported by the next step")
    finally:
        hr.WAIT_LIMIT_S = limit
    step(parts_f[:2], st)
    hr.check_exchanges(late)
    del step, st

    # ---- phase 3: the headline chain ------------------------------------
    taps = firwin(NTAPS, CUTOFF, window="hamming")
    rtaps = resample_taps(UP, DOWN, K)
    x_np = rng.standard_normal(
        (CHANNELS, NBLOCKS * BLOCK_T)).astype(np.float32)
    t0 = time.perf_counter()
    y64 = ss.lfilter(taps, [1.0], x_np.astype(np.float64), axis=-1)
    golden = ss.upfirdn(rtaps, y64, UP, DOWN, axis=-1)
    log(f"[golden] scipy f64 lfilter + upfirdn in "
        f"{time.perf_counter() - t0:.1f} s")
    x_all = torch.from_numpy(x_np).to(dev)
    blocks = [x_all[:, i * BLOCK_T:(i + 1) * BLOCK_T].contiguous()
              for i in range(NBLOCKS)]

    def chain_ms(chain, steps=20):
        """CUDA-event time per block of ``steps`` blocks streamed back to
        back through ``chain``, the state carried."""
        st = chain.init_state((CHANNELS,), device=dev)
        for i in range(3):
            _, st = chain.apply(blocks[i % NBLOCKS], st)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(steps):
            _, st = chain.apply(blocks[i % NBLOCKS], st)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / steps

    reset_launches()
    for mode in MODES:
        chain = Chain([FusedFirResampleStage(
            taps, UP, DOWN, rtaps=rtaps, channels=CHANNELS, device=dev,
            precision=mode)])
        if chain.stages[0].engine != "kernel" or BLOCK_T % chain.block_multiple:
            raise RuntimeError(f"fused stage resolved to "
                               f"{chain.stages[0].engine!r}")
        streamed = torch.cat(list(chain.stream(blocks)), dim=-1)
        one_shot = chain(x_all)
        torch.cuda.synchronize()
        if not torch.equal(streamed, one_shot):
            raise RuntimeError(f"fused chain {mode}: streamed != one-shot")
        z = streamed.cpu().numpy()
        snr = min_channel_snr_db(golden[:, :z.shape[1]], z)
        log(f"[chain] fused {mode:7s}: {NBLOCKS} blocks of {CHANNELS}x"
            f"{BLOCK_T} -> {tuple(z.shape)}, streamed == one-shot bitwise, "
            f"min-channel SNR vs scipy f64 {snr:.1f} dB "
            f"(floor {CHAIN_FLOOR_DB[mode]}, was "
            f"{PREVIOUS['fused chain SNR dB'][mode]})")
        if not snr >= CHAIN_FLOOR_DB[mode]:
            raise RuntimeError(f"fused chain {mode}: SNR {snr:.1f} dB")
        chain_times[("fused", mode)] = chain_ms(chain)
    for mode in MODES:
        with matmul_precision(mode):
            chain = Chain([FIRStage(taps, method="block2"),
                           ResampleStage(UP, DOWN, taps=rtaps)])
            z = torch.cat(list(chain.stream(blocks)), dim=-1)
            torch.cuda.synchronize()
            chain_times[("unfused", mode)] = chain_ms(chain)
        z = z.cpu().numpy()
        snr = min_channel_snr_db(golden[:, :z.shape[1]], z)
        log(f"[chain] unfused {mode:7s}: FIRStage(block2) + ResampleStage -> "
            f"{tuple(z.shape)}, min-channel SNR vs scipy f64 {snr:.1f} dB "
            f"(floor {CHAIN_FLOOR_DB[mode]})")
        if not (np.isfinite(z).all() and snr >= CHAIN_FLOOR_DB[mode]):
            raise RuntimeError(f"unfused chain {mode}: SNR {snr:.1f} dB")
    read_launches(("block2_fir", "fused_fir_resample"), "chain")
    for (what, mode), ms in chain_times.items():
        was = (f" (was {PREVIOUS['unfused chain ms'][mode]} ms)"
               if what == "unfused" else "")
        log(f"[time] chain {what} {mode:7s}: {ms:.3f} ms per block of "
            f"{CHANNELS}x{BLOCK_T}{was}, 20 blocks back to back "
            f"({CHANNELS * BLOCK_T / ms / 1e3:.0f} Msamples/s) on {smi}")
    del streamed, one_shot, golden, y64

    # ---- phase 4: the channelizer at full width --------------------------
    t0 = time.perf_counter()
    xg = x_cz[:CZ_GOLDEN_CHANNELS].cpu().numpy().astype(np.float64)
    cz_golden = ss.upfirdn(chan["fused"].resample_taps,
                           ss.lfilter(cz_taps, [1.0], xg, axis=-1),
                           UP, DOWN, axis=-1)
    log(f"[golden] scipy f64 lfilter + upfirdn of {CZ_GOLDEN_CHANNELS} "
        f"channelizer channels in {time.perf_counter() - t0:.1f} s")

    def streaming(ch, x, n_steps):
        """Unsharded streaming at t_loc granularity: per super-block the
        frames of all pieces, and the final state."""
        st = ch.init_state(x.shape[0])
        outs = []
        for _ in range(n_steps):
            frames = []
            for j in range(CZ_RANKS):
                spec, st = ch.step(x[:, j * t_loc:(j + 1) * t_loc], st)
                frames.append(spec)
            outs.append(torch.cat(frames, dim=1))
        return outs, st

    def sharded(ch, shards, halo, n_steps):
        step = ch.sharded_step(mesh, halo=halo)
        st = ch.init_state(shards[0].shape[0], device=mesh.ranks[0].device)
        outs = []
        for _ in range(n_steps):
            spec, st = step(shards, st)
            outs.append(gather_time(spec, mesh, dim=1))
        hr.check_exchanges(mesh)
        return outs, st

    def check_sharded(label, ch, x, shards, halos, mode):
        """Two super-blocks through ``step`` and through ``sharded_step``
        for each halo mode, at precision ``mode`` (which the caller has
        set); the first halo mode is compared bitwise with the others, and
        with unsharded streaming at the floor."""
        label = f"{label} {mode}"
        ref, st_ref = streaming(ch, x, 2)
        nf = ref[0].shape[1]
        if ref[0].shape != (x.shape[0], nf, ch.fft_n // 2 + 1) or not all(
                bool(torch.isfinite(torch.view_as_real(v)).all())
                for v in ref):
            raise RuntimeError(f"{label}: bad step output {ref[0].shape}")
        first = None
        for halo in halos:
            got, st = sharded(ch, shards, halo, 2)
            for i in (0, 1):
                snr = device_snr_db(ref[i], got[i])
                log(f"[channelizer] {label} halo={halo}: super-block {i + 1} "
                    f"{tuple(got[i].shape)} vs unsharded streaming "
                    f"{snr:.1f} dB (floor {SHARDED_FLOOR_DB})")
                if got[i].shape != ref[i].shape or \
                        not snr >= SHARDED_FLOOR_DB:
                    raise RuntimeError(f"{label} halo={halo}: sharded != "
                                       f"unsharded streaming ({snr:.1f} dB)")
            for a, b in zip(st, st_ref):
                if not torch.equal(a, b):
                    raise RuntimeError(f"{label} halo={halo}: carried state "
                                       f"!= unsharded streaming's")
            if first is None:
                first = got
            elif not all(torch.equal(a, b) for a, b in zip(first, got)):
                raise RuntimeError(f"{label}: halo={halo} != "
                                   f"halo={halos[0]} bitwise")
            else:
                log(f"[channelizer] {label}: halo={halo} == halo={halos[0]} "
                    f"bitwise, both super-blocks")
        # the resampled signal behind the first super-block's frames
        z = irfft(first[0][:CZ_GOLDEN_CHANNELS], ch.fft_n).reshape(
            CZ_GOLDEN_CHANNELS, -1).cpu().numpy()
        snr = min_channel_snr_db(cz_golden[:, :z.shape[1]], z)
        log(f"[channelizer] {label}: {CZ_GOLDEN_CHANNELS} channels vs scipy "
            f"f64, min-channel SNR {snr:.1f} dB (floor "
            f"{CHAIN_FLOOR_DB[mode]})")
        if not snr >= CHAIN_FLOOR_DB[mode]:
            raise RuntimeError(f"{label}: SNR vs scipy {snr:.1f} dB")

    for mode in MODES[::-1]:  # "highest" (the default), then "high"
        reset_launches()
        for label, ch, x, shards, halos in (
                (f"fused {CZ_CHANNELS}ch", chan["fused"], x_cz, parts,
                 ("rdma", "ppermute")),
                (f"block2 {CZ_CHANNELS}ch", chan["block2"], x_cz, parts,
                 ("rdma", "ppermute")),
                (f"block2 {CZ_FUSED_CHANNELS}ch", chan["block2"],
                 x_cz[:CZ_FUSED_CHANNELS], parts_f,
                 ("rdma_fused", "ppermute"))):
            with matmul_precision(mode):
                check_sharded(label, ch, x, shards, halos, mode)
            torch.cuda.empty_cache()
        # the counts in the ``kernels`` line are those of the last pass
        # ("high"): the same paths and launches as the "highest" pass
        launches = read_launches(KERNEL_NAMES, f"channelizer {mode}")

    # ---- phase 5: times ---------------------------------------------------
    def timed(plain, kern, library=None, iters=20):
        """Medians in ms: plain, kernel, kernel, plain within one run, then
        the library call."""
        p1, k1, k2, p2 = (cuda_ms(f, iters) for f in
                          (plain, kern, kern, plain))
        return (float(np.median([k1, k2])), float(np.median([p1, p2])),
                None if library is None else cuda_ms(library, iters))

    def conv1d_fir(xpad, taps_np):
        """The library's causal FIR: cuDNN conv1d (TF32 off) of rows with
        ntaps - 1 samples of history prepended, with the flipped taps."""
        w = torch.from_numpy(taps_np[::-1].copy()).to(
            torch.float32).to(dev)[None, None, :]
        rows = xpad.contiguous()[:, None, :]
        return lambda: F.conv1d(rows, w)[:, 0]

    block = block2_block(NTAPS)
    x = blocks[0]
    hist = torch.zeros((CHANNELS, 2 * block), device=dev)
    xpad = torch.cat([hist[:, :block], x], dim=-1).contiguous()
    samples = CHANNELS * BLOCK_T
    times, bounds, bounds_high = {}, {}, {}
    for mode in MODES:
        for name, kern, plain, library in (
            ("block2_fir",
             lambda: bf.block2_fir_cuda(xpad, taps, block, mode),
             lambda: bf.block2_fir_plain(xpad, taps, block, mode),
             conv1d_fir(xpad[:, block - (NTAPS - 1):], taps)),
            ("fused_fir_resample",
             lambda: ff.fused_fir_resample_cuda(x, hist, taps, UP, DOWN,
                                                rtaps, mode),
             lambda: ff.fused_fir_resample_plain(x, hist, taps, UP, DOWN,
                                                 rtaps, mode),
             None),
        ):
            times[(name, mode)] = timed(
                plain, kern, library if mode == "highest" else None)
            ms, pms, lms = times[(name, mode)]
            was = (f" (was {PREVIOUS[name + ' ms'][mode]} ms)"
                   if name + " ms" in PREVIOUS else "")
            log(f"[time] {name} {mode:7s} {CHANNELS}x{BLOCK_T}: kernel "
                f"{ms:.3f} ms/step{was} ({samples / ms / 1e3:.0f} "
                f"Msamples/s), plain {pms:.3f} ms/step "
                f"({samples / pms / 1e3:.0f} Msamples/s), library {lms} ms "
                f"on {smi}")
    # bounds, from the function's own work: ntaps products per FIR sample
    # and the K nonzero bank entries per resampled output.  "highest": fp32
    # multiply-adds outside the tensor cores.  "high": the same products in
    # three bf16 passes on the tensor cores.  (What the kernels compute on
    # top, the 8-wide tile's 7 extra rows and B1's dense stage-2 chunks, is
    # waste and not part of the bound.)
    n_out = samples * UP // DOWN
    by_b2 = 4.0 * (xpad.numel() + samples)
    by_b1 = 4.0 * (samples + hist.numel() + n_out)
    bounds["block2_fir"] = fir_bound_ms(2.0 * NTAPS * samples, by_b2)
    bounds["fused_fir_resample"] = fir_bound_ms(
        2.0 * NTAPS * samples + 2.0 * K * n_out, by_b1)
    bounds_high["block2_fir"] = fir_bound_ms(
        3 * 2.0 * NTAPS * samples, by_b2, BF16_PEAK)
    bounds_high["fused_fir_resample"] = fir_bound_ms(
        3 * (2.0 * NTAPS * samples + 2.0 * K * n_out), by_b1, BF16_PEAK)
    for name in ("block2_fir", "fused_fir_resample"):
        log(f"[time] {name} bound: {bounds[name][0]:.3f} ms ({bounds[name][1]}"
            f", fp32 at {FP32_PEAK / 1e12:.0f} TFLOP/s) at highest, "
            f"{bounds_high[name][0]:.3f} ms ({bounds_high[name][1]}, three "
            f"bf16 passes at {BF16_PEAK / 1e12:.0f} TFLOP/s) at high")
    # B1's wgmma path at "highest": stage 1 in six bf16 passes on the
    # tensor cores while stage 2's fp32 FMA runs on the CUDA cores
    six = max(fir_bound_ms(6 * 2.0 * NTAPS * samples, by_b1, BF16_PEAK),
              fir_bound_ms(2.0 * K * n_out, by_b1))
    log(f"[time] fused_fir_resample bound on its wgmma path at highest: "
        f"{six[0]:.3f} ms ({six[1]}, stage 1 in six bf16 passes, stage 2 "
        f"on fp32 FMA)")
    del x_all, blocks, x, xpad

    # B3 at the fused chain's halo (1024 x 2048), B4 at 256 x 327 680
    h = chan["fused"].h_fir
    tails = [p[:, -h:] for p in parts[:-1]]
    recv = [torch.empty((CZ_CHANNELS, h), device=dev) for _ in tails]
    def copy_tails():
        for d, v in zip(recv, tails):
            d.copy_(v)

    # the library call under the same fork and join as the kernel, and bare
    times[("halo_ring", "highest")] = timed(
        on_mesh(lambda: hr.left_halo_ring_plain(parts, h, mesh)),
        on_mesh(lambda: hr.left_halo_ring(parts, h, mesh)),
        on_mesh(copy_tails))
    copy_bare_ms = cuda_ms(copy_tails)
    log(f"[time] halo_ring library call, Tensor.copy_ of the "
        f"{len(tails)} tails: {times[('halo_ring', 'highest')][2]:.3f} ms "
        f"under fork/join, {copy_bare_ms:.3f} ms bare (was 0.034 bare)")
    bounds["halo_ring"] = fir_bound_ms(
        0.0, 4.0 * CZ_CHANNELS * h * (2 * CZ_RANKS - 1))
    for what, fn in (("kernel", hr.left_halo_ring),
                     ("plain", hr.left_halo_ring_plain)):
        ms = host_ms(on_mesh(lambda: fn(parts, h, mesh)))
        log(f"[time] halo_ring {what}: the host takes {ms:.3f} ms to enqueue "
            f"one exchange of {CZ_RANKS} ranks x ({CZ_CHANNELS}, {h}), fork "
            f"and join included (the kernel's was "
            f"{PREVIOUS['halo_ring host ms']} ms)")
    ms = host_ms(on_mesh(lambda: None))
    log(f"[time] fork and join alone: the host takes {ms:.3f} ms")
    for hh in halo_widths[:2]:
        ms = cuda_ms(on_mesh(lambda: hr.left_halo_ring(parts, hh, mesh)))
        log(f"[time] halo_ring {CZ_RANKS} ranks x ({CZ_CHANNELS}, {hh}): "
            f"kernel {ms:.3f} ms per exchange on {smi}")
    halo_f = left_halo(parts_f, cz_block, mesh)
    padded = [torch.cat([hv, p], -1) for hv, p in zip(halo_f, parts_f)]
    libs = [conv1d_fir(v[:, cz_block - (len(cz_taps) - 1):], cz_taps)
            for v in padded]
    for mode in MODES:
        times[("halo_fir_fused", mode)] = timed(
            on_mesh(lambda: hf.block2_fir_halo_fused_plain(
                parts_f, cz_taps, mesh, mode=mode)),
            on_mesh(lambda: hf.block2_fir_halo_fused(
                parts_f, cz_taps, mesh, mode=mode)),
            (lambda: [f() for f in libs]) if mode == "highest" else None,
            iters=10)
    hr.check_exchanges(mesh)
    cz_samples = CZ_FUSED_CHANNELS * CZ_RANKS * t_loc
    bounds["halo_fir_fused"] = fir_bound_ms(
        2.0 * len(cz_taps) * cz_samples, 4.0 * 2 * cz_samples)
    bounds_high["halo_fir_fused"] = fir_bound_ms(
        3 * 2.0 * len(cz_taps) * cz_samples, 4.0 * 2 * cz_samples, BF16_PEAK)
    for name in ("halo_ring", "halo_fir_fused"):
        for mode in MODES:
            if (name, mode) in times:
                ms, pms, lms = times[(name, mode)]
                was = f" (was {PREVIOUS[name + ' ms'][mode]} ms)"
                bound = (bounds_high if mode == "high" else bounds)[name]
                log(f"[time] {name} {mode:7s} {CZ_RANKS} ranks: kernel "
                    f"{ms:.3f} ms{was}, plain {pms:.3f} ms, library {lms} "
                    f"ms, bound {bound[0]:.3f} ms ({bound[1]}) on {smi}")
    del padded, libs, halo_f, recv, tails
    torch.cuda.empty_cache()

    # one sharded step per halo mode
    for label, ch, shards, halos, mode in (
            (f"fused {CZ_CHANNELS}ch", chan["fused"], parts,
             ("rdma", "ppermute"), "highest"),
            (f"fused {CZ_CHANNELS}ch", chan["fused"], parts,
             ("rdma",), "high"),
            (f"block2 {CZ_CHANNELS}ch", chan["block2"], parts,
             ("rdma", "ppermute"), "highest"),
            (f"block2 {CZ_FUSED_CHANNELS}ch", chan["block2"], parts_f,
             ("rdma_fused", "rdma", "ppermute"), "highest"),
            (f"block2 {CZ_CHANNELS}ch", chan["block2"], parts,
             ("rdma", "ppermute"), "high"),
            (f"block2 {CZ_FUSED_CHANNELS}ch", chan["block2"], parts_f,
             ("rdma_fused", "rdma", "ppermute"), "high")):
        st = ch.init_state(shards[0].shape[0])
        for halo in halos:
            with matmul_precision(mode):
                step = ch.sharded_step(mesh, halo=halo)
                ms = cuda_ms(lambda: step(shards, st), iters=5, warmup=1)
            n_in = shards[0].shape[0] * CZ_RANKS * t_loc
            was = (f" (was {PREVIOUS['fused sharded step ms']} ms)"
                   if ch is chan["fused"] and mode == "highest" else "")
            log(f"[time] sharded_step {label} {mode} halo={halo}: {ms:.3f} "
                f"ms{was} per step of {shards[0].shape[0]}x"
                f"{CZ_RANKS * t_loc} ({n_in / ms / 1e3:.0f} Msamples/s) on "
                f"{smi}")
    hr.check_exchanges(mesh)

    # ---- phase 6: configs 1 and 2 and the fir / resample tools ----------
    del parts, parts_f, x_cz
    torch.cuda.empty_cache()
    by_path = {name: {"channelizer high": n}
               for name, n in launches.items()}
    config_launches, err = configs_1_and_2(dev, smi, rng, reset_launches,
                                           read_launches)
    by_path["block2_fir"].update(config_launches)
    launches["block2_fir"] += sum(config_launches.values())
    errors["block2_fir"] = max(errors["block2_fir"], err)

    # ---- phase 7: config 4, the stft and channelizer tools, B2's limits --
    err, wola_entry = config_4_and_tools(dev, smi)
    errors["block2_fir"] = max(errors["block2_fir"], err)

    # ---- phase 8: config 3 and the iir tool ------------------------------
    reset_launches()
    scan_entry = config_3_and_tool(dev, smi)
    got = {name: w.launches for name, w in wrappers.items()}
    log(f"[config3] FIR kernel launches on this path: {got} (none "
        f"expected)")
    if any(got.values()):
        raise RuntimeError(f"config 3 launched a FIR kernel: {got}")

    # ---- phase 9: the remaining ops at the configs' widths ---------------
    reset_launches()
    remaining_ops(dev, smi)
    got = {name: w.launches for name, w in wrappers.items()}
    log(f"[phase9] kernel launches on this path: {got} (none expected)")
    if any(got.values()):
        raise RuntimeError(f"phase 9 launched a hand kernel: {got}")
    # ---- phase 10: the sharded modules on ranks of the card ---------------
    t0 = time.perf_counter()
    for name, paths in parallel_paths(dev, smi, wrappers).items():
        by_path[name].update(paths)
        launches[name] += sum(paths.values())
    log(f"[phase10] all paths in {time.perf_counter() - t0:.1f} s")
    # ---- phase 11: several cards (on one, B3's protocol alone) -----------
    t0 = time.perf_counter()
    paths11, across, net11 = multicard_paths(dev, smi, wrappers)
    for name, paths in paths11.items():
        by_path[name].update(paths)
        launches[name] += sum(paths.values())
    log(f"[phase11] all paths in {time.perf_counter() - t0:.1f} s")
    # ---- phase 12: across processes, through CUDA IPC ---------------------
    t0 = time.perf_counter()
    paths12, across12 = process_paths(dev, smi, wrappers)
    for name, paths in paths12.items():
        by_path[name].update(paths)
        launches[name] += sum(paths.values())
    log(f"[phase12] all paths in {time.perf_counter() - t0:.1f} s")
    log(f"[memory] peak device memory allocated in this run: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")

    sources = {
        "fused_fir_resample": "llzlab_tpu/kernels/fused_fir_resample.py:202",
        "block2_fir": "llzlab_tpu/kernels/block2_fir.py:135",
        "halo_ring": "llzlab_tpu/kernels/halo_ring.py:41",
        "halo_fir_fused": "llzlab_tpu/kernels/halo_fir_fused.py:101",
    }
    kernels = []
    for name, replaces in sources.items():
        ms, pms, lms = times[(name, "highest")]
        entry = {
            "name": name, "route": "cuda",
            "source": f"llzlab_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": by_path[name],
            "max_abs_err": errors[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": lms,
        }
        if name == "halo_ring":
            entry["library_ms_bare"] = copy_bare_ms
        if name in across:  # phase 11, one rank a card
            entry["ms_across_cards"] = across[name]["ms"]
            entry["cards_across"] = across[name]["cards"]
        if name in across12:  # phase 12, two processes of one card first
            entry["ms_across_processes"] = across12[name][
                "2 processes of one card"]
            entry["ms_across_processes_by_layout"] = across12[name]
            # a process a card as two hosts (NET edges through NCCL):
            # needs two cards, else None
            entry["ms_across_hosts"] = across12[name].get(
                "2 hosts, a process a card")
        if name in net11:  # phase 11: every edge NET, ranks of one card
            entry["ms_net_edges_one_card"] = net11[name]["ms"]
        if (name, "high") in times:
            entry["ms_high"], entry["plain_ms_high"] = \
                times[(name, "high")][:2]
            entry["bound_ms_high"] = bounds_high[name][0]
        kernels.append(entry)
    kernels.append({"name": SCAN_KERNEL, "route": "cuda",
                    "source": f"llzlab_tpu_torch/csrc/{SCAN_KERNEL}.cu",
                    "replaces": None, "library_ms": None, **scan_entry})
    kernels.append(wola_entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

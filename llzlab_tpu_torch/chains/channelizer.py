"""Wideband channelizer, the flagship chain (port of
``llzlab_tpu/chains/channelizer.py``).

``x (C, T)`` → 1024-tap FIR band-shaping → 147/160 polyphase resample →
2048-point spectral framing, on one device (:meth:`Channelizer.step`) or
sharded over a ``(time,)`` or ``(channel, time)`` mesh
(:meth:`Channelizer.sharded_step`).  The sharded step's steady-state
communication is the left halo inside each channel row: each rank needs
its left neighbour's last samples as FIR history and as resampler history;
with ``frames="a2a"`` one all-to-all follows the resampler.  Everything
else is local work: kernel B1 (``fir_method="fused"``) or kernel B2 plus a
matrix product (``"block2"``), then ``torch.fft``.

One process drives every rank it holds (``parallel/mesh.py``), so the
sharded step takes and returns one tensor per rank where the JAX package
passes one sharded array through ``shard_map``.  The ranks may sit on
several cards and in several processes
(``runtime.distributed.global_dsp_mesh``, as the JAX package's step runs
under ``jax.distributed``), with every halo mode (the kernel halos across
the processes of one host): each process then passes and gets back the
whole stream state on its first rank (``DspMesh.home``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from llzlab_tpu_torch.kernels import fused_fir_resample as _ff
from llzlab_tpu_torch.kernels.halo_fir_fused import block2_fir_halo_fused
from llzlab_tpu_torch.kernels.halo_ring import (check_exchanges,
                                                left_halo_ring)
from llzlab_tpu_torch.ops import fir as _fir
from llzlab_tpu_torch.ops import resample as _rs
from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.kernels.block2_fir import plain_tables
from llzlab_tpu_torch.parallel.halo import left_halo, row_values
from llzlab_tpu_torch.parallel.mesh import (CHANNEL_AXIS, TIME_AXIS, DspMesh,
                                            local_block, note_traffic)
from llzlab_tpu_torch.parallel.reshard import to_channel_major
from llzlab_tpu_torch.runtime.platform import kernel_mode
from llzlab_tpu_torch.runtime.profiler import request, span

__all__ = ["Channelizer"]


def _lcm(a, b):
    return a * b // math.gcd(a, b)


class Channelizer:
    """FIR → resample → FFT chain, on one device or sharded over time.

    Args:
      fir_taps: band-shaping FIR (default 1024-tap 0.4·Nyquist lowpass).
      up, down: resampling ratio (default 147/160 = 48 k→44.1 k).
      fft_n: spectral frame length (default 2048).
      resample_taps: polyphase prototype (default 64 taps/phase design).
      fir_method: "auto" | "fused" (kernel B1,
        ``kernels/fused_fir_resample.py``) | "block2" (kernel B2) | "ols" |
        "direct".  "auto" resolves for ``device``: on CUDA "fused" when
        the fused kernel's static envelope accepts the filter, else
        "block2" up to 2048 taps, else "ols"; on the CPU "ols".
      fft_method: passed to ``ops.transform.rfft``.
      spec_format: "complex" (default) emits complex64 frames
        ``(C, F, fft_n//2+1)``; "pair" emits the (re | im) pair layout
        ``(C, F, fft_n+2)`` f32 (``ops.transform.rfft_pair``;
        ``pair_to_complex`` converts).
      device: where :meth:`init_state` puts the state, and what "auto"
        resolves for.
    """

    def __init__(
        self,
        *,
        fir_taps=None,
        up: int = 147,
        down: int = 160,
        fft_n: int = 2048,
        resample_taps=None,
        taps_per_phase: int = 64,
        fir_method: str = "auto",
        fft_method: str = "auto",
        spec_format: str = "complex",
        device="cuda",
    ):
        if spec_format not in ("complex", "pair"):
            raise ValueError(f"unknown spec_format {spec_format!r}")
        self.spec_format = spec_format
        self.device = torch.device(device)
        if fir_taps is None:
            fir_taps = _fir.firwin(1024, 0.4, window="hamming")
        self.fir_taps = np.asarray(fir_taps, np.float64)
        g = math.gcd(up, down)
        self.up, self.down = up // g, down // g
        if resample_taps is None:
            resample_taps = _rs.resample_taps(self.up, self.down,
                                              taps_per_phase)
        rt = np.asarray(resample_taps, np.float64)
        if len(rt) % self.up:
            rt = np.pad(rt, (0, self.up - len(rt) % self.up))
        self.resample_taps = rt
        self.k = len(rt) // self.up
        self.fft_n = fft_n
        ntaps = len(self.fir_taps)
        on_cuda = self.device.type == "cuda"
        if fir_method == "auto":
            if on_cuda and _ff.fused_static_ok(ntaps, self.up, self.down,
                                               self.k):
                fir_method = "fused"
            elif on_cuda and ntaps <= 2048:
                fir_method = "block2"
            else:
                fir_method = "ols"
        self.fir_method = fir_method
        self.fft_method = fft_method
        self.nfft = _fir.default_nfft(ntaps)
        if fir_method == "fused":
            if not _ff.fused_static_ok(ntaps, self.up, self.down, self.k):
                raise ValueError(
                    "fir_method='fused' rejected: filter/ratio outside "
                    "the fused kernel's envelope (see fused_static_ok)")
            # One combined state: the last 2·block INPUT samples carry both
            # the FIR history and the resampler's y-lookback reach.
            self.h_fir = _ff.fused_state_len(ntaps)
            self.h_rs = 0
        else:
            self.h_fir = _fir.fir_state_len(ntaps, self.nfft, fir_method)
            self.h_rs = self.k - 1

    # ---------------- granularity ----------------

    def block_multiple(self, frames: str = "local") -> int:
        """Smallest per-shard T granularity satisfying every stage: a
        multiple of the FIR engine's hop and of ``down``, with the
        resampled length a multiple of ``fft_n``.  ``frames="a2a"`` drops
        the ``fft_n`` term, as in the JAX package."""
        ntaps = len(self.fir_taps)
        if self.fir_method == "ols":
            hop = _fir.ols_hop(ntaps, self.nfft)
        elif self.fir_method == "block2":
            hop = _fir.block2_block(ntaps)
        elif self.fir_method == "fused":
            hop = _ff.fused_program_in(ntaps, self.up, self.down)
        else:
            hop = 1
        m = _lcm(hop, self.down)
        if frames == "a2a":
            return m
        # need (m·k)·up/down % fft_n == 0 → k a multiple of fft_n/gcd
        per = m * self.up // self.down  # resampled samples per m inputs
        k = self.fft_n // math.gcd(per, self.fft_n)
        return m * k

    # ---------------- state ----------------

    def init_state(self, n_channels: int, dtype=torch.float32, *,
                   device=None):
        device = self.device if device is None else device
        return (
            torch.zeros((n_channels, self.h_fir), dtype=dtype, device=device),
            torch.zeros((n_channels, self.h_rs), dtype=dtype, device=device),
        )

    # ---------------- single-device step ----------------

    def _fused_step(self, x: torch.Tensor, hist: torch.Tensor,
                    return_zf: bool = True):
        """Fused-engine local compute: ``(x, 2·block input history)`` →
        ``(z, new_history)``, or ``z`` alone without ``return_zf``.

        Runs kernel B1 (its plain version on a CPU tensor) when the call's
        shapes fit its envelope; otherwise the unfused pair on the SAME
        state layout: the 2·block history holds the block2 FIR history,
        and the resampler's k−1 y-samples are recomputed from it (they
        depend only on the last k−1+ntaps−1 ≤ 2·block inputs).
        """
        ntaps = len(self.fir_taps)
        c = int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1
        t = x.shape[-1]
        if _ff.fused_supports(c, ntaps, self.up, self.down, self.k, t):
            return _ff.fused_fir_resample(
                x, self.fir_taps, self.up, self.down, self.resample_taps,
                zi=hist, return_zf=return_zf, mode=kernel_mode())
        block = _fir.block2_block(ntaps)
        y = _fir.fir_filter(x, self.fir_taps, method="block2",
                            zi=hist[..., -block:])
        yh = _fir.fir_filter(hist, self.fir_taps, method="block2")
        rs_zi = yh[..., yh.shape[-1] - (self.k - 1):]
        z = _rs.resample_poly(y, self.up, self.down,
                              taps=self.resample_taps, zi=rs_zi)
        if not return_zf:
            return z
        zf = torch.cat([hist, x.to(hist.dtype)],
                       dim=-1)[..., -hist.shape[-1]:]
        return z, zf

    def step(self, x: torch.Tensor, state):
        """Unsharded step: ``(C, T)`` → ``(C, F, fft_n//2+1)``."""
        with request("chains", "Channelizer.step"):
            if self.fir_method == "fused":
                hist, rs_st = state
                z, zf = self._fused_step(x, hist)
                return self._frames(z), (zf, rs_st)
            fir_st, rs_st = state
            y, fir_tail = _fir.fir_filter(
                x, self.fir_taps, method=self.fir_method, nfft=self.nfft,
                zi=fir_st, return_zf=True)
            z, rs_tail = _rs.resample_poly(
                y, self.up, self.down, taps=self.resample_taps, zi=rs_st,
                return_zf=True)
            return self._frames(z), (fir_tail, rs_tail)

    def _frames(self, z: torch.Tensor) -> torch.Tensor:
        with span("chains", "frames"):
            c = z.shape[0]
            nf = z.shape[-1] // self.fft_n
            zf = z[..., : nf * self.fft_n].reshape(c, nf, self.fft_n)
            if self.spec_format == "pair":
                return _tf.rfft_pair(zf, self.fft_n)
            return _tf.rfft(zf, self.fft_n, method=self.fft_method)

    # ---------------- sharded step ----------------

    def sharded_step(self, mesh: DspMesh, *, halo: str = "ppermute",
                     frames: str = "local", halo_overlap: bool = False):
        """Build the mesh-sharded step ``(parts, state) → (spec_parts,
        state)`` on a ``(time,)`` or ``(channel, time)`` mesh: channels
        data-parallel over the channel axis, time sequence-parallel over
        the time axis, each channel row's halos inside its row.

        ``parts``: one ``(C / n_channel, T_loc)`` tensor per rank, on the
        rank's device (``parallel.mesh.shard``), ``T_loc`` a multiple of
        :meth:`block_multiple` of ``frames``.  ``spec_parts``: each rank's
        frames, on its device: with ``frames="local"`` the frames of its
        own time block (``gather(spec_parts, mesh, dim=1)`` joins them),
        with ``"a2a"`` every frame of the stream for its channel block of
        the channel-major layout (``gather(spec_parts, mesh,
        spec=CHANNEL_MAJOR)``).  ``state``: the pair of :meth:`init_state`
        for all ``C`` channels, on rank 0's device; each channel row takes
        its rows, and the state returned holds each row's last rank's
        tail, copied to rank 0.  On a mesh across processes each process
        passes the state on its own first rank
        (``mesh.home``), the ranks of other processes are None in
        ``parts`` and ``spec_parts``, and each row's last rank sends its
        tail to every process's first rank, so that every process gets
        the whole state back.

        The step's work is queued behind the caller's current stream and
        that stream is made to wait for it; the step does not wait for its
        own work.  With ``halo="rdma"`` or ``"rdma_fused"`` on a CUDA mesh
        a receive can time out on the card (its sender never came), and
        the kernel then goes on with an invalid halo.  That raises
        ``RuntimeError`` in the NEXT call of the step, which queues its
        own work, then waits for the previous call's and reads its error
        words: the outputs of call ``s`` are valid once call ``s + 1``,
        or ``kernels.halo_ring.check_exchanges(mesh)`` after the last
        call, has returned.

        ``halo``: "ppermute" (plain copies between ranks,
        ``parallel/halo.py``), "rdma" (kernel B3, ``kernels/halo_ring.py``:
        the exchange as a kernel of its own), or "rdma_fused" (kernel B4,
        ``kernels/halo_fir_fused.py``: the exchange inside the block2 FIR
        kernel, which computes every output that needs no halo while the
        tail travels; needs ``fir_method="block2"``; the resampler's halo
        still goes through B3).  The kernels need a 1-D ``(time,)`` mesh
        (``mesh.row(0)`` of a global ``(1, n)`` mesh), on one card or
        several (peer access between them), in one process or in several
        (through CUDA IPC within a host; between hosts the tails travel
        through NCCL and the kernels keep their wait, which needs a NCCL
        process group).
        Across processes every process must call the step the same number
        of times (``kernels/halo_ring.py``).  On a CPU mesh their plain
        versions run.

        ``halo_overlap``: the linear stages split as ``f(halo, x) = f(0,
        x) + f(halo, 0)``, so that the exchange feeds only a correction of
        one block (``"block2"``: B2 with no history, plus ``halo @ B`` on
        the first block; the resampler's halo likewise) or of one program
        (``"fused"``: B1 with a zero history, plus B1 on a zero program
        with the halo).  Each rank's bulk launch is queued before its
        exchange.  The split reassociates float32 sums, so the step equals
        the exact one to about 140 dB, not bit for bit.

        ``frames``: "local" frames each time block on its rank (its
        resampled length a multiple of ``fft_n``); "a2a" reshards the
        resampled signal to channel-major with one all-to-all
        (``parallel/reshard.py``), so that frames span the whole stream
        and straddle the time blocks (needs ``C`` divisible by the rank
        count).
        """
        axes = tuple(mesh.axis_names)
        if axes not in ((TIME_AXIS,), (CHANNEL_AXIS, TIME_AXIS)):
            raise ValueError(f"sharded_step needs a ({TIME_AXIS!r},) or "
                             f"({CHANNEL_AXIS!r}, {TIME_AXIS!r}) mesh, got "
                             f"{axes}")
        if halo in ("rdma", "rdma_fused"):
            if axes != (TIME_AXIS,):
                raise ValueError(
                    f"halo={halo!r} needs a 1-D (time,) mesh: the halo "
                    "kernels address their right neighbour on one axis "
                    "(see kernels/halo_ring.py)")
            if halo == "rdma_fused" and self.fir_method != "block2":
                raise ValueError(
                    "halo='rdma_fused' fuses the exchange into the "
                    "block2 FIR kernel — needs fir_method='block2' "
                    f"(got {self.fir_method!r})")
            if halo == "rdma_fused" and halo_overlap:
                raise ValueError(
                    "halo='rdma_fused' already overlaps the exchange "
                    "inside the kernel; halo_overlap does not compose")
            halo_fn = left_halo_ring
        elif halo == "ppermute":
            halo_fn = left_halo
        else:
            raise ValueError(f"unknown halo mode {halo!r}")
        if frames not in ("local", "a2a"):
            raise ValueError(f"unknown frames mode {frames!r}")
        if halo_overlap and self.fir_method not in ("fused", "block2"):
            raise ValueError(
                "halo_overlap needs fir_method 'fused' or 'block2' "
                f"(got {self.fir_method!r})")
        n = len(mesh)
        rows = mesh.rows()
        ntaps = len(self.fir_taps)
        block = _fir.block2_block(ntaps)

        def zeros_like_rows(v, width):
            return torch.zeros(v.shape[:-1] + (width,), dtype=v.dtype,
                               device=v.device)

        homes = mesh.homes

        def tails(ends: Sequence[torch.Tensor], h: int, ref: torch.Tensor):
            """Each row's last rank's last ``h`` samples (None where that
            rank lives in another process) on every process's first rank
            (rank 0 in one process), the rows joined along the channels on
            this process's; ``ref``: a block of the same rows and type."""
            shape = tuple(ref.shape[:-1]) + (h,)
            got = []
            for row, last in zip(rows, ends):
                tail = None if last is None else \
                    last[..., last.shape[-1] - h:]
                for home in homes:
                    v = mesh.move(row[-1], home, tail, shape, ref.dtype)
                    if home == mesh.home:
                        got.append(v)
            note_traffic("collective-permute",
                         int(np.prod(shape)) * ref.element_size(),
                         sum(home != row[-1] for row in rows
                             for home in homes))
            if len(got) == 1:
                return got[0]
            with mesh.on(mesh.home):
                return torch.cat(got, dim=0)

        def fused_row(rmesh, xs, fir_st):
            if not halo_overlap:
                # ONE halo: the 2·block input history carries both the FIR
                # reach and the resampler's y-lookback.
                halos = halo_fn(xs, self.h_fir, rmesh,
                                first_shard_value=fir_st)
                return rmesh.map(lambda x, hv: self._fused_step(
                    x, hv, return_zf=False), xs, halos)
            p = _ff.fused_program_in(ntaps, self.up, self.down)
            p_out = p * self.up // self.down
            z = rmesh.map(lambda x: self._fused_step(
                x, zeros_like_rows(x, self.h_fir), return_zf=False), xs)
            halos = halo_fn(xs, self.h_fir, rmesh, first_shard_value=fir_st)

            def correct(z0, hv):
                zc = self._fused_step(zeros_like_rows(hv, p), hv,
                                      return_zf=False)
                z0[..., :p_out] += zc[..., :p_out]
                return z0

            return rmesh.map(correct, z, halos)

        def fir_row(rmesh, xs, fir_st):
            if halo == "rdma_fused":
                return block2_fir_halo_fused(
                    xs, self.fir_taps, rmesh, first_shard_value=fir_st,
                    mode=kernel_mode())
            if not halo_overlap:
                halos = halo_fn(xs, self.h_fir, rmesh,
                                first_shard_value=fir_st)
                return rmesh.map(lambda x, hv: _fir.fir_filter(
                    x, self.fir_taps, method=self.fir_method,
                    nfft=self.nfft, zi=hv), xs, halos)
            # y_0 = x_0 @ A + halo @ B: only the B term waits
            y = rmesh.map(lambda x: _fir.fir_filter(
                x, self.fir_taps, method="block2"), xs)
            halos = halo_fn(xs, self.h_fir, rmesh, first_shard_value=fir_st)

            def correct(y0, hv):
                bm = plain_tables(self.fir_taps, block, "highest",
                                  hv.device)[0][:block]
                y0[..., :block] += hv @ bm
                return y0

            return rmesh.map(correct, y, halos)

        def resample_row(rmesh, y, rs_st):
            if not halo_overlap:
                halos = halo_fn(y, self.h_rs, rmesh, first_shard_value=rs_st)
                return rmesh.map(lambda v, hv: _rs.resample_poly(
                    v, self.up, self.down, taps=self.resample_taps, zi=hv),
                    y, halos)
            # the history feeds only the first ceil((k−1)/down) groups
            z = rmesh.map(lambda v: _rs.resample_poly(
                v, self.up, self.down, taps=self.resample_taps), y)
            halos = halo_fn(y, self.h_rs, rmesh, first_shard_value=rs_st)
            t0 = self.down * (-(-(self.k - 1) // self.down))

            def correct(z0, hv):
                zc = _rs.resample_poly(zeros_like_rows(hv, t0), self.up,
                                       self.down, taps=self.resample_taps,
                                       zi=hv)
                z0[..., :zc.shape[-1]] += zc
                return z0

            return rmesh.map(correct, z, halos)

        kernels_exchange = halo != "ppermute" and mesh.is_cuda
        issued = []  # per rank, the end of the previous call's work

        def rows_step(parts, fir_st, rs_st, ref):
            """Each channel row's FIR and resampler: ``(z, x_ends,
            y_ends)``, ``z`` the resampled block of each rank."""
            if len(rows) > 1:
                fir_rows = row_values(fir_st, mesh)
                rs_rows = row_values(rs_st, mesh)
            else:
                fir_rows, rs_rows = [fir_st], [rs_st]
            z = [None] * n
            x_ends, y_ends = [], []
            for c, row in enumerate(rows):
                rmesh = mesh.row(c)
                xs = [parts[r] for r in row]
                x_ends.append(xs[-1])
                if all(v is None for v in xs):
                    # a row of other processes: note its halos, as they do
                    for h in (self.h_fir, self.h_rs):
                        note_traffic("collective-permute",
                                     ref.shape[0] * h * ref.element_size(),
                                     (len(row) - 1) * (h > 0))
                    y_ends.append(None)
                    continue
                if self.fir_method == "fused":
                    zs = fused_row(rmesh, xs, fir_rows[c])
                else:
                    y = fir_row(rmesh, xs, fir_rows[c])
                    y_ends.append(y[-1])
                    zs = resample_row(rmesh, y, rs_rows[c])
                for r, v in zip(row, zs):
                    z[r] = v
            return z, x_ends, y_ends

        def step(parts: Sequence[torch.Tensor], state):
            if len(parts) != n:
                raise ValueError(f"{len(parts)} blocks for {n} ranks")
            with request("chains", "Channelizer.sharded_step"):
                fir_st, rs_st = state
                ref = local_block(parts)
                with span("parallel", "fork"):
                    mesh.fork()
                with span("parallel", "rows"):
                    z, x_ends, y_ends = rows_step(parts, fir_st, rs_st, ref)
                with span("parallel", "tails"):
                    if self.fir_method == "fused":
                        new_state = (tails(x_ends, self.h_fir, ref), rs_st)
                    else:
                        new_state = (tails(x_ends, self.h_fir, ref),
                                     tails(y_ends, self.h_rs, ref))
                if frames == "a2a":
                    z = to_channel_major(z, mesh)
                spec = mesh.map(self._frames, z)
                del z
                previous = list(issued)
                if kernels_exchange:
                    issued[:] = [rank.stream.record_event()
                                 for rank in mesh.ranks if not rank.remote]
                with span("parallel", "join"):
                    mesh.join()
                if previous:
                    # with this call's work queued, so that the card stays
                    # busy: wait for the previous call's and raise if one
                    # of its receives timed out
                    with span("parallel", "wait_previous"):
                        check_exchanges(mesh, after=previous)
                return spec, new_state

        return step

    def validate_sharded_shapes(self, mesh: DspMesh, c: int, t: int,
                                frames: str = "local"):
        nc = mesh.shape.get(CHANNEL_AXIS, 1)
        nt = mesh.shape[TIME_AXIS]
        if c % nc:
            raise ValueError(f"C={c} not divisible by n_channel={nc}")
        if t % nt:
            raise ValueError(f"T={t} not divisible by n_time={nt}")
        m = self.block_multiple(frames)
        if (t // nt) % m:
            raise ValueError(
                f"T_loc={t // nt} must be a multiple of {m} "
                f"(OLS hop × down{' × fft' if frames == 'local' else ''}"
                " alignment)")
        if frames == "a2a" and c % len(mesh):
            raise ValueError(
                f"frames='a2a' needs C={c} divisible by the device count")

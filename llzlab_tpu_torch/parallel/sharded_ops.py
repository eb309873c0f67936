"""Sharded DSP ops over the (channel, time) mesh (port of
``llzlab_tpu/parallel/sharded_ops.py``).

Each op takes ``(C, T)`` signal blocks as one ``(C / n_channel, T_loc)``
tensor per rank (``parallel.mesh.shard``; None for a rank of another
process) and returns the outputs the same way.  Channels are the channel
axis (pure data parallelism, no communication); time is the time axis
(sequence parallelism with a halo exchange or a carry composition inside
each channel row):

* FIR / resample: the state is pure input history → one left halo
  (``parallel/halo.py``), then the port's ``fir_filter`` /
  ``resample_poly`` with that history on every rank.
* IIR: the state is recursive → per section, a zero-state pass of
  ``ops.iir.apply_section`` on every rank, the ranks' end states gathered
  on the host, the fixed-order affine composition ``w_{j+1} = M·w_j +
  t_j`` with ``M = section_transition(sos[s], T_loc)`` in float32 on the
  host (where the scan's block ends already are), then a second pass from
  the carried state.
* FFT frames: local, no communication.

Streaming: every op takes and returns ``state`` for all ``C`` channels
(``(C, h)``, the IIR's ``(C, ns, 2)``), on rank 0's device (in a
multi-process mesh, on this process's first rank's device; the process
must then hold a rank of every channel row).  Rank 0 of each row consumes
its rows; the state returned is each row's last rank's tail.

Plans.  The JAX package caches one ``shard_map`` closure per (mesh,
design, shape) and counts its traces in ``trace_counts``.  The port runs
eagerly and traces nothing; it caches one plan per (mesh, design, shape)
in the mesh's cache, the 64 most recent as the JAX package's
``lru_cache`` keeps them, and each call runs from its plan: the FIR's
resolved engine and history, the resampler's designed taps, the IIR's
section realizations and transition matrices, the window on each rank's
device.  ``trace_counts[op]`` counts the plans built (nothing else), so
it stays flat over same-shape calls.  ``jitted=True`` is accepted and
runs the same code.

Contracts (``tests/test_torch_sharded_ops.py``):

* FIR / resample: sharded == unsharded streaming at ``T_loc``
  granularity, bit for bit (pure history state, the same local
  arithmetic).
* IIR: ≥ 135 dB against unsharded ``sosfilt`` (the composition reorders
  float32 rounding); with one time rank the plain cascade, bitwise
  ``sosfilt``.  The composition order is fixed, so runs are
  deterministic, and super-blocks streamed through the op equal one call
  at the same ``T_loc`` (on a mesh with as many more time ranks) bit for
  bit: the state carried between calls is the composition's own value.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.ops import fir as _fir
from llzlab_tpu_torch.ops import iir as _iir
from llzlab_tpu_torch.ops import resample as _rs
from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.ops.spectral import window_tensor
from llzlab_tpu_torch.parallel.halo import (broadcast_from_last, left_halo,
                                            row_values)
from llzlab_tpu_torch.parallel.mesh import DspMesh, note_traffic

__all__ = [
    "fir_filter_sharded",
    "resample_sharded",
    "sosfilt_sharded",
    "fft_frames_sharded",
    "trace_counts",
]

#: plans built, per op: flat over repeated same-shape calls
trace_counts: collections.Counter = collections.Counter()
#: plans kept per mesh (the JAX package's ``lru_cache(maxsize=64)``)
PLANS_KEPT = 64


def _plan(mesh: DspMesh, op: str, key: tuple, build):
    plans = mesh.cache.setdefault("sharded_ops", collections.OrderedDict())
    key = (op,) + key
    if key in plans:
        plans.move_to_end(key)
    else:
        trace_counts[op] += 1
        plans[key] = build()
        if len(plans) > PLANS_KEPT:
            plans.popitem(last=False)
    return plans[key]


def _local_shape(parts: Sequence[Optional[torch.Tensor]], mesh: DspMesh):
    """``(C_loc, T_loc)`` of the blocks, checked equal over the ranks."""
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} blocks for {len(mesh)} ranks")
    shapes = {tuple(p.shape) for p in parts if p is not None}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError(f"blocks must be equal-shaped 2-D (C_loc, T_loc), "
                         f"got {sorted(shapes)}")
    return next(iter(shapes))


def _state_out(per_rank: Sequence[Optional[torch.Tensor]], mesh: DspMesh):
    """The rows' values (each row's copy on a rank of this process) joined
    along the channels on this process's first rank's device."""
    home = mesh.home
    got = []
    for row in mesh.rows():
        mine = [r for r in row if mesh.local(r)]
        if not mine:
            raise ValueError("a streaming state needs a rank of every "
                             "channel row in this process")
        mesh.after(home, mine[0])
        got.append((mine[0], per_rank[mine[0]]))
    return mesh.run(home, lambda rank: torch.cat(
        [mesh.copy_to(r, v, rank.device) for r, v in got], dim=0),
        mesh.ranks[home])


def _history_op(parts, mesh, h: int, state, local_fn):
    """Left halo with ``state`` entering each row, ``local_fn(x, halo)``
    on every rank, and each row's last ``h`` input samples as the new
    state."""
    mesh.fork()
    firsts = row_values(state, mesh)
    halos = left_halo(parts, h, mesh, first_shard_value=firsts)
    y = mesh.map(local_fn, parts, halos)
    tails = broadcast_from_last(
        mesh.map(lambda x: x[..., x.shape[-1] - h:], parts), mesh)
    new_state = _state_out(tails, mesh)
    mesh.join()
    return y, new_state


def fir_filter_sharded(
    parts: Sequence[Optional[torch.Tensor]],
    taps,
    mesh: DspMesh,
    *,
    method: str = "ols",
    nfft: Optional[int] = None,
    state: Optional[torch.Tensor] = None,
    return_state: bool = False,
    jitted: bool = False,
):
    """Time+channel-sharded causal FIR filter of a ``(C, T)`` signal held
    as one ``(C_loc, T_loc)`` block per rank.

    ``state``: ``(C, h)`` carried stream history (``h = fir_state_len``);
    zeros when omitted.  Requires ``T_loc ≥ h``.  Bit-identical to
    unsharded streaming at ``T_loc`` granularity.  ``method`` is the port's
    ``fir_filter`` engine ("block2" runs kernel B2 on every rank of a CUDA
    mesh).  ``jitted`` is accepted and changes nothing (the port runs
    eagerly).
    """
    taps = np.asarray(taps, dtype=np.float64)
    c_loc, t_loc = _local_shape(parts, mesh)

    def build():
        engine = _fir.resolve_method(method, len(taps))
        n = _fir.default_nfft(len(taps)) if nfft is None else int(nfft)
        return engine, n, _fir.fir_state_len(len(taps), n, engine)

    engine, n, h = _plan(mesh, "fir", (taps.tobytes(), method, nfft, c_loc,
                                       t_loc), build)
    if t_loc < h:
        raise ValueError(f"T_loc={t_loc} < history {h}")
    y, new_state = _history_op(
        parts, mesh, h, state,
        lambda x, hv: _fir.fir_filter(x, taps, method=engine, nfft=n,
                                      zi=hv))
    return (y, new_state) if return_state else y


def resample_sharded(
    parts: Sequence[Optional[torch.Tensor]],
    up: int,
    down: int,
    mesh: DspMesh,
    *,
    taps=None,
    taps_per_phase: int = 64,
    state: Optional[torch.Tensor] = None,
    return_state: bool = False,
    jitted: bool = False,
):
    """Time+channel-sharded polyphase resampler of one ``(C_loc, T_loc)``
    block per rank.

    Requires ``T_loc % down == 0`` (the group phase realigns at every
    shard boundary, so every rank gives ``T_loc·up/down`` outputs).  The
    state is the ``K−1``-sample input history.  Bit-identical to unsharded
    streaming at ``T_loc`` granularity.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    given = None if taps is None else np.asarray(taps, dtype=np.float64)
    c_loc, t_loc = _local_shape(parts, mesh)

    def build():
        h = (_rs.resample_taps(up, down, taps_per_phase) if given is None
             else given)
        if len(h) % up != 0:
            h = np.pad(h, (0, up - len(h) % up))
        return h

    design = _plan(mesh, "resample", (
        None if given is None else given.tobytes(), int(taps_per_phase), up,
        down, c_loc, t_loc), build)
    h = len(design) // up - 1
    if t_loc % down:
        raise ValueError(
            f"T_loc={t_loc} must be an integer multiple of down={down}")
    if t_loc < h:
        raise ValueError(f"T_loc={t_loc} < history {h}")
    y, new_state = _history_op(
        parts, mesh, h, state,
        lambda x, hv: _rs.resample_poly(x, up, down, taps=design, zi=hv))
    return (y, new_state) if return_state else y


def _affine(m: np.ndarray, w: np.ndarray, t: np.ndarray) -> np.ndarray:
    """``M·w + t`` per row of ``w (C, 2)`` in float32, in one fixed
    order."""
    return (w[:, :1] * m[:, 0] + w[:, 1:] * m[:, 1]) + t


def _host_gather(ends, mesh: DspMesh, row: Sequence[int], shape):
    """Every rank's end state of ``row`` (``ends[r]``: a float32 host
    array ``shape`` of this process's ranks) on the host of every process
    that holds a rank of the row: the all-gather of the end states; None
    for a row without a rank here.  Only what crosses a process boundary
    travels: from its rank's device to one rank of each other process,
    and read there on that rank's stream, behind the receive."""
    procs = sorted({mesh.ranks[r].process for r in row
                    if mesh.ranks[r].process is not None})
    got = {r: ends[r] for r in row if mesh.local(r)}
    for src in row:
        value = mesh.run(src, lambda a, rank: torch.from_numpy(a).to(
            rank.device), ends[src], mesh.ranks[src])
        for p in procs:
            if p == mesh.ranks[src].process:
                continue
            dst = next(r for r in row if mesh.ranks[r].process == p)
            moved = mesh.move(src, dst, value, shape, torch.float32)
            if moved is not None:
                got[src] = mesh.run(dst, lambda v: v.cpu().numpy(), moved)
    return [got[r] for r in row] if got else None


def sosfilt_sharded(
    parts: Sequence[Optional[torch.Tensor]],
    sos,
    mesh: DspMesh,
    *,
    block_size: int = 4096,
    state: Optional[torch.Tensor] = None,
    return_state: bool = False,
    jitted: bool = False,
):
    """Time+channel-sharded biquad cascade of one ``(C_loc, T_loc)`` block
    per rank.

    Per section: a zero-state pass on every rank → the ranks' end states
    gathered on the host → the fixed-order affine composition with ``M =
    A^{T_loc}`` (``section_transition``, derived in float64) → a second
    pass from the exact carried state.  The passes take and give their
    states on the host (``ops.iir.apply_section_host``), where the scan's
    carry across blocks is computed anyway, so a state goes to a card only
    to cross a process.  ``state``: ``(C, ns, 2)`` float32 in the scan's
    realization (a ``zf`` of ``sosfilt``); zeros when omitted.
    """
    sos_np = np.ascontiguousarray(np.asarray(sos, dtype=np.float64))
    ns = sos_np.shape[0]
    c_loc, t_loc = _local_shape(parts, mesh)
    nt, rows = mesh.n_time, mesh.rows()
    c = c_loc * len(rows)
    kinds, params, trans = _plan(
        mesh, "sosfilt", (sos_np.tobytes(), int(block_size), c_loc, t_loc),
        lambda: _iir.sos_plan(sos_np) + (
            [_iir.section_transition(sos_np[s], t_loc) for s in range(ns)],))
    if state is None:
        st_host = np.zeros((c, ns, 2), np.float32)
    else:
        st_host = state.detach().to(torch.float32).cpu().numpy()
    if st_host.shape != (c, ns, 2):
        raise ValueError(f"state must be {(c, ns, 2)}, got {st_host.shape}")
    tp = _iir.padded_len(t_loc, block_size)
    ti = t_loc - 1
    mesh.fork()
    cur = mesh.map(lambda x: F.pad(x.to(torch.float32), (0, tp - t_loc)),
                   parts)

    def section(s: int, r: int, s0: np.ndarray) -> np.ndarray:
        """Section ``s`` over rank ``r``'s signal from the host state
        ``s0``, in place; its host end state."""
        cur[r], zf = _iir.apply_section_host(kinds[s], params[s], cur[r],
                                             s0, block_size, zf_index=ti,
                                             op="sosfilt_sharded")
        return zf

    zf_rows = [[] for _ in rows]
    zero = np.zeros((c_loc, 2), np.float32)
    for s in range(ns):
        if nt > 1:
            ends = mesh.map(lambda v: _iir.apply_section_host(
                kinds[s], params[s], v, zero, block_size, zf_index=ti,
                op="sosfilt_sharded")[1], cur)
            note_traffic("all-gather", 8 * c_loc, len(mesh))
        for ci, row in enumerate(rows):
            st = np.ascontiguousarray(st_host[ci * c_loc:(ci + 1) * c_loc, s])
            if nt == 1:
                # pure channel parallelism: no carries to compose, the
                # exact single-device cascade (bit-identical to sosfilt)
                zf_rows[ci].append(mesh.run(row[0], section, s, row[0], st))
                continue
            t_all = _host_gather(ends, mesh, row, (c_loc, 2))
            if t_all is None:
                zf_rows[ci].append(None)
                continue
            w_in = [st]
            for j in range(nt):
                w_in.append(_affine(trans[s], w_in[-1], t_all[j]))
            zf_rows[ci].append(w_in.pop())
            for r, w in zip(row, w_in):
                mesh.run(r, section, s, r, w)
    y = mesh.map(lambda v, x: v[:, :t_loc].to(x.dtype), cur, parts)
    new_state = None
    if return_state:
        if any(zf is None for zfs in zf_rows for zf in zfs):
            raise ValueError("a streaming state needs a rank of every "
                             "channel row in this process")
        new_state = mesh.run(mesh.home, lambda rank: torch.from_numpy(
            np.concatenate([np.stack(zfs, axis=1) for zfs in zf_rows])).to(
                rank.device), mesh.ranks[mesh.home])
    mesh.join()
    return (y, new_state) if return_state else y


def fft_frames_sharded(
    parts: Sequence[Optional[torch.Tensor]],
    n: int,
    mesh: DspMesh,
    *,
    window=None,
    method: str = "auto",
    jitted: bool = False,
):
    """Frame each rank's time block into ``n``-point frames and emit their
    spectra ``(C_loc, T_loc / n, n // 2 + 1)``, with no communication
    (requires ``T_loc % n == 0``; the a2a reshard appears only where frames
    straddle time blocks, ``parallel/reshard.py``)."""
    c_loc, t_loc = _local_shape(parts, mesh)
    if t_loc % n:
        raise ValueError(f"T_loc={t_loc} must be a multiple of n={n}")
    windows = _plan(mesh, "fft_frames", (int(n), c_loc, t_loc, window),
                    lambda: mesh.map(lambda rank: None if window is None
                                     else window_tensor(window, n,
                                                        rank.device),
                                     mesh.ranks))
    mesh.fork()

    def local(x, w):
        xf = x.reshape(c_loc, t_loc // n, n)
        if w is not None:
            xf = xf * w
        return _tf.rfft(xf, n, method=method)

    out = mesh.map(local, parts, windows)
    mesh.join()
    return out

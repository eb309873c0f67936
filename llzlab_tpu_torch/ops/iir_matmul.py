"""Biquad-cascade filtering as dense triangular matrix products (port of
``llzlab_tpu/ops/iir_matmul.py``).

Per section, in blocks of ``L`` samples (the realization and its tables
are those of :mod:`llzlab_tpu_torch.ops.iir`: ``s[n] = P·s[n−1] + u·x[n]``,
``y[n] = b0·x[n] + c·s[n−1]``, coupled or companion form):

1. the blocks' zero-state end states ``e[j] = Σ_m P^(L−1−m)·u·x[j, m]``:
   one ``(B, nblk, L) @ (L, 2)`` product;
2. the carry entering each block, ``s_end[j] = e[j] + P^L·s_end[j−1]``
   from ``zi``: a doubling over the block axis (``ceil(log2 nblk)`` steps,
   each a ``(…, 2) @ (2, 2)`` product and an add on ``(B, nblk, 2)``),
   with the powers ``(P^L)^(2^i)`` computed in float64 on the host;
3. one product gives the output: the block input with the two carry
   columns appended, ``(B, nblk, L+2) @ (L+2, L)``, where the host-built
   matrix folds ``y[n] = b0·x[n] + c·(Σ_{m<n} P^(n−1−m)·u·x[m] +
   P^n·s_in)``.

All tables are built in float64 on the host and rounded to float32 once.
The products are ``torch.matmul``: the JAX package computes them as XLA
einsums outside any Pallas kernel.  On the card a small call's launches
(about 25 a section) take the host longer to enqueue than the card to run,
so a call of at most ``GRAPH_MAX_SAMPLES`` is captured once per signature
as a CUDA graph and replayed, as the JAX package compiles one executable
per signature (``_run_cached``); a larger call runs eagerly, paced by the
card.  Each captured graph holds a memory pool the size of its call's
intermediates until :func:`clear_graphs` drops it.
The states are those of
:func:`llzlab_tpu_torch.ops.iir.sosfilt`, so they interchange.  A split
stream agrees with one shot to rounding (the carry's doubling tree
depends on the number of blocks in a call), not bit for bit: use the
scan engine where bit-matched carry is required.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llzlab_tpu_torch.ops.iir import (_powers, _realization, _states_in,
                                     section_realization)

__all__ = ["sosfilt_matmul", "clear_graphs"]

#: the precision names the JAX package takes; all run the same fp32 product
PRECISIONS = ("highest", "high", "default")
#: doublings of the block carry held in the tables: 2^40 blocks
_CARRY_STEPS = 40
#: the largest call, in samples padded to whole blocks, replayed as a CUDA
#: graph; its pool holds about 13 bytes a sample (76 MiB at 64 x 94 208 on
#: an H100, ``PERF.md`` §5).  There a graph takes 1.6 ms against about 4
#: ms eager, the host's enqueue; at 64 x 480 000 eager reads 7.1 ms
#: against 6.1 for a graph, the card's time near the host's.  Four graphs
#: of this size hold under 1 GiB
GRAPH_MAX_SAMPLES = 1 << 24
#: captured graphs kept, one per call signature; the oldest goes first
_GRAPHS_KEPT = 4
_graphs: "collections.OrderedDict" = collections.OrderedDict()
#: the stream each device warms up and captures on: one for the process,
#: since PyTorch keeps a cuBLAS workspace for every stream it has used
_capture_streams: dict = {}


@functools.lru_cache(maxsize=64)
def _tables_host(kind: str, params: Tuple[float, ...], L: int):
    """Float32 tables of one section for blocks of ``L``, from float64:
    ``Yaug (L+2, L)``, ``E (L, 2)`` (``E[m] = P^(L−1−m)·u``), and,
    transposed to act on row vectors of states, the carry steps
    ``(P^L)^(2^i)`` and ``P^(k+1)`` for a ragged tail's ``zf``."""
    P, u, c, b0 = _realization(kind, params)
    pk = _powers(P, L)
    pu = pk @ u  # (L+1, 2): P^k u
    n = np.arange(L)
    d = n[None, :] - 1 - n[:, None]  # n − 1 − m
    Y = np.where(d >= 0, pu[np.clip(d, 0, L)] @ c, 0.0)
    Y[n, n] += b0
    g = c @ pk[:L]  # (L, 2): cᵀP^n, the rows of the carry columns
    steps = np.empty((_CARRY_STEPS, 2, 2))
    steps[0] = pk[L]
    for i in range(1, _CARRY_STEPS):
        steps[i] = steps[i - 1] @ steps[i - 1]
    return dict(
        yaug=np.concatenate([Y, g.T], axis=0).astype(np.float32),
        e=pu[L - 1 - n].astype(np.float32),
        steps=steps.transpose(0, 2, 1).astype(np.float32),
        carry=pk[1:].transpose(0, 2, 1).astype(np.float32),
    )


@functools.lru_cache(maxsize=128)
def _tables(kind: str, params: Tuple[float, ...], L: int, device: str):
    return {k: torch.from_numpy(v).to(device)
            for k, v in _tables_host(kind, params, L).items()}


def _section(x, s0, tab, L: int, t: int):
    """One section over ``x (B, Tp)`` (a multiple of ``L``) entering with
    ``s0 (B, 2)``; returns ``(y (B, Tp), zf (B, 2))`` with ``zf`` the state
    after sample ``t − 1``."""
    b, tp = x.shape
    nblk = tp // L
    xb = x.reshape(b, nblk, L)
    s_end = torch.matmul(xb, tab["e"])  # (B, nblk, 2), zero-state
    s_end[:, 0].add_(torch.matmul(s0, tab["steps"][0]))
    shift, i = 1, 0
    while shift < nblk:
        s_end[:, shift:].add_(torch.matmul(s_end[:, :-shift],
                                           tab["steps"][i]))
        shift, i = shift * 2, i + 1
    s_in = torch.cat([s0[:, None, :], s_end[:, :-1]], dim=1)
    y = torch.matmul(torch.cat([xb, s_in], dim=-1), tab["yaug"])
    j, k = divmod(t - 1, L)
    if k == L - 1:
        zf = s_end[:, j]
    else:
        # w[t−1] = Σ_{m≤k} P^(k−m)·u·x[j, m] + P^(k+1)·s_in[j]
        zf = torch.matmul(xb[:, j, : k + 1], tab["e"][L - 1 - k:])
        zf.add_(torch.matmul(s_in[:, j], tab["carry"][k]))
    return y.reshape(b, tp), zf


def sosfilt_matmul(
    sos,
    x: torch.Tensor,
    *,
    zi: Optional[torch.Tensor] = None,
    block_size: int = 254,
    return_zf: bool = False,
    precision: Optional[str] = None,
):
    """Matrix-product biquad cascade (drop-in for
    :func:`llzlab_tpu_torch.ops.iir.sosfilt`).

    ``block_size=254`` (the JAX package's default) makes each section's
    contraction ``L + 2 = 256``.  Same state convention as ``sosfilt``
    (``(..., ns, 2)`` in the per-section scan realization), so states
    interchange between the engines; a split stream agrees with one shot
    to rounding, not bit for bit.

    ``precision`` ("highest" | "high" | "default" | None) is the JAX
    package's argument, checked and otherwise unused: every product here is
    fp32 with TF32 off (``runtime/platform.py``), so "high" runs the same
    product as "highest".  Use
    :func:`llzlab_tpu_torch.ops.iir_select.sosfilt_auto` to pick the engine
    from a required SNR.
    """
    if precision is not None and precision.lower() not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    sos_np = np.asarray(sos, dtype=np.float64)
    if sos_np.ndim != 2 or sos_np.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos_np.shape}")
    L = int(block_size)
    shape = tuple(x.shape)
    t = shape[-1]
    if t == 0:
        raise ValueError("sosfilt_matmul needs at least one sample")
    nb, ns = math.prod(shape[:-1]), sos_np.shape[0]
    zi_b = _states_in(zi, nb, ns, x.device)
    plan = tuple((kind, tuple(float(v) for v in prm)) for kind, prm in
                 map(section_realization, sos_np))
    tables = [_tables(kind, prm, L, str(x.device)) for kind, prm in plan]

    def run(x, zi_b):
        cur = F.pad(x.reshape(nb, t).to(torch.float32), (0, (-t) % L))
        zf = []
        for s, tab in enumerate(tables):
            cur, z = _section(cur, zi_b[:, s, :], tab, L, t)
            zf.append(z)
        return (cur[:, :t].reshape(shape).to(x.dtype),
                torch.stack(zf, dim=1).reshape(shape[:-1] + (ns, 2)))

    if x.is_cuda and nb * (t + (-t) % L) <= GRAPH_MAX_SAMPLES:
        key = (plan, L, shape, x.dtype, str(x.device))
        with torch.cuda.device(x.device):
            y, zf = _replay(key, run, x, zi_b)
    else:
        y, zf = run(x, zi_b)
    return (y, zf) if return_zf else y


def clear_graphs() -> int:
    """Drop every captured CUDA graph and the memory pool each one holds;
    returns how many there were.  ``torch.cuda.empty_cache()`` afterwards
    hands the memory back to the device."""
    n = len(_graphs)
    _graphs.clear()
    return n


def _replay(key, run, x: torch.Tensor, zi_b: torch.Tensor):
    """``run(x, zi_b)`` on the card through the CUDA graph captured for
    ``key`` (captured on first use, after one warm-up run, both on the
    device's capture stream); the inputs are copied into the graph's own,
    the outputs copied out of it.  The entry keeps ``run``, and with it
    the tables whose memory the graph reads."""
    entry = _graphs.get(key)
    if entry is None:
        sx, szi = x.clone(), zi_b.clone()
        main = torch.cuda.current_stream(x.device)
        side = _capture_streams.get(x.device)
        if side is None:
            side = _capture_streams[x.device] = torch.cuda.Stream(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            run(sx, szi)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = run(sx, szi)
        main.wait_stream(side)
        entry = _graphs[key] = (graph, sx, szi, out, run)
        while len(_graphs) > _GRAPHS_KEPT:
            _graphs.popitem(last=False)
    _graphs.move_to_end(key)
    graph, sx, szi, out, _ = entry
    sx.copy_(x)
    szi.copy_(zi_b)
    graph.replay()
    return tuple(o.clone() for o in out)

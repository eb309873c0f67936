"""Time-sharded STFT → spectral gain → iSTFT, config 4 over the mesh (port
of ``llzlab_tpu/parallel/spectral_sp.py``).

Each time shard owns the frames *starting* inside its range.  Analysis
needs ``n_fft − hop`` samples of lookahead from the right neighbour
(``parallel.halo.right_halo``); the synthesis overlap-add leaves a tail
that overlaps the right neighbour's head, sent right and added there
(``left_halo`` of the tail), together with the window-square envelope, so
that the WOLA division stays exact at shard boundaries.  Interior samples
match the unsharded chain.  The last ``n_fft − hop`` samples of the stream
are reconstructed from frames that see zero lookahead past the end (the
envelope divides out exactly what those frames add), so they differ from
a chain that stops framing at the stream's end; this is the JAX package's
behaviour too.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from llzlab_tpu_torch.ops import spectral as _sp
from llzlab_tpu_torch.ops import transform as _tf
from llzlab_tpu_torch.parallel.halo import left_halo, right_halo
from llzlab_tpu_torch.parallel.mesh import DspMesh, local_block

__all__ = ["spectral_gain_sharded"]


def spectral_gain_sharded(
    parts: Sequence[Optional[torch.Tensor]],
    gain: Union[np.ndarray, Callable],
    mesh: DspMesh,
    *,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window: str = "hann",
    method: str = "auto",
    engine: str = "auto",
) -> List[Optional[torch.Tensor]]:
    """Sharded STFT → gain → iSTFT of one ``(C_loc, T_loc)`` block per
    rank; returns the ``(C_loc, T_loc)`` output blocks.

    Requires ``T_loc`` to be a multiple of ``hop``.  ``gain``: a static
    per-bin gain ``(n_fft // 2 + 1,)`` or a callable of the spectrum.

    ``engine``: "reference" runs the framed ``torch.fft`` path (the port's
    ``frame`` / ``overlap_add``); "cwola" runs each shard's analysis →
    gain → synthesis as the one composed frame product
    (``ops.spectral.composed_wola``, static gains only); "auto" resolves
    as the port's ``SpectralGainStage`` does, to "reference" (the faster
    engine on the card).  ``method`` is kept for the JAX signature: the
    port has one FFT engine (``torch.fft``), so it chooses nothing.
    """
    hop = hop or n_fft // 4
    overlap = n_fft - hop
    t_loc = local_block(parts).shape[-1]
    if t_loc % hop:
        raise ValueError(f"T_loc={t_loc} must be a multiple of hop={hop}")
    if engine == "auto":
        engine = "reference"
    if engine not in ("reference", "cwola"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "cwola" and callable(gain):
        raise ValueError("engine='cwola' needs a static gain vector")
    gain_f64 = None if callable(gain) else np.ascontiguousarray(gain,
                                                                np.float64)
    nf = t_loc // hop
    mesh.fork()
    look = right_halo(parts, overlap, mesh)

    def synthesis(x, ahead, rank):
        """The shard's frames (with the lookahead) through the gain,
        overlap-added."""
        w = _sp.window_tensor(window, n_fft, rank.device)
        ext = torch.cat([x.to(torch.float32), ahead.to(torch.float32)],
                        dim=-1)  # (C, T_loc + overlap)
        if engine == "cwola":
            return _sp.composed_wola(
                ext, torch.ones(nf, device=rank.device), n_fft, hop,
                window, gain_f64)
        frames = _sp.frame(ext, n_fft, hop) * w
        spec = _tf.rfft(frames, n_fft)
        g = gain(spec) if callable(gain) else torch.from_numpy(
            gain_f64.astype(np.float32)).to(rank.device)
        return _sp.overlap_add(_tf.irfft(spec * g, n_fft) * w, hop)

    def envelope(rank):
        """The window-square envelope of the shard's frames."""
        w = _sp.window_tensor(window, n_fft, rank.device)
        return _sp.overlap_add((w * w).expand(nf, n_fft), hop)

    olas = mesh.map(synthesis, parts, look, mesh.ranks)
    envs = mesh.map(envelope, mesh.ranks)
    y_tail = left_halo(olas, overlap, mesh)
    e_tail = left_halo(envs, overlap, mesh)

    def finish(x, ola, env, y_in, e_in):
        y_acc = ola[..., :t_loc].clone()
        y_acc[..., :overlap] += y_in
        e_acc = env[:t_loc].clone()
        e_acc[:overlap] += e_in
        return (y_acc / torch.clamp(e_acc, min=1e-8)).to(x.dtype)

    out = mesh.map(finish, parts, olas, envs, y_tail, e_tail)
    mesh.join()
    return out

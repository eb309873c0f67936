"""Chain: composition of stages with streaming state carry (port of
``llzlab_tpu/pipeline/chain.py``).

A ``Chain`` maps ``(signal, state)`` to ``(signal, state)``; each ``Stage``
declares its streaming state, so an unbounded stream is processed as a host
loop over blocks with the state carried, and can be checkpointed and
resumed mid-stream (``utils/checkpoint.py``).  PyTorch runs eagerly, so
there is no jit region: a block's stages run one after the other on the
device of the block.  States are tuples of tensors, created on the device
the caller names.

Stages ported so far: ``FIRStage`` (every engine of ops/fir.py),
``ResampleStage``, ``FusedFirResampleStage`` and ``LambdaStage``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from llzlab_tpu_torch.kernels import fused_fir_resample as _ff
from llzlab_tpu_torch.ops import fir as _fir
from llzlab_tpu_torch.ops import fused_chain as _fc
from llzlab_tpu_torch.ops import resample as _resample

__all__ = [
    "Stage",
    "FIRStage",
    "ResampleStage",
    "FusedFirResampleStage",
    "LambdaStage",
    "Chain",
]


class Stage:
    """One processing stage: a static config; tensors flow through
    ``apply``."""

    #: output_rate = input_rate · rate_num / rate_den (for stream bookkeeping)
    rate: Tuple[int, int] = (1, 1)
    #: input block lengths must be a multiple of this for exact streaming
    block_multiple: int = 1

    def init_state(self, batch_shape: Tuple[int, ...], *, device,
                   dtype=torch.float32):
        return None

    def apply(self, x: torch.Tensor, state):
        raise NotImplementedError


class FIRStage(Stage):
    """Causal FIR filtering (ops/fir.py), with any of its engines.

    ``"auto"`` resolves once, at build (the state length depends on the
    engine): block2 up to 2048 taps, else ols (``fir.resolve_method``).
    ``block_multiple`` is the engine's frame grid, so that streamed blocks
    equal one shot: the block for block2, the hop for ols, 1 for direct
    and im2col, as in the JAX package.
    """

    def __init__(self, taps, *, method: str = "auto",
                 nfft: Optional[int] = None):
        self.taps = np.asarray(taps, dtype=np.float64)
        self.nfft = nfft
        ntaps = len(self.taps)
        self.method = _fir.resolve_method(method, ntaps)
        eff_nfft = nfft or _fir.default_nfft(ntaps)
        self._state_len = _fir.fir_state_len(ntaps, eff_nfft, self.method)
        if self.method == "ols":
            self.block_multiple = _fir.ols_hop(ntaps, eff_nfft)
        elif self.method == "block2":
            self.block_multiple = _fir.block2_block(ntaps)
        else:
            self.block_multiple = 1

    def init_state(self, batch_shape, *, device, dtype=torch.float32):
        return torch.zeros(tuple(batch_shape) + (self._state_len,),
                           dtype=dtype, device=device)

    def apply(self, x, state):
        return _fir.fir_filter(x, self.taps, method=self.method,
                               nfft=self.nfft, zi=state, return_zf=True)


class ResampleStage(Stage):
    """Rational polyphase resampling (ops/resample.py)."""

    def __init__(self, up: int, down: int, *, taps=None,
                 taps_per_phase: int = 64):
        g = math.gcd(up, down)
        self.up, self.down = up // g, down // g
        if taps is None:
            taps = _resample.resample_taps(self.up, self.down, taps_per_phase)
        taps = np.asarray(taps, dtype=np.float64)
        if len(taps) % self.up != 0:
            taps = np.pad(taps, (0, self.up - len(taps) % self.up))
        self.taps = taps
        self.k = len(taps) // self.up
        self.rate = (self.up, self.down)
        self.block_multiple = self.down

    def init_state(self, batch_shape, *, device, dtype=torch.float32):
        return torch.zeros(tuple(batch_shape) + (self.k - 1,),
                           dtype=torch.float32, device=device)

    def apply(self, x, state):
        return _resample.resample_poly(
            x, self.up, self.down, taps=self.taps, zi=state, return_zf=True
        )


class FusedFirResampleStage(Stage):
    """FIR + rational resample as one stage (ops/fused_chain.py).

    The engine is resolved once, at build (the state lengths differ per
    engine): ``"auto"`` gives ``"kernel"`` (kernel B1) when ``device`` is a
    CUDA device, ``channels`` is a multiple of 8 and the kernel accepts
    the taps, else ``"composite"``.  With the kernel engine the stage keeps
    the JAX package's ``block_multiple`` (``fused_program_in``, 20 480 at
    the headline) and ``2·block`` state, so a port chain and a reference
    chain stream on the same block grid with same-shaped state.
    """

    def __init__(self, fir_taps, up: int, down: int, *, rtaps=None,
                 taps_per_phase: int = 64, engine: str = "auto",
                 channels: int = 64, device="cuda",
                 precision: Optional[str] = None):
        g = math.gcd(up, down)
        self.up, self.down = up // g, down // g
        self.fir_taps = np.asarray(fir_taps, np.float64)
        if rtaps is None:
            rtaps = _resample.resample_taps(self.up, self.down,
                                            taps_per_phase)
        rtaps = np.asarray(rtaps, np.float64)
        if len(rtaps) % self.up:
            rtaps = np.pad(rtaps, (0, self.up - len(rtaps) % self.up))
        self.rtaps = rtaps
        self.precision = precision
        self.rate = (self.up, self.down)
        ntaps, k = len(self.fir_taps), len(rtaps) // self.up
        if engine == "auto":
            # channel/length-independent resolve: block lengths are handled
            # by block_multiple, the channel envelope by the hint
            engine = ("kernel" if torch.device(device).type == "cuda"
                      and channels >= 8 and channels % 8 == 0
                      and _ff.fused_static_ok(ntaps, self.up, self.down, k)
                      and _ff.kernel_fits(ntaps, self.down, k)
                      else "composite")
        if engine not in ("kernel", "composite"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self._state_len = _fc.fir_resample_state_len(
            ntaps, self.up, self.down, len(rtaps), engine=engine)
        if engine == "kernel":
            self.block_multiple = _ff.fused_program_in(ntaps, self.up,
                                                       self.down)
        else:
            self.block_multiple = self.down

    def init_state(self, batch_shape, *, device, dtype=torch.float32):
        return torch.zeros(tuple(batch_shape) + (self._state_len,),
                           dtype=torch.float32, device=device)

    def apply(self, x, state):
        if self.engine == "kernel":
            b = int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1
            if b < 8 or b % 8:
                raise ValueError(
                    f"engine='kernel' needs a channel batch that is a "
                    f"multiple of 8 (got {b}); the engine was resolved at "
                    f"build from the channels hint: construct the stage "
                    f"with channels={b} to get the composite engine")
        return _fc.fir_resample(
            x, self.fir_taps, self.up, self.down, rtaps=self.rtaps,
            zi=state, return_zf=True, engine=self.engine,
            precision=self.precision,
        )


class LambdaStage(Stage):
    """Stateless elementwise stage from a plain function."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        self.fn = fn

    def apply(self, x, state):
        return self.fn(x), state


class Chain:
    """Composition of stages with a combined streaming state tuple.

    One-shot: ``y = chain(x)``.  Streaming: ``state = chain.init_state(
    batch_shape, device=...)``; then ``y, state = chain.apply(x_block,
    state)`` per block, each block a multiple of ``chain.block_multiple``.
    """

    def __init__(self, stages: Sequence[Stage]):
        self.stages = tuple(stages)

    @property
    def block_multiple(self) -> int:
        """Smallest chain-input block granularity M for exact streaming.

        Stage i sees block length M·(num_acc/den_acc), where (num_acc,
        den_acc) accumulates the upstream rate changes; M is the LCM of
        the per-stage requirements that this be a multiple of
        ``stage.block_multiple``.
        """
        m = 1
        num_acc, den_acc = 1, 1
        for st in self.stages:
            need = st.block_multiple * den_acc
            need //= _gcd(num_acc, need)
            m = _lcm(m, need)
            num_acc *= st.rate[0]
            den_acc *= st.rate[1]
            g = _gcd(num_acc, den_acc)
            num_acc //= g
            den_acc //= g
        return m

    def init_state(self, batch_shape: Tuple[int, ...], *, device,
                   dtype=torch.float32):
        return tuple(st.init_state(batch_shape, device=device, dtype=dtype)
                     for st in self.stages)

    def apply(self, x: torch.Tensor, state):
        new_state = []
        for st, s in zip(self.stages, state):
            x, s = st.apply(x, s)
            new_state.append(s)
        return x, tuple(new_state)

    def __call__(self, x: torch.Tensor):
        y, _ = self.apply(x, self.init_state(x.shape[:-1], device=x.device,
                                             dtype=x.dtype))
        return y

    def stream(self, blocks, batch_shape=None):
        """Generator: yield processed blocks, carrying state (created on
        the device of the first block)."""
        state = None
        for blk in blocks:
            if state is None:
                bs = batch_shape if batch_shape is not None else blk.shape[:-1]
                state = self.init_state(bs, device=blk.device)
            y, state = self.apply(blk, state)
            yield y


def _gcd(a, b):
    return math.gcd(int(a), int(b))


def _lcm(a, b):
    return a * b // _gcd(a, b)

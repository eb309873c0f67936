"""Chain: composition of stages with streaming state carry (port of
``llzlab_tpu/pipeline/chain.py``).

A ``Chain`` maps ``(signal, state)`` to ``(signal, state)``; each ``Stage``
declares its streaming state, so an unbounded stream is processed as a host
loop over blocks with the state carried, and can be checkpointed and
resumed mid-stream (``utils/checkpoint.py``).  PyTorch runs eagerly, so
there is no jit region: a block's stages run one after the other on the
device of the block.  States are tuples of tensors, created on the device
the caller names.

Stages: ``FIRStage`` (every engine of ops/fir.py), ``SOSStage`` (the
blockwise IIR scan), ``ResampleStage``, ``FusedFirResampleStage``,
``SpectralGainStage``, ``FFTStage`` and ``LambdaStage``, all the JAX
package's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from llzlab_tpu_torch.kernels import fused_fir_resample as _ff
from llzlab_tpu_torch.ops import fir as _fir
from llzlab_tpu_torch.ops import fused_chain as _fc
from llzlab_tpu_torch.ops import iir as _iir
from llzlab_tpu_torch.ops import resample as _resample
from llzlab_tpu_torch.ops import spectral as _stft
from llzlab_tpu_torch.ops import transform as _fft
from llzlab_tpu_torch.runtime.platform import precision_scope
from llzlab_tpu_torch.runtime.profiler import count_frames, request, span

__all__ = [
    "Stage",
    "FIRStage",
    "SOSStage",
    "ResampleStage",
    "FusedFirResampleStage",
    "SpectralGainStage",
    "FFTStage",
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


class SOSStage(Stage):
    """Cascaded-biquad filtering by the blockwise scan (ops/iir.py).

    The state is the sections' ``(..., ns, 2)`` float32 scan states, the
    JAX package's layout, so a state saved by either resumes in the other;
    blocks at multiples of ``block_size`` stream bit for bit.
    """

    def __init__(self, sos, *, block_size: int = 4096):
        self.sos = np.asarray(sos, dtype=np.float64)
        self.block_size = block_size
        self.block_multiple = block_size

    def init_state(self, batch_shape, *, device, dtype=torch.float32):
        return torch.zeros(tuple(batch_shape) + (self.sos.shape[0], 2),
                           dtype=torch.float32, device=device)

    def apply(self, x, state):
        return _iir.sosfilt(
            self.sos, x, zi=state, block_size=self.block_size, return_zf=True
        )


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


#: the engines of SpectralGainStage
SPECTRAL_ENGINES = ("reference", "wdft", "cwola")


class SpectralGainStage(Stage):
    """STFT → per-bin gain → iSTFT (config 4, BASELINE.json:10).

    ``gain`` is an ``(n_fft//2+1,)`` array, or a callable mapping the
    complex spectrum ``(..., nf, bins)`` to a (broadcastable) gain.

    Streaming is exact at every sample: the stage carries the analysis
    lookback (``overlap = n_fft − hop`` input samples), the synthesis
    overlap-add tail and the window-square envelope tail, so streamed
    blocks equal one ``istft(gain·stft(x))``.  A frame is synthesised once
    all its samples have arrived, so the stage lags by ``latency =
    overlap`` samples: block ``b`` (length T) emits one-shot samples
    ``[b·T − overlap, (b+1)·T − overlap)``, the stream leads with
    ``overlap`` zeros, and :meth:`flush` gives the last ``overlap``.

    State: ``{"x_hist", "ola"}`` ``(..., overlap)`` f32, ``"env"``
    ``(overlap,)`` f32 and ``"pos"``, a 0-dim int32 tensor counting the
    input samples so far, saturated at ``overlap`` (it masks the zero-pad
    frames at the stream's start).  Its leaves in sorted key order (env,
    ola, pos, x_hist) are the JAX package's, so a state saved by either
    resumes in the other (``utils/checkpoint.py``).

    Engines (``engine=``):

    * ``"reference"``: frame → window → ``rfft`` (cuFFT) → gain → ``irfft``
      → window → overlap-add;
    * ``"wdft"``: the window folded into dense rDFT tables
      (``ops/spectral.windowed_rdft`` / ``windowed_irdft_ola``), two
      products a frame; the engine a callable gain needs among the two
      product engines;
    * ``"cwola"``: for a static gain the frame map analysis → gain →
      synthesis composed into one ``(n_fft, n_fft)`` matrix
      (``ops/spectral.composed_wola``); a callable gain raises;
    * ``"auto"``: ``"reference"``, on every device.  The JAX package takes
      cwola / wdft on a TPU, where its FFT is a matrix product; on the
      H100 the card's times decide (``PERF.md``, config 4): cuFFT's
      reference engine is the fastest of the three there.

    ``precision`` pins the precision name (``precision_scope``) for the
    stage's work (default "highest"; ``None`` inherits the environment).
    Its products and FFTs are fp32 at every name, so the name reaches
    only a hand kernel that a callable gain might run.

    Each call counts the frames it synthesises (rows × ``T // hop``) under
    its engine in ``runtime.profiler.counters()["frames"]``; under a
    profiler the carry (the tails' adds, the division by the envelope,
    the new state) is the span ``llz/ops/wola_state``.
    """

    def __init__(
        self,
        gain,
        *,
        n_fft: int = 2048,
        hop: Optional[int] = None,
        window: str = "hann",
        method: str = "auto",
        precision: Optional[str] = "highest",
        engine: str = "auto",
    ):
        self.gain = gain if callable(gain) else np.asarray(gain, np.float32)
        self.n_fft = n_fft
        self.hop = hop or n_fft // 4
        if self.n_fft % self.hop:
            raise ValueError("hop must divide n_fft")
        self.window = window
        self.method = method
        self.precision = precision
        if engine == "auto":
            engine = "reference"
        if engine not in SPECTRAL_ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of "
                             f"{('auto',) + SPECTRAL_ENGINES}")
        if engine == "cwola" and callable(self.gain):
            raise ValueError(
                "engine='cwola' composes a STATIC gain into the frame "
                "map; a callable gain needs engine='wdft'")
        if engine != "reference" and n_fft % 2:
            raise ValueError(
                f"engine={engine!r} needs an even n_fft, got {n_fft}: its "
                "dense rDFT tables have a Nyquist bin")
        self.engine = engine
        self.block_multiple = self.hop
        #: output samples lag input samples by this much (WOLA lookback)
        self.latency = self.n_fft - self.hop
        self._gain_dev = {}

    def init_state(self, batch_shape, *, device, dtype=torch.float32):
        ov = self.latency
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "x_hist": torch.zeros(tuple(batch_shape) + (ov,), **f32),
            "ola": torch.zeros(tuple(batch_shape) + (ov,), **f32),
            "env": torch.zeros((ov,), **f32),
            "pos": torch.zeros((), dtype=torch.int32, device=device),
        }

    def _gain_on(self, device) -> torch.Tensor:
        """The static gain as f32 on ``device``, copied there once."""
        key = str(device)
        if key not in self._gain_dev:
            self._gain_dev[key] = torch.from_numpy(self.gain).to(device)
        return self._gain_dev[key]

    def _apply_gain(self, spec):
        if callable(self.gain):
            return spec * self.gain(spec)
        return spec * self._gain_on(spec.device)

    def apply(self, x, state):
        ov = self.latency
        t = x.shape[-1]
        if t % self.hop:
            raise ValueError(f"block length {t} not a multiple of hop")
        dev = x.device
        w = _stft.window_tensor(self.window, self.n_fft, dev)
        ext = torch.cat([state["x_hist"], x.to(torch.float32)], dim=-1)
        nf = t // self.hop
        # Early stream blocks: ext leads with zero-pad frames (global frame
        # start < 0) that the one-shot run never sees; mask them.  Frame k
        # starts at global input position pos + k·hop − ov.
        starts = torch.arange(nf, device=dev) * self.hop
        mask = (state["pos"] + starts >= ov).to(torch.float32)
        with precision_scope(self.precision):
            if self.engine == "cwola":
                buf = _stft.composed_wola(
                    ext, mask, self.n_fft, self.hop, self.window,
                    np.asarray(self.gain, np.float64), prec=self.precision)
            elif self.engine == "wdft":
                spec = _stft.windowed_rdft(ext, self.n_fft, self.hop,
                                           self.window, prec=self.precision)
                # synthesis masking commutes with the linear inverse
                buf = _stft.windowed_irdft_ola(
                    self._apply_gain(spec) * mask[:, None], self.n_fft,
                    self.hop, self.window, prec=self.precision)
            else:
                frames = _stft.frame(ext, self.n_fft, self.hop) * w
                spec = _fft.rfft(frames, self.n_fft, method=self.method)
                synth = _fft.irfft(self._apply_gain(spec), self.n_fft,
                                   method=self.method) * w
                buf = _stft.overlap_add(synth * mask[:, None], self.hop)
        env = _stft.overlap_add((w * w) * mask[:, None], self.hop)
        with span("ops", "wola_state"):
            buf[..., :ov] += state["ola"]
            env[:ov] += state["env"]
            y = (buf[..., :t] / torch.clamp(env[:t], min=1e-8)).to(x.dtype)
            new_state = {
                "x_hist": ext[..., t:].clone(),
                "ola": buf[..., t:].clone(),
                "env": env[t:].clone(),
                "pos": torch.clamp(state["pos"] + t, max=ov).to(torch.int32),
            }
        count_frames(self.engine, math.prod(x.shape[:-1]) * nf)
        return y, new_state

    def flush(self, state, dtype=torch.float32):
        """The final ``overlap`` output samples once the stream ends."""
        return (state["ola"] / torch.clamp(state["env"], min=1e-8)).to(dtype)


class FFTStage(Stage):
    """Frame the stream into n-point blocks and emit their spectra
    (the channelizer's back end: ``(..., T)`` → complex ``(..., T//n,
    n//2+1)``)."""

    def __init__(self, n: int, *, window=None, method: str = "auto"):
        self.n = n
        self.window = window
        self.method = method
        self.block_multiple = n

    def apply(self, x, state):
        t = x.shape[-1]
        nfr = t // self.n
        xf = x[..., : nfr * self.n].reshape(tuple(x.shape[:-1])
                                            + (nfr, self.n))
        if self.window is not None:
            xf = xf * _stft.window_tensor(self.window, self.n, x.device)
        return _fft.rfft(xf, self.n, method=self.method), state


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
        with request("pipeline", "Chain.apply"):
            new_state = []
            for st, s in zip(self.stages, state):
                with span("pipeline", type(st).__name__):
                    x, s = st.apply(x, s)
                new_state.append(s)
            return x, tuple(new_state)

    def __call__(self, x: torch.Tensor):
        y, _ = self.apply(x, self.init_state(x.shape[:-1], device=x.device,
                                             dtype=x.dtype))
        return y

    def stream(self, blocks, batch_shape=None, dtype=torch.float32):
        """Generator: yield processed blocks, carrying state (created on
        the device of the first block, in ``dtype`` where a stage's state
        follows it)."""
        state = None
        for blk in blocks:
            if state is None:
                bs = batch_shape if batch_shape is not None else blk.shape[:-1]
                state = self.init_state(bs, device=blk.device, dtype=dtype)
            y, state = self.apply(blk, state)
            yield y


def _gcd(a, b):
    return math.gcd(int(a), int(b))


def _lcm(a, b):
    return a * b // _gcd(a, b)

"""Typed configs and the five BASELINE workload presets (port of
``llzlab_tpu/utils/config.py``).

Stdlib dataclasses, the same code as the JAX package, so the port (and
``chip_smoke.py``) load ``configs/*.json`` without it: serialisable configs
shared by the CLI, tests and smoke runs, every BASELINE.json config (lines
6–12) in one place.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = [
    "FIRConfig",
    "IIRConfig",
    "ResampleConfig",
    "STFTConfig",
    "ChainConfig",
    "MeshConfig",
    "PRESETS",
    "to_json",
    "from_json",
]


@dataclass(frozen=True)
class FIRConfig:
    numtaps: int = 1024
    cutoff: Tuple[float, ...] = (0.25,)
    window: str = "hamming"
    kind: str = "lowpass"  # lowpass/highpass/bandpass/bandstop
    method: str = "ols"  # ols/direct/auto
    nfft: Optional[int] = None


@dataclass(frozen=True)
class IIRConfig:
    kind: str = "peaking_eq"  # peaking_eq | butter | cheby1
    freqs: Tuple[float, ...] = (100, 200, 400, 800, 1600, 3200, 6400, 12800)
    gains_db: Tuple[float, ...] = (3, -4, 5, -2, 6, -3, 2, -5)
    q: float = 1.0
    order: int = 8
    cutoff: Tuple[float, ...] = (0.3,)
    ripple_db: float = 1.0
    sample_rate: float = 48000.0
    block_size: int = 4096


@dataclass(frozen=True)
class ResampleConfig:
    up: int = 147
    down: int = 160
    taps_per_phase: int = 64
    kaiser_beta: float = 8.0


@dataclass(frozen=True)
class STFTConfig:
    n_fft: int = 2048
    hop: int = 512
    window: str = "hann"


@dataclass(frozen=True)
class MeshConfig:
    n_channel: Optional[int] = None
    n_time: Optional[int] = None


@dataclass(frozen=True)
class ChainConfig:
    """One named workload: stages + signal geometry + mesh."""

    name: str
    channels: int
    sample_rate: float = 48000.0
    seconds: float = 10.0
    fir: Optional[FIRConfig] = None
    iir: Optional[IIRConfig] = None
    resample: Optional[ResampleConfig] = None
    stft: Optional[STFTConfig] = None
    fft_n: Optional[int] = None  # trailing frame-FFT stage
    mesh: MeshConfig = field(default_factory=MeshConfig)


# The five BASELINE.json workloads (lines 6–12), one preset each.
PRESETS = {
    # 1: Single-channel 1024-tap FIR lowpass, 10 s of 48 kHz float32 audio
    "fir_lowpass_1ch": ChainConfig(
        name="fir_lowpass_1ch", channels=1, fir=FIRConfig()
    ),
    # 2: Polyphase 48k→44.1k (147/160), 64 taps/phase, 8 channels
    "resample_8ch": ChainConfig(
        name="resample_8ch", channels=8, resample=ResampleConfig()
    ),
    # 3: 8-section biquad EQ cascade as parallel scan, 64 channels
    "iir_eq_64ch": ChainConfig(
        name="iir_eq_64ch", channels=64, iir=IIRConfig()
    ),
    # 4: STFT → spectral gain → iSTFT, 2048-pt, 75 % overlap, 256 channels
    "stft_gain_256ch": ChainConfig(
        name="stft_gain_256ch", channels=256, stft=STFTConfig()
    ),
    # 5: 1024-channel wideband channelizer (FIR+resample+FFT, sharded)
    "channelizer_1024ch": ChainConfig(
        name="channelizer_1024ch",
        channels=1024,
        fir=FIRConfig(cutoff=(0.4,)),
        resample=ResampleConfig(),
        fft_n=2048,
        mesh=MeshConfig(),
    ),
}


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def _build(cls, d):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d or d[f.name] is None:
            continue
        v = d[f.name]
        sub = {
            "fir": FIRConfig, "iir": IIRConfig, "resample": ResampleConfig,
            "stft": STFTConfig, "mesh": MeshConfig,
        }.get(f.name)
        if sub is not None and isinstance(v, dict):
            v = _build(sub, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def from_json(s: str) -> ChainConfig:
    return _build(ChainConfig, json.loads(s))

"""llzlab_tpu_torch: the PyTorch / CUDA port of llzlab_tpu for NVIDIA Hopper.

The JAX package ``llzlab_tpu`` beside it is the reference; each module here
has its counterpart at the same path there.  Plain tensor code is PyTorch,
and each Pallas TPU kernel becomes a CUDA C++ kernel written for ``sm_90a``
(sources in ``csrc/``, built with nvcc at first use).  This package imports
neither ``jax`` nor ``llzlab_tpu``.

Layering:
    runtime/  — device and precision policy, torch.distributed bootstrap,
              heartbeat
    kernels/  — CUDA kernels, their builds, wrappers and plain versions
    ops/      — user-facing numerical ops
    parallel/ — the (channel, time) rank mesh, the halo exchange, the
              all-to-all reshard and the sharded ops
    pipeline/ — chain composition + streaming
    chains/   — the channelizer, on one device and sharded over time
    utils/    — checkpoint/resume, configs, metrics, stage timers
    io/, cli/ — WAV I/O and the ``fir``, ``iir``, ``resample``, ``stft``
              and ``channelizer`` tools
    calib/    — the IIR engine selection's per-card measurements

Ported: everything the JAX package does, but what ROADMAP.md "Not to
port" leaves out: FIR design (window, frequency sampling, Kaiser, least
squares, minimum phase, Remez) and filtering (block2 on any channel
count, overlap-save, direct, im2col), polyphase, FFT and decimating
resampling, the fused FIR→resample step, the FFT entry points, STFT /
iSTFT and the spectral-gain stage (config 4), IIR design and the
blockwise-scan and matrix-product biquad engines with their calibrated
selection (config 3), the channelizer on one device and sharded over
(channel, time) meshes, and the ``fir``, ``iir``, ``resample``, ``stft``
and ``channelizer`` tools; FFT convolution and correlation, spectral
analysis, smoothing, DCT / DST, MDCT, the chirp-Z and zoom FFT, test
signals, the scipy-compatible front doors (``ops/compat.py``), the stage
timers, roofline report and collective traffic (``utils/profiling.py``);
the sharded FIR, resample, IIR, FFT and spectral-gain ops, tap and stage
parallelism, the heartbeat and the multi-process bootstrap.
"""

__version__ = "0.1.0"

from llzlab_tpu_torch.ops import (  # noqa: F401
    remez,
    firwin,
    fir_filter,
    resample_poly,
    resample_taps,
    fir_resample,
    firls,
    minimum_phase,
    get_window,
    stft,
    istft,
    butter_sos,
    cheby1_sos,
    cheby2_sos,
    ellip_sos,
    bessel_sos,
    iirfilter_sos,
    peaking_eq_sos,
    rbj_biquad,
    sosfilt,
    sosfilt_matmul,
    sosfilt_auto,
    filtfilt,
    sosfiltfilt,
    lfilter,
    lfilter_zi,
    sosfilt_zi,
    sosfilt_zi_scan,
)
# imported from the submodule, not llzlab_tpu_torch.ops, so the scipy-named
# function never shadows the ops.resample module
from llzlab_tpu_torch.ops.resample import resample, decimate  # noqa: F401
from llzlab_tpu_torch.ops.fir import (  # noqa: F401
    firwin2, kaiserord, kaiser_beta, kaiser_atten,
)
from llzlab_tpu_torch.ops.iir import (  # noqa: F401
    buttord, cheb1ord, cheb2ord, ellipord, tf2sos,
)
from llzlab_tpu_torch.ops.analysis import (  # noqa: F401
    freqz, sosfreqz, group_delay, spectrogram, hilbert, periodogram,
    welch, csd, coherence,
)
from llzlab_tpu_torch.ops.convolve import fftconvolve, correlate  # noqa: F401
from llzlab_tpu_torch.ops.smooth import (  # noqa: F401
    detrend, savgol_coeffs, savgol_filter, medfilt, wiener,
)
from llzlab_tpu_torch.ops.dct import dct, idct, dst, idst  # noqa: F401
from llzlab_tpu_torch.ops.chirpz import czt, zoom_fft  # noqa: F401
from llzlab_tpu_torch.ops.signals import (  # noqa: F401
    chirp, square, sawtooth, gausspulse,
)
# scipy.signal-compatible front doors (ops/compat.py): designers with
# ba/zpk/sos outputs, representation conversions, and utilities
from llzlab_tpu_torch.ops.compat import (  # noqa: F401
    butter, cheby1, cheby2, ellip, bessel, iirfilter, iirdesign,
    bilinear_zpk, zpk2tf, tf2zpk, zpk2sos, sos2tf, sos2zpk, normalize,
    lfiltic, deconvolve, freqs, convolve, oaconvolve, upfirdn,
    analytic_envelope, unit_impulse, lombscargle, find_peaks,
)
from llzlab_tpu_torch.ops.transform import (  # noqa: F401
    fft,
    ifft,
    rfft,
    irfft,
    rfft_pair,
    pair_to_complex,
)
from llzlab_tpu_torch.parallel import (  # noqa: F401
    CHANNEL_AXIS,
    TIME_AXIS,
    DspMesh,
    make_dsp_mesh,
    shard_time,
    gather_time,
)
from llzlab_tpu_torch.chains import Channelizer  # noqa: F401
from llzlab_tpu_torch.pipeline import (  # noqa: F401
    Chain,
    FIRStage,
    SOSStage,
    ResampleStage,
    FusedFirResampleStage,
    SpectralGainStage,
    FFTStage,
    LambdaStage,
)

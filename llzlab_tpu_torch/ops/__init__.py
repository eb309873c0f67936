"""User-facing numerical ops of the port."""

from llzlab_tpu_torch.ops.transform import (  # noqa: F401
    fft,
    ifft,
    rfft,
    irfft,
    rfft_pair,
    pair_to_complex,
)
from llzlab_tpu_torch.ops.spectral import (  # noqa: F401
    stft,
    istft,
    frame,
    overlap_add,
)
from llzlab_tpu_torch.ops.fir import (  # noqa: F401
    firwin,
    firwin2,
    firls,
    minimum_phase,
    kaiserord,
    kaiser_beta,
    kaiser_atten,
    fir_filter,
    fir_halo,
    default_nfft,
    ols_hop,
    fir_state_len,
)
from llzlab_tpu_torch.ops.iir import (  # noqa: F401
    butter_sos,
    cheby1_sos,
    cheby2_sos,
    ellip_sos,
    bessel_sos,
    iirfilter_sos,
    buttord,
    cheb1ord,
    cheb2ord,
    ellipord,
    peaking_eq_sos,
    rbj_biquad,
    sosfilt,
    sosfiltfilt,
    filtfilt,
    lfilter,
    lfilter_zi,
    sosfilt_zi,
    sosfilt_zi_scan,
    tf2sos,
)
from llzlab_tpu_torch.ops.iir_matmul import sosfilt_matmul  # noqa: F401
from llzlab_tpu_torch.ops.iir_select import sosfilt_auto  # noqa: F401
from llzlab_tpu_torch.ops.fused_chain import (  # noqa: F401
    fir_resample,
    fir_resample_state_len,
)
from llzlab_tpu_torch.ops.remez import remez  # noqa: F401
from llzlab_tpu_torch.ops.resample import (  # noqa: F401
    resample_poly,
    resample_taps,
    resample_output_len,
)
from llzlab_tpu_torch.ops.window import get_window  # noqa: F401
# The scipy-named `resample` FUNCTION is exported only from the top-level
# package: binding it here would shadow the `ops.resample` submodule name.
from llzlab_tpu_torch.ops.resample import decimate  # noqa: F401
from llzlab_tpu_torch.ops.resample import resample as resample_fft  # noqa: F401
from llzlab_tpu_torch.ops.signals import (  # noqa: F401
    tone,
    multitone,
    chirp,
    square,
    sawtooth,
    gausspulse,
    white_noise,
    pink_noise,
    noisy_tones,
)
# As in the JAX package, the functions `mdct` and `dct` bind over their
# submodules' names here; the modules stay in sys.modules.
from llzlab_tpu_torch.ops.mdct import mdct, imdct  # noqa: F401
from llzlab_tpu_torch.ops.dct import dct, idct, dst, idst  # noqa: F401
from llzlab_tpu_torch.ops.convolve import fftconvolve, correlate  # noqa: F401
from llzlab_tpu_torch.ops.analysis import (  # noqa: F401
    freqz,
    sosfreqz,
    group_delay,
    spectrogram,
    hilbert,
    periodogram,
    welch,
    csd,
    coherence,
)
from llzlab_tpu_torch.ops.smooth import (  # noqa: F401
    detrend,
    savgol_coeffs,
    savgol_filter,
    medfilt,
    wiener,
)
from llzlab_tpu_torch.ops.chirpz import (  # noqa: F401
    czt,
    zoom_fft,
    resample_fourier,
)


def clear_tables() -> int:
    """Drop the tables that ``dct``/``dst`` and their inverses,
    ``mdct``/``imdct`` and ``czt``/``zoom_fft`` cache per device, and
    return how many there were.  Each stays in its device's memory until
    then (a DCT of length n holds an n × n float32 matrix), as the IIR
    graphs stay until ``iir_matmul.clear_graphs``."""
    import sys

    caches = [getattr(sys.modules[f"llzlab_tpu_torch.ops.{m}"], f)
              for m, f in (("dct", "_matrix_t"), ("mdct", "_tables"),
                           ("chirpz", "_czt_tables_on"))]
    held = sum(c.cache_info().currsize for c in caches)
    for c in caches:
        c.cache_clear()
    return held

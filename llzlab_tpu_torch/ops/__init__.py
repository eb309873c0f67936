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

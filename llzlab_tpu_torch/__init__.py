"""llzlab_tpu_torch: the PyTorch / CUDA port of llzlab_tpu for NVIDIA Hopper.

The JAX package ``llzlab_tpu`` beside it is the reference; each module here
has its counterpart at the same path there.  Plain tensor code is PyTorch,
and each Pallas TPU kernel becomes a CUDA C++ kernel written for ``sm_90a``
(sources in ``csrc/``, built with nvcc at first use).  This package imports
neither ``jax`` nor ``llzlab_tpu``.

Layering:
    runtime/  — device and precision policy
    kernels/  — CUDA kernels, their builds, wrappers and plain versions
    ops/      — user-facing numerical ops
    pipeline/ — chain composition + streaming
    utils/    — checkpoint/resume

This slice holds the headline chain: FIR design, the block2 FIR, polyphase
resampling and the fused FIR→resample step.
"""

__version__ = "0.1.0"

from llzlab_tpu_torch.ops import (  # noqa: F401
    firwin,
    fir_filter,
    resample_poly,
    resample_taps,
    fir_resample,
)
from llzlab_tpu_torch.pipeline import (  # noqa: F401
    Chain,
    FIRStage,
    ResampleStage,
    FusedFirResampleStage,
    LambdaStage,
)

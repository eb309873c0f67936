"""User-facing numerical ops of the port."""

from llzlab_tpu_torch.ops.fir import firwin, fir_filter  # noqa: F401
from llzlab_tpu_torch.ops.resample import (  # noqa: F401
    resample_poly,
    resample_taps,
)
from llzlab_tpu_torch.ops.fused_chain import fir_resample  # noqa: F401

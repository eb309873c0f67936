"""Chain composition and streaming execution."""

from llzlab_tpu_torch.pipeline.chain import (  # noqa: F401
    Chain,
    Stage,
    FIRStage,
    SOSStage,
    ResampleStage,
    FusedFirResampleStage,
    SpectralGainStage,
    FFTStage,
    LambdaStage,
)

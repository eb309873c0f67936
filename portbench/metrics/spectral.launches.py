"""Device operations a step of the spectral-gain chain (kernels, copies
and sets, every stream), counted in the traced slice: cuFFT's r2c and c2r
and the elementwise passes around them (frames, windows, gain,
overlap-add, envelope, carry) that a fused engine would cut.  A count
that repeats exactly."""

LAYER = "ops (ops/spectral.py, SpectralGainStage)"
UNIT = "launches"
MOVES = "throughput_msps"


def read(ctx):
    n = sum(len(ctx.trace.ops_in_window(c)) for c in ctx.cards)
    return n / ctx.steps if n else None

"""The share of the spectral-gain stage's frames that its ``reference``
engine (cuFFT's r2c and c2r) synthesised: the program's running totals of
frames by engine (``llzlab_tpu_torch.runtime.profiler.counters()``,
``frames``), warm-up included.  1.0 while ``engine="auto"`` takes the
reference engine; nothing where the program keeps no such counter.  A
count that repeats exactly."""

LAYER = "ops (ops/spectral.py, SpectralGainStage)"
UNIT = "share"
MOVES = "throughput_msps"
#: the engine whose share is read
ENGINE = "reference"


def read(ctx):
    from llzlab_tpu_torch.runtime import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:  # a program that keeps no counters
        return None
    frames = counters().get("frames", {})
    total = sum(frames.values())
    if not total:  # a program without the counter, or no frame run
        return None
    ctx.note(f"spectral.reference_share: frames by engine {frames}")
    return frames.get(ENGINE, 0) / total

"""The spectral-gain chain's share of its roofline: the least time of a
step's chain on the card (``roofline_stft.py``: the configuration's two
real FFTs a frame and its window, gain and overlap-add products at the
fp32 rate, or 8 B a sample at the published bandwidth, the larger) over
the card's busy time a step (the union of its kernel and copy intervals
in the traced slice, over the slice's steps).  It counts the
configuration's work, so any engine reads against the same yardstick."""

from portbench import roofline, roofline_stft

LAYER = "ops (ops/spectral.py, SpectralGainStage)"
UNIT = "%"
MOVES = "throughput_msps"


def read(ctx):
    pk = roofline.peaks(ctx.device_name)
    if pk is None or not ctx.cfg.get("stft"):
        return None
    busy = max(ctx.trace.busy_s(c) for c in ctx.cards) / ctx.steps
    if busy <= 0.0:
        return None
    least, bound = roofline_stft.chain_least_s(ctx.cfg, pk,
                                               ctx.samples_per_step)
    ctx.note(f"spectral.roofline_pct: least {least * 1e3:.6f} ms a step "
             f"({bound}-bound), card busy {busy * 1e3:.6f} ms")
    return 100.0 * least / busy

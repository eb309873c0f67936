"""The step's share of its roofline on the busiest card: the least time
of the chain's work on a card's share of a step (``roofline.py``: the
cheapest correct implementation at the published peaks) over that card's
device busy time a step (the union of its kernel and copy intervals in
the traced slice, over the slice's steps)."""

from portbench import roofline

LAYER = "kernels (kernels/, csrc/)"
UNIT = "%"
MOVES = "throughput_msps"


def read(ctx):
    pk = roofline.peaks(ctx.device_name)
    if pk is None or not ctx.cfg.get("resample"):
        return None
    least, bound = roofline.channelizer_least_s(
        ctx.cfg, ctx.wl["precision"], pk,
        ctx.samples_per_step / len(ctx.cards))
    busy = max(ctx.trace.busy_s(c) for c in ctx.cards) / ctx.steps
    ctx.note(f"step.roofline_pct: least {least * 1e3:.6f} ms a card a step "
             f"({bound}-bound), busiest card {busy * 1e3:.6f} ms")
    return 100.0 * least / busy

"""The IIR cascade's share of its roofline: the least time of a block's
cascade on the card (``roofline_sos.py``: 8 B a sample at the published
bandwidth, or 9 FLOP a section a sample at the fp32 rate, the larger)
over the card's busy time a block (the union of its kernel and copy
intervals in the traced slice, over the slice's blocks).  No kernel of
its own runs the scan, so this is the scan engine's share; a scan kernel
would read against the same yardstick."""

from portbench import roofline, roofline_sos

LAYER = "ops (ops/iir.py scan)"
UNIT = "%"
MOVES = "block_p95_ms"


def read(ctx):
    pk = roofline.peaks(ctx.device_name)
    if pk is None or not ctx.cfg.get("iir"):
        return None
    least, bound = roofline_sos.cascade_least_s(
        len(ctx.cfg["iir"]["freqs"]), pk, ctx.samples_per_step)
    busy = max(ctx.trace.busy_s(c) for c in ctx.cards) / ctx.steps
    ctx.note(f"sos.roofline_pct: least {least * 1e3:.6f} ms a block "
             f"({bound}-bound), card busy {busy * 1e3:.6f} ms")
    return 100.0 * least / busy

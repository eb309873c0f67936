"""The share of the traced slice's wall time in which a card runs
nothing (one minus the union of its busy intervals over the slice), the
mean over the cards, each card's on an earlier line."""

from portbench.metrics_util import idle_pct

LAYER = "device"
UNIT = "%"
MOVES = "throughput_msps"


def read(ctx):
    return idle_pct(ctx, "device.idle_pct.batch")

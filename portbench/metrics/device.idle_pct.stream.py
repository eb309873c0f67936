"""As ``device.idle_pct.batch``, on the one card of a stream."""

from portbench.metrics_util import idle_pct

LAYER = "device"
UNIT = "%"
MOVES = "block_p95_ms"


def read(ctx):
    return idle_pct(ctx, "device.idle_pct.stream")

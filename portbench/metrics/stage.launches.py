"""Device operations a block (kernels, copies and sets, every stream),
counted in the traced slice: a count that repeats exactly."""

LAYER = "ops (ops/fir.py engines)"
UNIT = "launches"
MOVES = "block_p95_ms"


def read(ctx):
    n = sum(len(ctx.trace.ops_in_window(c)) for c in ctx.cards)
    return n / ctx.steps if n else None

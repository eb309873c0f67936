"""Host time of one call into ``Chain.apply``, the mean over the blocks of
the traced run outside its profiled slice (the harness's own span, on
the host's clock)."""

LAYER = "pipeline (pipeline/chain.py)"
UNIT = "ms"
MOVES = "block_p95_ms"


def read(ctx):
    calls = ctx.spans.calls.get("Chain.apply", 0)
    if not calls:
        return None
    return ctx.spans.host_s["Chain.apply"] / calls * 1e3

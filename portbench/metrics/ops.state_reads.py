"""Reads of scan states from the card a block: the program's running
total of them (``llzlab_tpu_torch.runtime.profiler.counters()``,
``state_reads``, by calling op, summed) over the calls of
``Chain.apply``, warm-up included: two a section a call of ``sosfilt``.
A count that repeats exactly."""

LAYER = "ops (ops/iir.py scan)"
UNIT = "reads"
MOVES = "block_p95_ms"
#: the request entry whose calls the reads are spread over
ENTRY = "Chain.apply"


def read(ctx):
    from llzlab_tpu_torch.runtime import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:  # a program that keeps no counters
        return None
    got = counters()
    reads = sum(got.get("state_reads", {}).values())
    calls = got["calls"].get(ENTRY, 0)
    if not calls or not reads:
        return None
    ctx.note(f"ops.state_reads: {got['state_reads']} over {calls} calls "
             f"of {ENTRY}")
    return reads / calls

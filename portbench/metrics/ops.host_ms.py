"""Host time a block in the ops layer: the self time of the program's
``llz/ops/*`` spans (``fir_filter``, ``resample_poly``, ``rfft``,
``rfft_pair``) in the traced slice, over its blocks: the engine's
checks, the state's slices, reshapes and history ``cat``, less the spans
nested inside (the kernels' launches).  Taken under the profiler, so
higher than in an untraced run (``program_spans.py``)."""

from portbench.program_spans import ms_a_step

LAYER = "ops (ops/fir.py engines)"
UNIT = "ms"
MOVES = "block_p95_ms"


def read(ctx):
    return ms_a_step(ctx, "llz/ops/")

"""Host time a block of the dense resampler's preparation: the spans
``llz/ops/resample_weights`` (the taps' normalisation, their ``tobytes``
key and the cached dense W) and ``llz/ops/resample_slab`` (the history
join, the zero pad and the ``unfold``) nested in ``llz/ops/resample_poly``,
in the traced slice, over its blocks.  What a resampler that keeps its
weights and reads its input once would not spend; the rest of
``resample_poly`` (the product's dispatch, the output's slice) is
``ops.host_ms``'s.  Nothing where the program has neither span.  Taken
under the profiler, so higher than in an untraced run
(``program_spans.py``)."""

from portbench.program_spans import ms_a_step

LAYER = "ops (ops/resample.py)"
UNIT = "ms"
MOVES = "block_p95_ms"
#: the spans nested in ``llz/ops/resample_poly``
NESTED = ("llz/ops/resample_weights", "llz/ops/resample_slab")


def read(ctx):
    return ms_a_step(ctx, NESTED)

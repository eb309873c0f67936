"""Host time a step of enqueuing the spectral-gain chain: the self time of
the program's span ``llz/pipeline/SpectralGainStage`` and of the
``llz/ops/*`` spans inside it (``rfft``, ``irfft``, ``overlap_add``,
``wola_state``) in the traced slice, over its steps.  Taken under the
profiler, so higher than in an untraced run (``program_spans.py``)."""

from portbench.program_spans import ms_a_step

LAYER = "ops (ops/spectral.py, SpectralGainStage)"
UNIT = "ms"
MOVES = "throughput_msps"
#: the stage's span and the ops spans it opens
SPANS = ("llz/pipeline/SpectralGainStage", "llz/ops/rfft", "llz/ops/irfft",
         "llz/ops/overlap_add", "llz/ops/wola_state")


def read(ctx):
    return ms_a_step(ctx, SPANS)

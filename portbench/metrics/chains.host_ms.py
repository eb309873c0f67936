"""Host time a step of queuing the channelizer's work: the duration of
the program's request span of a step (``llz/chains/Channelizer.step`` or
``llz/chains/Channelizer.sharded_step``) less the sharded step's wait for
the step before (``llz/parallel/wait_previous``), in the traced slice,
over its steps.  Taken under the profiler, so higher than in an untraced
run (``program_spans.py``)."""

from portbench.program_spans import ms_a_step

LAYER = "chains (chains/channelizer.py)"
UNIT = "ms"
MOVES = "throughput_msps"
#: the request spans of a step
STEPS = ("llz/chains/Channelizer.step", "llz/chains/Channelizer.sharded_step")


def read(ctx):
    return ms_a_step(ctx, STEPS, inner="llz/parallel/wait_previous")

"""Host time a block spent enqueuing the kernels: the self time of the
program's ``llz/kernels/*`` spans (the host side of each launch of B1 to
B4: the checks, the tap tables' lookup, the launch through ctypes) in the
traced slice, over its blocks.  Taken under the profiler, so higher than
in an untraced run (``program_spans.py``)."""

from portbench.program_spans import ms_a_step

LAYER = "kernels (kernels/, csrc/)"
UNIT = "ms"
MOVES = "block_p95_ms"


def read(ctx):
    return ms_a_step(ctx, "llz/kernels/")

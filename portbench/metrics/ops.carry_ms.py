"""Host time a block of the IIR scan's carry across blocks: the self time
of the program's ``llz/ops/sos_carry`` spans (``ops/iir.py``,
``apply_section_host`` step 2: the two reads of scan states from the
card, which wait for the section's scan, the carry on the host and the
copy of the block states back to the card) in the traced slice, over its
blocks.  Taken under the profiler, so higher than in an untraced run
(``program_spans.py``)."""

from portbench.program_spans import ms_a_step

LAYER = "ops (ops/iir.py scan)"
UNIT = "ms"
MOVES = "block_p95_ms"


def read(ctx):
    return ms_a_step(ctx, "llz/ops/sos_carry")

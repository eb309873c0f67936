"""What the readers of the program's own spans share.  The program marks
its layer boundaries as profiler ranges named ``llz/<layer>/<name>``
(``llzlab_tpu_torch.runtime.profiler.span``) while a profiler runs; in
the traced slice they are host events of the harness's thread
(``Trace.host``), nested as the calls were.  A program without them
gives the readers nothing to read.

The traced slice runs under the profiler, which adds its own cost to
every host event, so these host times read higher than in an untraced
run, by as much for a parent as for a change."""

#: the prefix of every span of the program
PREFIX = "llz/"


def self_s(host, names, inner=PREFIX) -> tuple:
    """``(seconds, spans)``: the summed self time of the host events whose
    name starts with ``names`` (a prefix or a tuple of them), and how many
    there were.  A span's self time is its duration minus the union of
    the spans nested inside it whose name starts with ``inner`` (by
    default every span of the program); other events inside it (the aten
    operators, the CUDA runtime's calls) are its own time."""
    spans = sorted(((s, e, n) for s, e, n in host if n.startswith(PREFIX)),
                   key=lambda v: (v[0], -v[1]))
    total, count = 0.0, 0
    for i, (s, e, n) in enumerate(spans):
        if not n.startswith(names):
            continue
        count += 1
        covered, reach = 0.0, s
        for j in range(i + 1, len(spans)):
            cs, ce, cn = spans[j]
            if cs >= e:
                break
            if ce > e or ce <= reach or not cn.startswith(inner):
                continue  # not nested, inside one counted, or not counted
            covered += ce - max(cs, reach)
            reach = ce
        total += (e - s) - covered
    return total, count


def ms_a_step(ctx, names, inner=PREFIX):
    """:func:`self_s` of the traced slice a step, in ms; None where the
    slice holds no span ``names``."""
    total, count = self_s(ctx.trace.host, names, inner)
    return total / ctx.steps * 1e3 if count else None

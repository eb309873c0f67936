"""The IIR stream's blocks that went through the scan kernel: the
program's launches of it (``llzlab_tpu_torch.runtime.profiler.counters()``,
``launches``, ``sos_scan``) over the calls of ``Chain.apply``, warm-up
included.  1.0 when every block's ``sosfilt`` is one launch of the kernel;
nothing where the program has no such kernel.  A count that repeats
exactly."""

LAYER = "kernels (kernels/, csrc/)"
UNIT = "launches"
MOVES = "block_p95_ms"
#: the request entry whose calls the launches are spread over
ENTRY = "Chain.apply"


def read(ctx):
    from llzlab_tpu_torch.runtime import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:  # a program that keeps no counters
        return None
    got = counters()
    kernel = got.get("launches", {}).get("sos_scan")
    calls = got.get("calls", {}).get(ENTRY, 0)
    if kernel is None or not calls:  # a program without the kernel
        return None
    ctx.note(f"kernels.sos_scan_share: {kernel['launches']} launches of "
             f"sos_scan over {calls} calls of {ENTRY}")
    return kernel["launches"] / calls

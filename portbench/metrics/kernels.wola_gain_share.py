"""The spectral-gain steps whose frame map went through the wola_gain
kernel: the program's launches of it (``llzlab_tpu_torch.runtime.profiler
.counters()``, ``launches``, ``wola_gain``) over the calls of
``Chain.apply``, warm-up included.  1.0 when every step's frame map is one
launch of the kernel; nothing where the program has no such kernel.  A
count that repeats exactly."""

LAYER = "kernels (kernels/, csrc/)"
UNIT = "launches"
MOVES = "throughput_msps"
#: the request entry whose calls the launches are spread over
ENTRY = "Chain.apply"


def read(ctx):
    from llzlab_tpu_torch.runtime import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:  # a program that keeps no counters
        return None
    got = counters()
    kernel = got.get("launches", {}).get("wola_gain")
    calls = got.get("calls", {}).get(ENTRY, 0)
    if kernel is None or not calls:  # a program without the kernel
        return None
    ctx.note(f"kernels.wola_gain_share: {kernel['launches']} launches of "
             f"wola_gain over {calls} calls of {ENTRY}")
    return kernel["launches"] / calls

"""Bytes of the dense resampler's intermediates a step, in MB (10**6
bytes): the program's running total of them
(``llzlab_tpu_torch.runtime.profiler.counters()["resample"]``,
``slab_bytes``: each ``resample_poly`` call's history-joined stream, its
zero pad and the slab read as a dense ``(B·S, down + K − 1)`` float32
matrix, from shapes) over the calls of ``Channelizer.step``, warm-up
included.  A count that repeats exactly; a polyphase kernel that reads its
input once takes it to 0.  Nothing where no call of the resampler was
counted."""

LAYER = "ops (ops/resample.py)"
UNIT = "MB"
MOVES = "throughput_msps"
#: the request entry whose calls the bytes are spread over
ENTRY = "Channelizer.step"


def read(ctx):
    from llzlab_tpu_torch.runtime import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:  # a program that keeps no counters
        return None
    got = counters()
    counted = got.get("resample", {})
    calls = got["calls"].get(ENTRY, 0)
    if not calls or not counted.get("samples"):  # no resampler call counted
        return None
    ctx.note(f"resample.slab_mb: {got['resample']} over {calls} calls of "
             f"{ENTRY}")
    return counted["slab_bytes"] / calls / 1e6

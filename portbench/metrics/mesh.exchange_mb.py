"""Bytes the exchanges between ranks move a step, in MB (10**6 bytes):
the program's running totals of the bytes each exchange notes
(``llzlab_tpu_torch.runtime.profiler.counters()``, ``traffic_bytes``,
counted as ``collective_traffic`` counts them: a send's payload times its
sends) over the calls of the sharded step, warm-up included.  With
``mesh.exchange_ms`` it gives the exchange's bandwidth."""

LAYER = "parallel and halo (parallel/, kernels/halo_ring.py)"
UNIT = "MB"
MOVES = "throughput_msps"
#: the request entry whose calls the bytes are spread over
ENTRY = "Channelizer.sharded_step"


def read(ctx):
    from llzlab_tpu_torch.runtime import profiler

    counters = getattr(profiler, "counters", None)
    if counters is None:  # a program that keeps no counters
        return None
    got = counters()
    calls = got["calls"].get(ENTRY, 0)
    moved = sum(got["traffic_bytes"].values())
    if not calls or not moved:
        return None
    ctx.note(f"mesh.exchange_mb: {got['traffic_bytes']} bytes over {calls} "
             f"calls of {ENTRY}")
    return moved / calls / 1e6

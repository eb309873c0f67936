"""Device time a step of the exchange between ranks, summed over the
cards: kernel B3 (``halo_ring_kernel``), the publish kernel of its
network edges, and copies between cards that run as ``Memcpy PtoP`` (the
halos of ``ppermute``).  With peer access on, the state's tails to rank 0
run as a copy kernel on the card and are not counted."""

LAYER = "parallel and halo (parallel/, kernels/halo_ring.py)"
UNIT = "ms"
MOVES = "throughput_msps"
#: the names (or name prefixes) of the exchange's device operations
NAMES = ("halo_ring_kernel", "halo_net_publish_kernel", "Memcpy PtoP")


def read(ctx):
    tr = ctx.trace
    lo, hi = tr.window
    total = sum(min(e, hi) - max(s, lo)
                for c in ctx.cards for s, e, n in tr.ops_in_window(c)
                if any(key in n for key in NAMES))
    if total <= 0.0:
        return None
    return total / ctx.steps * 1e3

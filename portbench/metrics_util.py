"""What several per-layer readers share."""


def idle_pct(ctx, name: str) -> float:
    """The mean over the cards of the share of the traced slice in which
    the card ran nothing; each card's share goes on an earlier line."""
    tr = ctx.trace
    shares = [100.0 * (1.0 - tr.busy_s(c) / tr.window_s) for c in ctx.cards]
    ctx.note(f"{name} per card: " + ", ".join(
        f"card {c} {s:.4f} %" for c, s in zip(ctx.cards, shares)))
    return sum(shares) / len(shares)

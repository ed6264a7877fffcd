"""How far the ranks' bands fall short of the slowest: 100 x (1 - mean
over ranks / largest) of each rank's device time outside the all-gather
kernels over the traced frames. Every frame waits for the slowest band,
so this share of the cards' band time is spent waiting."""


def read(ctx):
    busy = ctx.facts.get("band_busy_s")
    if not busy or max(busy) <= 0:
        return None
    return (1.0 - sum(busy) / len(busy) / max(busy)) * 100.0

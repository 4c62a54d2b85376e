"""share: batches whose speculative recognition slab was used, over all
that had one (`engine.stats`: hits / (hits + misses + wasted)), over the
window."""


def read(ctx):
    s = ctx.window["stats"]
    n = s["spec_hits"] + s["spec_misses"] + s["spec_wasted"]
    return s["spec_hits"] / n if n else None

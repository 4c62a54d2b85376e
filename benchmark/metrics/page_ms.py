"""ms: the window's time over every page it completed, the mean latency
of a caller that waits for each page."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["seconds"] / w["pages"] if w["pages"] else None

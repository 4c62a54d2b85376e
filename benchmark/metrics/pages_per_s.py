"""pages/s: every page the window completed over the window's seconds."""


def read(ctx):
    w = ctx.window
    return w["pages"] / w["seconds"] if w["seconds"] > 0 else None

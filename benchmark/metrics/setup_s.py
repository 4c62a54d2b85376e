"""s: process start to the first timed page (imports, weights, kernel
libraries, engine, pages, warm-up of this cell's shapes)."""


def read(ctx):
    return ctx.setup_s

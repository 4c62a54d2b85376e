"""launches/page: CUDA kernels in the traced slice over its pages."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["pages"]:
        return None
    return len(ctx.trace.kernels) / ctx.traced["pages"]

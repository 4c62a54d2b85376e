"""ms: the nearest-rank 95th percentile over every page of the window,
each timed from the `image_to_data` call to its return; a page that
failed counts as missing every latency (+inf)."""

from benchlib.readers import percentile


def read(ctx):
    lat = ctx.window["latencies_s"]
    return 1e3 * percentile(lat, 95) if lat else None

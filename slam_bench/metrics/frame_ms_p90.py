"""frame_ms_p90: the 90th percentile, over every frame of the window, of
the time from handing the frame to `process` to having its pose on the
host (ms)."""

import statistics


def read(ctx, name):
    lat = [1e3 * x for x in ctx.latencies_s]
    if len(lat) < 10:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]

"""frame_ms: the measured window over the frames completed in it (ms per
frame), on the host clock; a frame is complete when its pose is on the
host."""


def read(ctx, name):
    if not ctx.latencies_s:
        return None
    return 1e3 * ctx.window_s / len(ctx.latencies_s)

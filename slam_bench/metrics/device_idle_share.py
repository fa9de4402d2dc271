"""device_idle_share: 1 minus the device's busy time per frame (the union
of its operations' intervals over the traced frames) over the ms per frame
of the unprofiled window of the same run, in %. The profiler lengthens the
traced frames, so their own wall time is not the denominator."""


def read(ctx, name):
    tr = ctx.trace
    if tr is None or not tr.frames or not ctx.latencies_s:
        return None
    busy = tr.busy_s() / tr.frames
    if busy <= 0:
        return None
    frame = ctx.window_s / len(ctx.latencies_s)
    return 100.0 * (1.0 - busy / frame)

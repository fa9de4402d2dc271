"""span_ms.<layer>: host ms per frame inside the layer's stage spans
(`layers/<layer>.json`) of the program's own recorder, over the window's
frames: the host time of the layer with no profiler attached."""

from slam_bench import spans


def read(ctx, name):
    frames = spans.window_frames(ctx)
    iv = spans.stage_spans(frames, ctx.stages(name.split(".", 1)[1]))
    if not iv:
        return None
    return 1e-6 * sum(e - s for s, e in iv) / len(frames)

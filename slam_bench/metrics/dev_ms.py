"""dev_ms.<layer>: device time per traced frame of the operations whose
runtime call was made inside the layer's `ssf.<stage>` ranges (ms per
frame)."""


def read(ctx, name):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    stages = ctx.stages(name.split(".", 1)[1])
    if not tr.stage_ranges(stages):
        return None
    return 1e3 * tr.device_s(stages) / tr.frames

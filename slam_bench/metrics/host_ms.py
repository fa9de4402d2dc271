"""host_ms.<layer>: host time per traced frame inside the `ssf.<stage>`
ranges the layer owns (`layers/<layer>.json`): the launches and the waits
the frame step makes there (ms per frame)."""


def read(ctx, name):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    stages = ctx.stages(name.split(".", 1)[1])
    if not tr.stage_ranges(stages):
        return None
    return 1e3 * tr.host_s(stages) / tr.frames

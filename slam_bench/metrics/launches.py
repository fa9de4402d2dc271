"""launches.<layer>: CUDA launch calls per traced frame whose start lies
inside the layer's stage spans of the program's own recorder on the
traced frames, on the threads of the harness's `bench.step` ranges. The
spans and the trace share one clock, so this counts what the profiler's
own `ssf.<stage>` ranges of the layer hold."""

import bisect

from slam_bench import spans
from slam_bench.trace import STEP, is_launch


def read(ctx, name):
    tr = ctx.trace
    frames = spans.traced_frames(ctx)
    iv = spans.stage_spans(frames, ctx.stages(name.split(".", 1)[1]))
    if tr is None or not tr.frames or not iv:
        return None
    threads = {th for n, _, _, th in tr.ranges if n == STEP}
    starts = sorted(s for n, s, _, th in tr.calls
                    if is_launch(n) and th in threads)
    n = 0
    for s, e in iv:
        n += (bisect.bisect_right(starts, e * 1e-9)
              - bisect.bisect_left(starts, s * 1e-9))
    return n / tr.frames

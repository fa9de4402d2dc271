"""launches_per_frame: CUDA launch calls the host makes inside the
harness's `bench.step` ranges (the call to `SupersurfelFusion.process`),
per traced frame."""

from slam_bench.trace import STEP, is_launch


def read(ctx, name):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    return tr.calls_in(STEP, is_launch) / tr.frames

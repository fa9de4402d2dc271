"""host_waits_per_frame: CUDA runtime calls that make the host wait for
the device (stream, device and event synchronisations, blocking copies)
inside the harness's `bench.step` ranges, per traced frame. The pose read
after each step is the harness's and is not counted."""

from slam_bench.trace import STEP, is_sync


def read(ctx, name):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    return tr.calls_in(STEP, is_sync) / tr.frames

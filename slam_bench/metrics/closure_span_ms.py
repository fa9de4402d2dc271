"""closure_span_ms.<part>: mean host ms of the program's recorder span
`lc.<part>` over the window's frames on which the loop-closure gate fired
(`closures.gate_frames`), unprofiled. The parts of the closure: `relocalise`
(descriptor match, GMS, the rigid RANSAC and its SVD waits), `align` (the
dense ICP) and `deform` (the graph, its bindings and Gauss-Newton solve,
the deformed model and keyframe poses)."""

from slam_bench import closures


def read(ctx, name):
    part = name.split(".", 1)[1]
    return closures.span_ms(closures.gate_frames(ctx), f"lc.{part}")

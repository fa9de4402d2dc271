"""closure_frame_ms: mean host ms of the program's frame span (entry to
return of `process_frame`) over the window's frames on which the
loop-closure gate fired (`closures.gate_frames`), unprofiled: the step of
a frame that relocalises, aligns and deforms the map."""

from slam_bench import closures


def read(ctx, name):
    return closures.span_ms(closures.gate_frames(ctx), "frame")

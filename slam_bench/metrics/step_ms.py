"""step_ms: host ms per frame of the program's frame span
(`process_frame`, entry to return) over the window's frames, unprofiled.
`frame_ms` less this is the harness's own time and the pose read's wait
for the device."""

from slam_bench import spans


def read(ctx, name):
    frames = spans.window_frames(ctx)
    if not frames:
        return None
    return 1e-6 * sum(f.end_ns - f.start_ns for f in frames) / len(frames)

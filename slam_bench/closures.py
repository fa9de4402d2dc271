"""The window's closure frames, as the loop-closure readers see them: the
frames of the program's own recorder (`spans.window_frames`) that carry
its `lc.gate` counter, the frames on which the loop-closure gate fired and
`close_global_loop` ran. A program whose recorder keeps no counters has
none, and its readers read nothing."""

from __future__ import annotations

from slam_bench import spans

GATE = "lc.gate"


def gate_frames(ctx) -> list:
    """The window's recorded frames whose `lc.gate` counter is set."""
    return [f for f in spans.window_frames(ctx)
            if (getattr(f, "counts", None) or {}).get(GATE)]


def span_ms(frames, name: str):
    """Mean host ms per frame inside the spans called `name` over
    `frames` (summed within a frame), or None where no frame has one."""
    per = [[e - s for n, _, s, e in f.spans if n == name] for f in frames]
    if not any(per):
        return None
    return 1e-6 * sum(map(sum, per)) / len(frames)

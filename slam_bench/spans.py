"""The program's own span recorder (`supersurfel_fusion_tpu_torch.tracing`)
as the per-layer readers see it, in the process that ran the cell.

The recorder keeps the last frames of the step in a ring, each with its
spans in Unix-epoch nanoseconds, the clock of `torch.profiler`'s events.
So its frames fall into two sets against the traced stretch: the window's
frames, run without the profiler, and the traced frames, whose spans can
be set against the trace's runtime calls. A program without the recorder
gives no frames, and its readers read nothing.
"""

from __future__ import annotations


def ring() -> list:
    """The recorder's frames, oldest first; [] without a recorder."""
    try:
        from supersurfel_fusion_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.frames()


def window_frames(ctx) -> list:
    """The window's frames: the last `len(ctx.latencies_s)` of the ring's
    frames that ended before the traced stretch began (so not the warm-up
    frames, which hold first-use costs). [] without a trace."""
    tr, n = ctx.trace, len(ctx.latencies_s)
    if tr is None or not n:
        return []
    before = [f for f in ring() if f.end_ns * 1e-9 < tr.t0]
    return before[-n:]


def traced_frames(ctx) -> list:
    """The ring's frames inside the traced stretch."""
    tr = ctx.trace
    if tr is None:
        return []
    return [f for f in ring()
            if f.start_ns * 1e-9 >= tr.t0 and f.end_ns * 1e-9 <= tr.t1]


def stage_spans(frames, stages) -> list:
    """(start ns, end ns) of the spans of the `ssf.<stage>` stages in
    `frames`."""
    names = {f"ssf.{s}" for s in stages}
    return [(s, e) for f in frames for name, _, s, e in f.spans
            if name in names]

"""The port's span recorder: host time per layer of the frame step, kept
in memory while the program runs.

Every range the port opens goes through this module:

* `frame()`: the root span of one frame step (`pipeline.process_frame`);
  the recorder numbers the frames itself;
* `stage(name)`: a stage of the step (`graphs.stage`). It records a span
  "ssf.<name>" around the profiler range `record_function("ssf.<name>")`,
  which the port has always opened there;
* `span(name)`: a part of a stage ("tps.rgb", "features.score", ...),
  recorded here only: the profiler sees the stage ranges alone, side by
  side, as it did before there was a recorder;
* `part(name)`: a part of a stage that the stage runner runs as a CUDA
  graph of its own (`graphs.part`: "mod.a", ...), recorded here only;
* `eager_op(name)`: an op run eagerly between such parts because it
  makes the host wait ("mod.svd"), recorded here only;
* `count(name, n)`: adds the host integer n to the open frame's counter
  `name`, kept on the frame: `lc.gate` (the loop-closure gate fired), and
  those the spans above keep of themselves, `stage.eager` and
  `stage.replay` (run op by op, or a CUDA graph replayed: `replay=True`),
  `part.eager`, `part.replay` and `eager_op`.

A stage's parts are recorded where its Python runs: on a replayed stage
or part they are not, since the replay runs the graph captured from
them. A span holds its name, its parent (an index into its frame's
spans, -1 for the frame span) and its start and end in Unix-epoch
nanoseconds (`time.time_ns()`), the clock of `torch.profiler`'s events,
so that a reader can set the spans against a profiler trace of the same
frames.
Spans opened outside a frame (a bare call of an op, the detector's
trainer) are not stored. The last `CAPACITY` frames are kept in a ring.
One recorder serves the process, which runs one frame step at a time on
one thread: the benchmark's readers find it after the run by importing
this module.

The recorder makes no CUDA call and reads no device value: a span's time
is the host's, the time the step spends queueing its work and waiting
where it must. It is on by default; `enable(False)` exists to measure
what it costs.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

from torch.profiler import record_function

# frames: a whole 51 s benchmark window of a step of 12.5 ms or more (the
# 640x480 step with its stages as CUDA graphs takes 31-40 ms on one H100,
# 1300-1650 frames a window)
CAPACITY = 4096
FRAME = "frame"
_now = time.time_ns   # the profiler's clock (Unix epoch ns)


class Frame(NamedTuple):
    """One recorded frame step: its number and its spans, each a list
    [name, parent index, start ns, end ns]; spans[0] is the frame span.
    `counts` holds its counters ({name: int}), or None where none was
    counted."""

    number: int
    spans: list
    counts: dict | None = None

    @property
    def start_ns(self) -> int:
        return self.spans[0][2]

    @property
    def end_ns(self) -> int:
        return self.spans[0][3]


class Recorder:
    """The ring of recorded frames and the frame being recorded."""

    def __init__(self, capacity: int = CAPACITY):
        self.frames: collections.deque = collections.deque(maxlen=capacity)
        self.enabled = True
        self.count = 0         # frames numbered so far
        self._spans = None     # the open frame's spans, None outside one
        self._stack: list = []  # indices of the open spans
        self._counters: dict = {}  # the open frame's counters


RECORDER = Recorder()


class _Span:
    """A recorder span, counted in the open frame's counter `counter`
    unless it is None, and with `ranged` inside the profiler range of its
    name; the recorder's part is a no-op outside a frame."""

    __slots__ = ("name", "rec", "counter", "rf")

    def __init__(self, name: str, counter: str | None = None,
                 ranged: bool = False):
        self.name = name
        self.counter = counter
        self.rf = record_function(name) if ranged else None

    def __enter__(self):
        spans = RECORDER._spans
        if spans is None:
            self.rec = None
        else:
            stack = RECORDER._stack
            self.rec = rec = [self.name, stack[-1], _now(), 0]
            stack.append(len(spans))
            spans.append(rec)
            if self.counter is not None:
                count(self.counter)
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        if rec is not None:
            rec[3] = _now()
            RECORDER._stack.pop()
        return False


class _Frame:
    """The root span of one frame step (frame steps do not nest)."""

    __slots__ = ("number",)

    def __enter__(self):
        rec = RECORDER
        self.number = rec.count
        rec.count += 1
        if rec.enabled:
            rec._spans = [[FRAME, -1, _now(), 0]]
            rec._stack = [0]
            rec._counters = {}
        return self

    def __exit__(self, exc_type, *exc):
        rec = RECORDER
        spans = rec._spans
        if spans is None:
            return False
        spans[0][3] = _now()
        rec._spans, rec._stack = None, []
        if exc_type is None:   # a step that raised is not kept
            rec.frames.append(Frame(self.number, spans,
                                    rec._counters or None))
        return False


def frame() -> _Frame:
    """The root span of one frame step."""
    return _Frame()


def stage(name: str, replay: bool = False) -> _Span:
    """The stage `name`: a recorder span "ssf.<name>" around the profiler
    range of the same name; `replay`: the stage is a CUDA graph's
    replay."""
    return _Span("ssf." + name, "stage.replay" if replay else "stage.eager",
                 ranged=True)


def span(name: str) -> _Span:
    """A part of a stage, recorded here only."""
    return _Span(name)


def part(name: str, replay: bool = False) -> _Span:
    """A part of a stage run as a graph of its own (`graphs.part`),
    recorded here only; `replay`: the part is a CUDA graph's replay."""
    return _Span(name, "part.replay" if replay else "part.eager")


def eager_op(name: str) -> _Span:
    """An op run eagerly between a stage's parts, recorded here only."""
    return _Span(name, "eager_op")


def count(name: str, n: int = 1) -> None:
    """Add the host integer `n` to the open frame's counter `name`; a
    no-op outside a frame. It takes no tensor, so it never waits for the
    device."""
    rec = RECORDER
    if rec._spans is not None:
        rec._counters[name] = rec._counters.get(name, 0) + int(n)


def enable(on: bool = True) -> None:
    """Record frames from the next frame on (default), or not."""
    RECORDER.enabled = bool(on)


def frames(since: int = 0) -> list:
    """The ring's frames numbered `since` or later, oldest first."""
    return [f for f in RECORDER.frames if f.number >= since]


def stage_ms(frames: list) -> dict:
    """Mean host ms per frame inside each span name over `frames` (a
    name that appears several times in a frame is summed there; a frame
    without it counts 0)."""
    if not frames:
        return {}
    tot: dict = {}
    for f in frames:
        for name, _, s, e in f.spans:
            tot[name] = tot.get(name, 0) + (e - s)
    return {k: 1e-6 * v / len(frames) for k, v in tot.items()}


def stage_counts(frames: list) -> dict:
    """Mean stages per frame over `frames` replayed as CUDA graphs and run
    op by op, the same of stages' parts, and the mean ops per frame run
    eagerly between parts."""
    n = max(len(frames), 1)
    return {key: sum((f.counts or {}).get(name, 0) for f in frames) / n
            for key, name in (("replays_per_frame", "stage.replay"),
                              ("eager_per_frame", "stage.eager"),
                              ("part_replays_per_frame", "part.replay"),
                              ("part_eager_per_frame", "part.eager"),
                              ("eager_ops_per_frame", "eager_op"))}

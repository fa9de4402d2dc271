# The stage-linking arithmetic (launch calls counted inside a range on the
# range's thread, by bisection over their start times; the launch call
# names) is taken from supersurfel_fusion_tpu_torch/tools/profile_frame.py
# at commit 37bce59 (`stage_launches`, `_LAUNCH_CALLS`). What differs: the
# records come from the profiler's raw events, each kernel is linked to a
# stage through its launch call's correlation id, and busy time is the
# union of device intervals, set against an unprofiled stretch.
"""The traced stretch of a run as plain records, and the arithmetic over
them that the per-layer metrics share.

`Trace.from_profiler` reads `torch.profiler`'s raw events once: the host
ranges (`ssf.<stage>` from the frame step, `bench.*` from the harness),
the CUDA runtime calls, and the device's operations (kernels, copies,
sets), each operation linked to the stage whose range was open on the host
when its runtime call was made. A hand-made `Trace` serves the tests.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

# names of the host-side CUDA API calls that launch work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                "cuGraphLaunch")
# host-side CUDA API calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")
SYNC_EXACT = ("cudaMemcpy", "cuMemcpyDtoH_v2", "cuMemcpyDtoH")
STEP = "bench.step"


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_CALLS)


def is_sync(name: str) -> bool:
    return name.startswith(SYNC_CALLS) or name in SYNC_EXACT


@dataclass
class Trace:
    """Records of one traced stretch; times in seconds on one clock.

    ranges: (name, start, end, thread) host ranges, `ssf.*` and `bench.*`;
    calls: (name, start, end, thread) CUDA runtime calls;
    ops: (name, start, end, stage) device operations, `stage` the `ssf.*`
    range their call was made in, or None;
    frames: frames in the stretch; t0, t1: its ends on the host clock."""

    ranges: list
    calls: list
    ops: list
    frames: int
    t0: float
    t1: float
    unlinked_ops: int = 0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    # --- host side -------------------------------------------------------
    def stage_ranges(self, stages) -> list:
        names = {f"ssf.{s}" for s in stages}
        return [r for r in self.ranges if r[0] in names]

    def host_s(self, stages) -> float:
        """Host seconds inside the stages' ranges over the stretch."""
        return sum(e - s for _, s, e, _ in self.stage_ranges(stages))

    def calls_in(self, range_name: str, pred) -> int:
        """Runtime calls satisfying `pred(name)` made inside ranges named
        `range_name`, on the range's thread."""
        calls = sorted((s, th) for n, s, _, th in self.calls if pred(n))
        starts = [s for s, _ in calls]
        n = 0
        for name, t0, t1, th in self.ranges:
            if name != range_name:
                continue
            i = bisect.bisect_left(starts, t0)
            j = bisect.bisect_right(starts, t1)
            n += sum(1 for _, t in calls[i:j] if t == th)
        return n

    # --- device side -----------------------------------------------------
    def device_s(self, stages) -> float:
        names = {f"ssf.{s}" for s in stages}
        return sum(e - s for _, s, e, st in self.ops if st in names)

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        stretch, as sorted disjoint (start, end) pairs."""
        iv = sorted((max(s, self.t0), min(e, self.t1))
                    for _, s, e, _ in self.ops)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def host_range_at(self, t: float) -> str:
        """The innermost host range open at time t: an `ssf.*` stage if
        one is, else a `bench.*` range, else "host"."""
        best = "host"
        for name, s, e, _ in self.ranges:
            if s <= t < e:
                if name.startswith("ssf."):
                    return name
                best = name
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, summed by name, and
        the device's idle time between operations summed by the host range
        open at each gap's midpoint; seconds over the stretch."""
        by_name: dict = {}
        for name, s, e, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle: dict = {}
        prev = self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                where = self.host_range_at(0.5 * (s + prev))
                idle[where] = idle.get(where, 0.0) + (s - prev)
            prev = max(prev, e)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}

    # --- from the profiler -------------------------------------------------
    @staticmethod
    def from_profiler(prof, frames: int, stretch: str = "bench.stretch"
                      ) -> "Trace":
        """Records of the stopped `torch.profiler.profile` object `prof`,
        kept inside the host range `stretch` that the harness opens around
        the traced frames."""
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        ranges, calls, dev = [], [], []
        call_at, op_at = {}, {}
        for ev in events:
            name = ev.name()
            s, e = ev.start_ns(), ev.end_ns()
            if ev.device_type() == DeviceType.CPU:
                th = ev.start_thread_id()
                if name.startswith(("ssf.", "bench.")):
                    ranges.append((name, s, e, th))
                    op_at[ev.correlation_id()] = (s, th)
                elif name.startswith(("cuda", "cu")):
                    calls.append((name, s, e, th))
                    call_at[ev.correlation_id()] = (s, th)
                else:
                    op_at[ev.correlation_id()] = (s, th)
            elif ev.device_type() == DeviceType.CUDA:
                if name.startswith(("ssf.", "bench.")) \
                        or ev.is_user_annotation():
                    continue
                dev.append((name, s, e, ev.correlation_id(),
                            ev.linked_correlation_id()))
        box = [r for r in ranges if r[0] == stretch]
        if len(box) != 1:
            raise RuntimeError(f"expected one {stretch!r} range in the "
                               f"trace, found {len(box)}")
        t0, t1 = box[0][1], box[0][2]
        ranges = [r for r in ranges if r[2] > t0 and r[1] < t1]
        stage = sorted((s, e, th, n) for n, s, e, th in ranges
                       if n.startswith("ssf."))
        starts = [x[0] for x in stage]

        def stage_of(t, th):
            # stage ranges are siblings: the one holding t starts last
            # before it (on its thread)
            i = bisect.bisect_right(starts, t) - 1
            for k in range(i, max(i - 8, -1), -1):
                s, e, sth, n = stage[k]
                if sth == th and s <= t <= e:
                    return n
            return None

        ops, unlinked = [], 0
        for name, s, e, corr, linked in dev:
            if e <= t0 or s >= t1:
                continue
            at = call_at.get(corr) or op_at.get(linked)
            unlinked += at is None
            st = stage_of(*at) if at is not None else None
            ops.append((name, s * 1e-9, e * 1e-9, st))
        sec = [(n, s * 1e-9, e * 1e-9, th) for n, s, e, th in ranges]
        cl = [(n, s * 1e-9, e * 1e-9, th) for n, s, e, th in calls
              if t0 <= s < t1]
        return Trace(ranges=sec, calls=cl, ops=ops, frames=frames,
                     t0=t0 * 1e-9, t1=t1 * 1e-9, unlinked_ops=unlinked)

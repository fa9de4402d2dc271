"""The readers of the program's own span recorder (`span_ms.<layer>`,
`step_ms`, `launches.<layer>`) on a hand-made trace and a hand-filled
ring; on a card, `launches.<layer>` against the profiler's own ranges of
the same trace. The card's case:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        slam_bench/tests/test_bench_span_readers.py
"""

from __future__ import annotations

import sys

import pytest

from slam_bench import manifest
from slam_bench.run import Ctx
from slam_bench.tests.conftest import REPO
from slam_bench.trace import STEP, Trace, is_launch
from supersurfel_fusion_tpu_torch import tracing

T0 = 1_800_000_000_000_000_000   # ns: the epoch clock of real runs
MS = 1_000_000
LAYERS = ("segmentation", "vo", "icp", "fusion", "mod")
# stages of one frame: (name, start ms, end ms) from the frame's start;
# a part of tps and one of vo, recorder-only
STAGES = (("ssf.depth", 1, 3), ("ssf.tps", 3, 8), ("tps.rgb", 4, 6),
          ("ssf.features", 9, 13), ("ssf.vo", 13, 15), ("vo.pnp", 14, 15),
          ("ssf.icp", 16, 19), ("ssf.fusion", 19, 20))


def _frame(number: int, start: int, scale: int = 1) -> tracing.Frame:
    """A 20 ms frame (times `scale`) at `start` ns."""
    spans = [["frame", -1, start, start + 21 * MS * scale]]
    for name, s, e in STAGES:
        parent = 2 if name == "tps.rgb" else 5 if name == "vo.pnp" else 0
        spans.append([name, parent, start + s * MS * scale,
                      start + e * MS * scale])
    return tracing.Frame(number, spans)


def _setup(monkeypatch, n_window=3):
    """A ring of a warm-up frame 10 times slower, `n_window` window frames
    and one traced frame; a trace of that frame with its `ssf.*` ranges
    and launches inside and outside them. Returns (ctx, trace)."""
    rec = tracing.Recorder()
    t = T0
    for k in range(1 + n_window):
        rec.frames.append(_frame(k, t, scale=10 if k == 0 else 1))
        t = rec.frames[-1].end_ns + 2 * MS
    traced = _frame(1 + n_window, t + 5 * MS)
    rec.frames.append(traced)
    monkeypatch.setattr(tracing, "RECORDER", rec)

    s0 = traced.start_ns
    ranges = [(STEP, s0 * 1e-9, traced.end_ns * 1e-9, 1)]
    calls = []
    for name, s, e in STAGES:
        if name.startswith("ssf."):
            ranges.append((name, (s0 + s * MS) * 1e-9,
                           (s0 + e * MS) * 1e-9, 1))
    # launches 0.5 ms into every stage and part, two in tps; one between
    # stages (8-9 ms), one on another thread, one wait in icp
    for ms, th in ((1.5, 1), (3.5, 1), (4.5, 1), (9.5, 1), (13.5, 1),
                   (14.5, 1), (16.5, 1), (19.5, 1), (8.5, 1), (3.6, 2)):
        at = (s0 + int(ms * MS)) * 1e-9
        calls.append(("cudaLaunchKernel", at, at + 5e-6, th))
    at = (s0 + 17 * MS) * 1e-9
    calls.append(("cudaStreamSynchronize", at, at + 1e-5, 1))
    tr = Trace(ranges=ranges, calls=calls, ops=[], frames=1,
               t0=(t + 2 * MS) * 1e-9, t1=(traced.end_ns + MS) * 1e-9)
    ctx = Ctx(bench=manifest.Bench(REPO), cell={}, cfg=None, card="test",
              setup_s=1.0, latencies_s=[0.02] * n_window,
              window_s=0.02 * n_window, trace=tr, labels=[])
    return ctx, tr


def read(name, ctx):
    return manifest.Bench(REPO).reader(name)(ctx, name)


def test_span_and_step_ms_over_the_window_frames(monkeypatch):
    ctx, _ = _setup(monkeypatch)
    # the warm-up frame and the traced one are left out
    assert read("span_ms.segmentation", ctx) == pytest.approx(2 + 5)
    assert read("span_ms.vo", ctx) == pytest.approx(4 + 2)
    assert read("span_ms.icp", ctx) == pytest.approx(3)
    assert read("span_ms.fusion", ctx) == pytest.approx(1)
    assert read("span_ms.mod", ctx) is None      # no mod span in the ring
    assert read("step_ms", ctx) == pytest.approx(21)
    # a window longer than the ring's frames before the trace
    ctx.latencies_s = [0.02] * 10
    assert read("step_ms", ctx) == pytest.approx((210 + 3 * 21) / 4)


def test_launches_in_the_traced_frames_stage_spans(monkeypatch):
    ctx, tr = _setup(monkeypatch)
    want = {"segmentation": 3, "vo": 3, "icp": 1, "fusion": 1}
    for layer, n in want.items():
        assert read(f"launches.{layer}", ctx) == n, layer
        # the same count as the profiler's own ranges of the layer
        assert n == sum(tr.calls_in(f"ssf.{s}", is_launch)
                        for s in ctx.stages(layer))
    assert read("launches.mod", ctx) is None


def test_readers_find_nothing_without_what_they_read(monkeypatch):
    names = [f"{m}.{layer}" for m in ("span_ms", "launches")
             for layer in LAYERS] + ["step_ms"]
    ctx, _ = _setup(monkeypatch)
    ctx.trace = None
    assert all(read(n, ctx) is None for n in names)
    # no unprofiled frame in the ring: the window's and launches' readers
    ctx, _ = _setup(monkeypatch, n_window=0)
    ctx.latencies_s = [0.02] * 3
    tracing.RECORDER.frames.popleft()            # the warm-up frame
    assert all(read(n, ctx) is None for n in names
               if not n.startswith("launches"))
    assert read("launches.vo", ctx) == 3
    # a program without the recorder, as the parent commit is
    ctx, _ = _setup(monkeypatch)
    import supersurfel_fusion_tpu_torch as port

    monkeypatch.delattr(port, "tracing")
    monkeypatch.setitem(sys.modules, "supersurfel_fusion_tpu_torch.tracing",
                        None)
    assert all(read(n, ctx) is None for n in names)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fr1_xyz-sway", "fr3_walking-walker"])
def test_launches_equal_the_profilers_ranges_on_the_card(cell, card):
    """A traced stretch of the cell: every stage span of the recorder holds
    its profiler range, and each layer's launches read from the spans
    equal those the profiler's ranges hold."""
    from slam_bench import run

    bench = manifest.Bench(REPO)
    w = bench.cell(cell)
    sf, frames, mix, cfg, _ = run.setup(bench, w, 2**31 + 7, card)
    start = int(mix["warmup_frames"])
    sampler = run.Sampler(1, 16, 1)
    lat, win, nxt, _ = run.window(sf, frames, start, 2.0, sampler)
    tr, labels, bad = run.traced(sf, frames, nxt, 3)
    assert bad == 0
    ctx = Ctx(bench=bench, cell=w, cfg=cfg, card=card, setup_s=0.0,
              latencies_s=lat, window_s=win, trace=tr, labels=labels)
    from slam_bench import spans

    traced = spans.traced_frames(ctx)
    assert len(traced) == 3
    mine = sorted((s * 1e-9, e * 1e-9, n) for f in traced
                  for n, _, s, e in f.spans if n.startswith("ssf."))
    theirs = sorted((s, e, n) for n, s, e, _ in tr.ranges
                    if n.startswith("ssf."))
    assert [n for *_, n in mine] == [n for *_, n in theirs]
    for (s, e, n), (rs, re, _) in zip(mine, theirs):
        assert s <= rs and re <= e, (n, rs - s, e - re)
    layers = LAYERS if cfg.mod.enabled else LAYERS[:4]
    for layer in layers:
        got = read(f"launches.{layer}", ctx)
        want = sum(tr.calls_in(f"ssf.{s}", is_launch)
                   for s in ctx.stages(layer)) / tr.frames
        assert got == want > 0, layer
    assert read("span_ms.vo", ctx) > 0 and read("step_ms", ctx) > 0

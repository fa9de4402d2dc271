"""The port's span recorder (`supersurfel_fusion_tpu_torch/tracing.py`) on
the plain CPU path: spans of a few 256x192 frames with and without MOD,
the ring, spans outside a frame, and what `torch.profiler` sees of the
frame step, which must be the ranges it saw before there was a recorder."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import pipeline as tpipe
from supersurfel_fusion_tpu_torch import synthetic, tracing
from supersurfel_fusion_tpu_torch.ops import tps as tps_ops
from supersurfel_fusion_tpu_torch.ops.depth import depth_to_disp

from test_torch_motion import mod_config
from test_torch_pipeline import small_config

torch.set_num_threads(1)

# the stage ranges `process_frame` opened once each per frame before the
# recorder, in order (no ferns, no loop closure)
STAGES = ["depth", "tps", "planes", "supersurfels", "features", "vo",
          "icp", "local_map", "fusion"]
STAGES_MOD = STAGES[:5] + ["mod"] + STAGES[5:]
N_FRAMES = 3


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "mod"])
def run(request):
    """N_FRAMES frames through `process_frame` under torch.profiler: the
    recorder's frames, the profiler's `ssf.*` ranges (name, start ns, end
    ns, thread) and whether MOD ran."""
    mod = request.param
    cfg = mod_config(tcfg, True) if mod else small_config(tcfg)
    clip = (synthetic.dynamic_frames(cfg.cam, N_FRAMES) if mod
            else synthetic.frames(cfg.cam, N_FRAMES))
    state = tpipe.init_state(cfg, "cpu")
    first = tracing.RECORDER.count
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # as the benchmark's harness does: the profiler's first range
        # pays its set-up
        with record_function("test.stretch"):
            for rgb, depth, *_ in clip:
                state, _ = tpipe.process_frame(state, rgb, depth, cfg)
    ranges = sorted(((ev.name(), ev.start_ns(), ev.end_ns(),
                      ev.start_thread_id())
                     for ev in prof.profiler.kineto_results.events()
                     if ev.name().startswith("ssf.")), key=lambda r: r[1])
    return tracing.frames(first), ranges, mod


def test_spans_nest_under_one_frame_span(run):
    frames, _, mod = run
    assert [f.number for f in frames] == list(range(
        frames[0].number, frames[0].number + N_FRAMES))
    for f in frames:
        spans = f.spans
        assert spans[0][:2] == [tracing.FRAME, -1]
        assert all(n != tracing.FRAME for n, *_ in spans[1:])
        names = [n for n, *_ in spans]
        assert [n[4:] for n in names if n.startswith("ssf.")] \
            == (STAGES_MOD if mod else STAGES)
        for name, parent, s, e in spans[1:]:
            pname, _, ps, pe = spans[parent]
            assert ps <= s <= e <= pe, (name, pname)
            if name.startswith("ssf."):
                assert parent == 0, name
            else:
                # a stage's part lies inside its stage, directly or inside
                # a part of it that the stage runner runs as a graph of its
                # own (`graphs.part`: MOD's "mod.a", ...)
                up = parent
                while not spans[up][0].startswith("ssf."):
                    assert spans[up][0].split(".")[0] == name.split(".")[0]
                    up = spans[up][1]
                assert spans[up][0] == "ssf." + name.split(".")[0], (name,
                                                                     pname)
        parts = {n for n in names if not n.startswith(("ssf.", "frame"))}
        assert {"tps.rgb", "tps.plane_init", "tps.rgbd", "features.score",
                "features.select", "features.describe", "vo.match",
                "vo.pnp", "icp.targets", "icp.iterate", "fusion.match",
                "fusion.filter"} <= parts
        assert names.count("features.describe") == small_config(
            tcfg).vo.nb_levels
        assert any(n.startswith("mod.") for n in parts) == mod
    ms = tracing.stage_ms(frames)
    assert 0 < ms["ssf.tps"] < ms["frame"]
    assert ms["tps.rgb"] < ms["ssf.tps"]


def test_profiler_sees_the_stage_ranges_alone(run):
    """Per frame the profiler holds each stage range once, none inside
    another, and no recorder-only span; each stage span of the recorder
    holds its range and starts and ends within 200 us of it: one clock."""
    frames, ranges, mod = run
    want = STAGES_MOD if mod else STAGES
    assert [n[4:] for n, *_ in ranges] == want * N_FRAMES
    for a, b in zip(ranges, ranges[1:]):
        assert a[2] <= b[1], (a, b)
    mine = [(n, s, e) for f in frames for n, _, s, e in f.spans
            if n.startswith("ssf.")]
    assert len(mine) == len(ranges)
    for (n, s, e), (rn, rs, re, _) in zip(mine, ranges):
        assert n == rn
        assert s <= rs and re <= e, (n, rs - s, e - re)
        assert rs - s < 200_000 and e - re < 200_000, (n, rs - s, e - re)


def test_ring_keeps_the_last_frames(monkeypatch):
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(capacity=3))
    for _ in range(5):
        with tracing.frame():
            with tracing.stage("depth"):
                with tracing.span("depth.part"):
                    pass
    frames = tracing.frames()
    assert [f.number for f in frames] == [2, 3, 4]
    assert [[n for n, *_ in f.spans] for f in frames] == \
        [["frame", "ssf.depth", "depth.part"]] * 3
    assert [f.number for f in tracing.frames(since=4)] == [4]


def test_spans_outside_a_frame_are_not_stored(monkeypatch):
    """A bare op call (the trainer's steps alike) records nothing; a
    disabled recorder keeps no frame but numbers it; a frame that raises
    is not kept and leaves no frame open."""
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    cfg = small_config(tcfg)
    rgb, depth, *_ = synthetic.frames(cfg.cam, 1)[0]
    disp = depth_to_disp(torch.from_numpy(depth).float() * cfg.depth_scale)
    with tracing.stage("tps"):
        tps_ops.segment(torch.from_numpy(rgb).float(), disp, cfg.tps)
    assert tracing.frames() == [] and tracing.RECORDER._spans is None
    tracing.enable(False)
    try:
        with tracing.frame():
            with tracing.span("x"):
                pass
    finally:
        tracing.enable(True)
    assert tracing.frames() == [] and tracing.RECORDER.count == 1
    with pytest.raises(ValueError):
        with tracing.frame():
            with tracing.span("x"):
                raise ValueError
    assert tracing.frames() == [] and tracing.RECORDER._spans is None
    with tracing.frame():
        pass
    assert [f.number for f in tracing.frames()] == [2]


def test_cpu_runner_runs_every_stage_eagerly():
    """On the CPU `SupersurfelFusion` has no CUDA graphs: every stage of
    every frame is counted as run op by op, none as replayed, and the
    runner's report says so."""
    cfg = small_config(tcfg)
    sf = tpipe.SupersurfelFusion(cfg, device="cpu")
    assert sf.graphs is None
    first = tracing.RECORDER.count
    for rgb, depth, *_ in synthetic.frames(cfg.cam, 2):
        sf.process(rgb, depth)
    frames = tracing.frames(first)
    assert [f.counts for f in frames] == [{"stage.eager": len(STAGES)}] * 2
    assert sf.graph_report(frames) == {
        "captured": [], "capture_ms": 0.0, "replays_per_frame": 0.0,
        "eager_per_frame": float(len(STAGES)), "part_replays_per_frame": 0.0,
        "part_eager_per_frame": 0.0, "eager_ops_per_frame": 0.0}


def test_stage_counts_of_recorded_frames(monkeypatch):
    """A stage opened with `replay=True` counts as replayed, any other as
    eager; a graphed part (`part`) likewise among the parts, and an op
    between parts (`eager_op`) as an eager op; plain parts and spans
    outside a frame count nothing."""
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    with tracing.stage("depth"):
        with tracing.part("depth.a"), tracing.eager_op("depth.op"):
            pass
    for replayed in (2, 0):
        with tracing.frame():
            for i in range(3):
                with tracing.stage("s", replay=i < replayed):
                    with tracing.span("s.part"):
                        pass
            with tracing.stage("m"):
                for i in range(3):
                    with tracing.part("m.p", replay=i < replayed):
                        with tracing.span("m.inner"):
                            pass
                    with tracing.eager_op("m.op"):
                        pass
    frames = tracing.frames()
    assert [f.counts for f in frames] == [
        {"stage.replay": 2, "stage.eager": 2, "part.replay": 2,
         "part.eager": 1, "eager_op": 3},
        {"stage.eager": 4, "part.eager": 3, "eager_op": 3}]
    assert tracing.stage_counts(frames) == {
        "replays_per_frame": 1.0, "eager_per_frame": 3.0,
        "part_replays_per_frame": 1.0, "part_eager_per_frame": 2.0,
        "eager_ops_per_frame": 3.0}
    assert tracing.stage_counts([]) == {
        "replays_per_frame": 0.0, "eager_per_frame": 0.0,
        "part_replays_per_frame": 0.0, "part_eager_per_frame": 0.0,
        "eager_ops_per_frame": 0.0}


def test_counters_of_recorded_frames(monkeypatch):
    """`count` adds host integers to the open frame's counters, which the
    frame keeps beside its stages' own (None where nothing was counted);
    outside a frame, or with the recorder off, it keeps nothing."""
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    tracing.count("lc.gate")
    for n in (2, 0):
        with tracing.frame():
            with tracing.stage("loop_closure"):
                for _ in range(n):
                    tracing.count("lc.gate")
                tracing.count("other", 3 * n)
        with tracing.frame():
            pass
    tracing.enable(False)
    try:
        with tracing.frame():
            tracing.count("lc.gate")
    finally:
        tracing.enable(True)
    frames = tracing.frames()
    assert [f.counts for f in frames] == [
        {"stage.eager": 1, "lc.gate": 2, "other": 6}, None,
        {"stage.eager": 1, "other": 0}, None]
    assert tracing.RECORDER._counters == {}

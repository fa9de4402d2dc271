"""The frame step's stages as CUDA graphs (`graphs.py`) in
`SupersurfelFusion` on a card, against the same step run op by op
(`pipeline.process_frame` outside the runner). The two configurations and
traffic mixes of the benchmark's cells, 640x480. Skipped without a card;
on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

import dataclasses
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

from supersurfel_fusion_tpu_torch import pipeline, tracing
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.ops import tps_cuda
from supersurfel_fusion_tpu_torch.tools.profile_frame import kernel_runs

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 12
SNAPSHOT = 3      # the frame whose state and output are held to the end
GRAPHED = ["depth", "tps", "planes", "supersurfels", "features", "vo",
           "icp", "local_map", "fusion"]
# MOD's parts, each a graph inside the `mod` stage, in capture order, and
# the recorder spans of the stage's Python: the parts and the rigid
# RANSAC's two eager SVDs between them
MOD_PARTS = ["mod.a", "mod.b", "mod.c"]
MOD_SPANS = ["mod.a", "mod.svd", "mod.b", "mod.svd", "mod.c"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cell(name: str, frames: int = N_FRAMES, seed: int = 2**31 + 7):
    """The cell's configuration and its first `frames` frames (host
    uint8 RGB, uint16 depth), rendered on the card."""
    from slam_bench import manifest, scene

    bench = manifest.Bench(REPO)
    c = bench.cell(name)
    doc = bench.config(c["config"])
    cfg = manifest.build_config(PipelineConfig, doc, REPO)
    mix = dict(bench.traffic(c["traffic"]), poses=frames)
    rgb, depth, _ = scene.render_stream(doc["pipeline"]["cam"], mix, seed,
                                        "cuda")
    return cfg, rgb, depth


def tensors(tree, path="x"):
    """(path, tensor) for every tensor of a tree of named tuples."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from tensors(v, f"{path}.{k}")


def differing(a, b) -> list:
    pa, pb = dict(tensors(a)), dict(tensors(b))
    assert pa.keys() == pb.keys()
    return [k for k in pa if not torch.equal(pa[k], pb[k])]


@pytest.fixture(scope="module", params=["fr1_xyz-sway", "fr3_walking-walker"])
def run(request, cuda):
    """N_FRAMES frames through SupersurfelFusion (graphs) and, in lock
    step, through process_frame op by op from its own initial state; per
    frame the leaves that differ, the frame-SNAPSHOT state and output with
    copies of them, the runner, the TPS launchers' calls, and in a trace
    of the last graphed frame the TPS kernels' runs and the profiler's
    ranges of the port's stages and MOD's parts (name, start, end)."""
    cfg, rgb, depth = cell(request.param)
    sf = pipeline.SupersurfelFusion(cfg, device=cuda)
    state = pipeline.init_state(cfg, cuda)
    first = tracing.RECORDER.count
    tps_cuda.reset_launch_counts()
    diffs, snap = [], None
    for k in range(N_FRAMES):
        if k < N_FRAMES - 1:
            out_g = sf.process(rgb[k], depth[k])
        else:
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]) as p:
                out_g = sf.process(rgb[k], depth[k])
                torch.cuda.synchronize()
            runs = kernel_runs(p, ["tps_iteration_kernel",
                                   "tps_merge_kernel"])
            ranges = sorted(
                ((e.name(), e.start_ns(), e.end_ns())
                 for e in p.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CPU
                 and e.name().startswith(("ssf.", "mod."))),
                key=lambda r: r[1])
        state, out_e = pipeline.process_frame(state, rgb[k], depth[k], cfg)
        diffs.append(differing((sf.state, out_g), (state, out_e)))
        if k == SNAPSHOT:
            snap = (sf.state, out_g)
            copy = [t.clone() for _, t in tensors(snap)]
    torch.cuda.synchronize()
    launches = dict(tps_cuda.launch_counts)
    frames = tracing.frames(first)[::2]      # the graphed runner's frames
    return dict(cell=request.param, cfg=cfg, sf=sf, diffs=diffs, snap=snap,
                copy=copy, frames=frames, launches=launches, runs=runs,
                ranges=ranges)


@pytest.mark.cuda
def test_graphs_equal_eager(run):
    """Every frame's state and outputs bit-equal to the op-by-op step's,
    the eager first frame and the capture frame included; every stage but
    MOD, and MOD's three parts, captured in the second frame and replayed
    after. MOD's stage runs its Python every frame (counted as a stage
    run op by op), with its two SVDs eager between the parts."""
    bad = {k: d for k, d in enumerate(run["diffs"]) if d}
    assert not bad, bad
    mod = run["cfg"].mod.enabled
    parts = MOD_PARTS if mod else []
    rep = run["sf"].graph_report(run["frames"][2:])
    assert rep["captured"] == GRAPHED[:5] + parts + GRAPHED[5:]
    assert rep["replays_per_frame"] == len(GRAPHED)
    assert rep["eager_per_frame"] == (1 if mod else 0)
    assert rep["part_replays_per_frame"] == len(parts)
    assert rep["part_eager_per_frame"] == 0
    assert rep["eager_ops_per_frame"] == (2 if mod else 0)
    counters = ("stage.replay", "stage.eager", "part.replay", "part.eager",
                "eager_op")
    f0, f1 = ([f.counts.get(c, 0) for c in counters]
              for f in run["frames"][:2])
    assert f0 == [0, len(GRAPHED) + mod, 0, len(parts), 2 * mod]
    assert f1 == [len(GRAPHED), mod, len(parts), 0, 2 * mod]
    # the launchers run on every op-by-op frame and on the runner's eager
    # and capture frames; a replay runs the captured kernels without them
    assert run["launches"] == {"tps_iteration": 10 * (N_FRAMES + 2),
                               "tps_merge": 12 * (N_FRAMES + 2)}
    assert run["runs"] == {"tps_iteration_kernel": 10,
                           "tps_merge_kernel": 12}


@pytest.mark.cuda
def test_returned_state_is_never_written(run):
    """A state and an output `process` returned at frame SNAPSHOT are
    unchanged after the last frame (the benchmark keeps sampled ones to
    check after its window)."""
    now = [t for _, t in tensors(run["snap"])]
    assert all(torch.equal(a, b) for a, b in zip(now, run["copy"]))


@pytest.mark.cuda
def test_replayed_frames_record_stages_alone(run):
    """A replayed stage keeps its recorder span and profiler range; its
    parts are recorded on the eager and capture frames only. MOD's stage
    holds its graphed parts and SVDs as recorder spans on every frame,
    and the parts' own parts on the eager and capture frames only. The
    profiler sees each stage's range once in a replayed frame, one
    `ssf.mod` among them, none inside another, and no range of a part."""
    mod = run["cfg"].mod.enabled
    stages = ["ssf." + s for s in GRAPHED]
    if mod:
        stages.insert(5, "ssf.mod")
    for f in run["frames"]:
        names = [n for n, *_ in f.spans]
        assert [n for n in names if n.startswith("ssf.")] == stages
        parts = {n for n in names if not n.startswith(("ssf.", "frame"))}
        eager = "stage.replay" not in f.counts or f is run["frames"][1]
        assert ("icp.iterate" in parts) == eager
        if mod:
            i = names.index("ssf.mod")
            assert [n for n, p, *_ in f.spans if p == i] == MOD_SPANS
            assert ("mod.clusters" in parts) == eager
    ranges = run["ranges"]
    assert [n for n, *_ in ranges] == stages
    for a, b in zip(ranges, ranges[1:]):
        assert a[2] <= b[1], (a, b)


@pytest.mark.cuda
def test_patched_segment_is_captured(cuda):
    """A patch of `pipeline._segment` (the benchmark's label fault) made
    before the runner starts changes the labels of the replayed frames as
    it does op by op."""
    from slam_bench import faults

    cfg, rgb, depth = cell("fr1_xyz-sway", frames=4)
    plain = pipeline.SupersurfelFusion(cfg, device=cuda)
    want = [plain.process(rgb[k], depth[k]).labels for k in range(4)]
    with faults.planted("labels_patch"):
        sf = pipeline.SupersurfelFusion(cfg, device=cuda)
        got = [sf.process(rgb[k], depth[k]).labels for k in range(4)]
        state = pipeline.init_state(cfg, cuda)
        eager = []
        for k in range(4):
            state, out = pipeline.process_frame(state, rgb[k], depth[k], cfg)
            eager.append(out.labels)
    assert sf.graph_report([])["captured"] == GRAPHED
    for k in range(4):
        assert torch.equal(got[k], eager[k]), k
        assert not torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_ferns_stay_eager(cuda):
    """With ferns on, `ferns` runs op by op between graphed stages, and
    the step equals the op-by-op one."""
    cfg, rgb, depth = cell("fr1_xyz-sway", frames=5)
    cfg = dataclasses.replace(
        cfg, ferns=dataclasses.replace(cfg.ferns, enabled=True))
    sf = pipeline.SupersurfelFusion(cfg, device=cuda)
    state = pipeline.init_state(cfg, cuda)
    first = tracing.RECORDER.count
    for k in range(5):
        out_g = sf.process(rgb[k], depth[k])
        state, out_e = pipeline.process_frame(state, rgb[k], depth[k], cfg)
        assert not differing((sf.state, out_g), (state, out_e)), k
    last = tracing.frames(first)[-2]
    assert last.counts == {"stage.replay": len(GRAPHED), "stage.eager": 2}
    assert sf.graph_report([])["captured"] == GRAPHED


@pytest.mark.cuda
def test_loop_closure_frames_equal_eager(cuda):
    """The revisit clip with ferns and loop closure on: ferns and
    loop_closure run op by op, every frame (the closures the gate fires
    on included) equals the op-by-op step's, and only stages after the
    closure, which hands them its own pose, model and local map, can have
    a second graph (where the closure's tensors have other strides)."""
    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.tools.profile_frame import lc_config

    cfg = lc_config()
    sf = pipeline.SupersurfelFusion(cfg, device=cuda)
    state = pipeline.init_state(cfg, cuda)
    fired = []
    for k, (rgb, depth, _) in enumerate(synthetic.revisit_frames(cfg.cam)):
        out_g = sf.process(rgb, depth)
        state, out_e = pipeline.process_frame(state, rgb, depth, cfg)
        assert not differing((sf.state, out_g), (state, out_e)), k
        assert out_g.lc_gate == out_e.lc_gate
        if out_g.lc_gate:
            fired.append(bool(out_g.lc_accepted))
    assert True in fired
    captured = sf.graph_report([])["captured"]
    assert captured[:len(GRAPHED)] == GRAPHED
    assert set(captured[len(GRAPHED):]) <= {"local_map", "fusion"}

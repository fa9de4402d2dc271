"""The parts of the stage runner (`supersurfel_fusion_tpu_torch/graphs.py`)
that do not need a card: the signature a graph is keyed by, the copies in
and out of a graph, and the eager runner the CPU and the sharded step
use. The graphs themselves are held to the op-by-op step in
`test_torch_graphs_cuda.py`."""

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import graphs, pipeline, synthetic, tracing
from supersurfel_fusion_tpu_torch.config import PipelineConfig, TPSConfig
from supersurfel_fusion_tpu_torch.types import Pose

from test_torch_pipeline import small_config

torch.set_num_threads(1)


def test_signature_keys_layout_and_values():
    """Tensors are keyed by shape, strides and dtype, not by contents or
    place; other values by type and value (equal configurations give one
    signature); the stage, its function and the structure count too. The
    leaves come out in order and rebuild the arguments."""
    def fn(*a):
        return a

    def sig(*args, name="s", f=fn):
        return graphs.signature(name, f, args)[0]

    a, b = torch.zeros(2, 3), torch.ones(2, 3)
    base = sig(Pose(a, a[0]), [1, None], PipelineConfig())
    assert sig(Pose(b, b[1]), [1, None], PipelineConfig()) == base
    for other in (sig(Pose(a.T, a[0]), [1, None], PipelineConfig()),
                  sig(Pose(a.int(), a[0]), [1, None], PipelineConfig()),
                  sig(Pose(a[:1], a[0]), [1, None], PipelineConfig()),
                  sig(Pose(a, a[0]), [1.0, None], PipelineConfig()),
                  sig(Pose(a, a[0]), [1, None],
                      PipelineConfig(tps=TPSConfig(nb_samples=32))),
                  sig((a, a[0]), [1, None], PipelineConfig()),
                  sig(Pose(a, a[0]), [1, None], PipelineConfig(), name="t"),
                  sig(Pose(a, a[0]), [1, None], PipelineConfig(),
                      f=lambda *x: x)):
        assert other != base
    hash(base)
    cfg = PipelineConfig()
    _, leaves, spec = graphs.signature("s", fn, (Pose(a, b), [3, None], cfg))
    assert leaves[0] is a and leaves[1] is b and cfg in leaves
    back = pytree.tree_unflatten(leaves, spec)
    assert type(back[0]) is Pose and back[0].R is a
    assert back[1] == [3, None] and back[2] is cfg


def test_outputs_are_fresh_copies():
    """What a graph returns is copied out of its buffers, one copy per
    tensor object, with the buffer's strides (an expanded tensor
    contiguous); other values pass as they are. `copy_all` copies pairs of
    any dtype and layout."""
    buf = torch.arange(6.0)
    view, wide = buf[1::2], buf[:1].expand(4)
    n = torch.tensor([7], dtype=torch.int32)
    g = graphs._Graph()
    g.out, g.out_spec = pytree.tree_flatten(((Pose(view, n), view, wide, 3),
                                             "x"))
    g.tensors, g.where = [view, n, wide], [0, 1, 0, 2, None, None]
    (pose, v2, w2, three), x = g.outputs()
    assert type(pose) is Pose and pose.R is v2 and three == 3 and x == "x"
    assert torch.equal(v2, view) and v2.stride() == (2,)
    assert torch.equal(pose.t, n) and pose.t is not n
    assert torch.equal(w2, wide) and w2.stride() == (1,)
    buf.zero_()
    n.zero_()
    assert torch.equal(v2, torch.tensor([1.0, 3.0, 5.0]))
    assert int(pose.t) == 7 and torch.equal(w2, torch.zeros(4))
    src = [torch.arange(4.0), torch.arange(3), torch.ones(2, 3).T,
           torch.tensor([True, False]), torch.arange(5).to(torch.uint16)]
    dst = [torch.empty(4), torch.empty(3, dtype=torch.int64),
           torch.empty(3, 2), torch.empty(2, dtype=torch.bool),
           torch.empty(5, dtype=torch.uint16)]
    graphs.copy_all(dst, src)
    assert all(torch.equal(d, s) for d, s in zip(dst, src))


def test_eager_runner_outside_a_step(monkeypatch):
    """Outside a runner's step every stage runs op by op inside its
    recorder stage, counted as eager; a step's runner is left on exit,
    also when the step raises."""
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    calls = []
    with tracing.frame():
        assert graphs.stage("depth", lambda a, b: calls.append(a + b) or 9,
                            1, 2) == 9
    assert calls == [3]
    [f] = tracing.frames()
    assert [n for n, *_ in f.spans] == ["frame", "ssf.depth"]
    assert f.counts == {"stage.eager": 1}
    runner = graphs.StageGraphs(torch.device("cpu"))
    try:
        with runner.step():
            assert graphs._current is runner
            raise KeyError
    except KeyError:
        pass
    assert graphs._current is None


def test_every_stage_goes_through_the_runner(monkeypatch):
    """With ferns and loop closure on, each `ssf.*` span of two frame
    steps is a stage `graphs.stage` was given, in order: no stage opens
    its span and range by hand."""
    cfg = small_config(tcfg, enable_loop_closure=True,
                       ferns=tcfg.FernsConfig(enabled=True, max_keyframes=16,
                                              min_frame_gap=1))
    given, stage = [], graphs.stage

    def recording(name, fn, *args):
        given.append(name)
        return stage(name, fn, *args)

    monkeypatch.setattr(graphs, "stage", recording)
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    state = pipeline.init_state(cfg, "cpu")
    for rgb, depth, *_ in synthetic.frames(cfg.cam, 2):
        state, out = pipeline.process_frame(state, rgb, depth, cfg)
    assert out.lc_gate is False
    assert [n[4:] for f in tracing.frames() for n, *_ in f.spans
            if n.startswith("ssf.")] == given
    assert (given.count("ferns"), given.count("loop_closure")) == (4, 2)


def test_part_runs_op_by_op_in_its_span(monkeypatch):
    """Outside a runner's step a part (`graphs.part`) is `fn(*args)` op
    by op inside its recorder span, counted as a part run eagerly, and an
    op between parts is counted as such; inside a stage neither opens a
    profiler range, so the profiler sees the stage's `ssf.*` range alone.
    Under a runner a part's first call with its signature runs the same
    way (the capture, on the second, needs a card)."""
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    calls = []

    def stage_fn(x):
        y = graphs.part("s.a", lambda v: calls.append(v) or v + 1, x)
        with tracing.eager_op("s.op"):
            y = y * 2
        return graphs.part("s.b", torch.sub, y, 1)

    x = torch.ones(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.frame():
            out = graphs.stage("s", stage_fn, x)
    assert torch.equal(out, torch.full((2,), 3.0)) and calls == [x]
    [f] = tracing.frames()
    assert [(n, f.spans[p][0]) for n, p, *_ in f.spans[1:]] == [
        ("ssf.s", "frame"), ("s.a", "ssf.s"), ("s.op", "ssf.s"),
        ("s.b", "ssf.s")]
    assert f.counts == {"stage.eager": 1, "part.eager": 2, "eager_op": 1}
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert "ssf.s" in names and not names & {"s.a", "s.op", "s.b",
                                              "ssf.s.a", "ssf.s.b"}
    runner = graphs.StageGraphs(torch.device("cpu"))
    with runner.step(), tracing.frame():
        assert torch.equal(graphs.part("s.b", torch.sub, x, 1),
                           torch.zeros(2))
        assert graphs.stage("mod", torch.neg, x).eq(-1).all()
    [_, f] = tracing.frames()
    assert [n for n, *_ in f.spans] == ["frame", "s.b", "ssf.mod"]
    assert f.counts == {"part.eager": 1, "stage.eager": 1}
    assert len(runner.warm) == 1

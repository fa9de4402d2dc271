"""The span recorder on a CUDA card: the frame step with the recorder on
makes no host wait, so the recorder makes no CUDA call and reads no
device value; on a frame whose loop-closure gate fires, the `lc.gate`
counter and the closure's part spans add no wait to those the step makes
there. Skipped without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

import warnings

import pytest
import torch

from slam_bench.tests.lc_gate import lc_config, lc_gate_frame
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import synthetic, tracing
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.pipeline import (
    SupersurfelFusion,
    process_frame,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_recorded_frames_make_no_host_wait(cuda):
    """Six frames of bench's fr1 configuration (the default
    PipelineConfig at 640x480) after two warm-up frames (kernel build,
    first-use library set-up, the stages' capture as CUDA graphs), under
    `set_sync_debug_mode("error")`: three through `SupersurfelFusion`,
    every stage replayed, its span recorded around the replay and its
    parts not (their Python does not run); then three through
    `process_frame` op by op from its state, with the stages' parts."""
    cfg = PipelineConfig()
    clip = synthetic.frames(cfg.cam, 8)
    sf = SupersurfelFusion(cfg, device=cuda)
    for rgb, depth, *_ in clip[:2]:
        sf.process(rgb, depth)
    torch.cuda.synchronize()
    first = tracing.RECORDER.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        for rgb, depth, *_ in clip[2:5]:
            sf.process(rgb, depth)
        state = sf.state
        for rgb, depth, *_ in clip[5:]:
            state, _ = process_frame(state, rgb, depth, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    frames = tracing.frames(first)
    assert [f.number for f in frames] == list(range(first, first + 6))
    stages = ["depth", "tps", "planes", "supersurfels", "features", "vo",
              "icp", "local_map", "fusion"]
    for f in frames[:3]:
        assert [n for n, *_ in f.spans] == ["frame"] + [
            "ssf." + s for s in stages]
        assert (f.replays, f.eager) == (len(stages), 0)
    for f in frames[3:]:
        names = [n for n, *_ in f.spans]
        assert names.count("features.describe") == cfg.vo.nb_levels
        assert {"ssf.tps", "tps.rgbd", "icp.iterate", "fusion.filter"} \
            <= set(names)
        assert (f.replays, f.eager) == (0, len(stages))


def _host_waits(step) -> int:
    """Host waits of one call of step(), counted by CUDA sync debugging."""
    n = 0

    def record(message, *a, **k):
        nonlocal n
        n += "synchroniz" in str(message)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return n


@pytest.mark.cuda
def test_gate_frame_counter_and_spans_add_no_host_wait(cuda):
    """`slam_bench/tests/lc_gate.py:lc_gate_frame` on the card, op by op
    from the same state, with the recorder on and off: the same count of
    host waits (the gate's read and the closure's SVD waits), so the
    `lc.gate` counter and the `lc.*` spans add none; with the recorder
    on, the frame carries them."""
    cfg = lc_config(tcfg)
    pre, rgb, depth = lc_gate_frame(cfg, cuda)
    out = process_frame(pre, rgb, depth, cfg)[1]   # first-use set-up
    assert out.lc_gate is True and bool(out.lc_accepted)
    first = tracing.RECORDER.count
    on = _host_waits(lambda: process_frame(pre, rgb, depth, cfg))
    tracing.enable(False)
    try:
        off = _host_waits(lambda: process_frame(pre, rgb, depth, cfg))
    finally:
        tracing.enable(True)
    assert on == off and on >= 1, (on, off)
    (f,) = tracing.frames(first)
    assert f.counts == {"lc.gate": 1}
    assert [n for n, *_ in f.spans if n.startswith("lc.")] == [
        "lc.relocalise", "lc.align", "lc.deform"]

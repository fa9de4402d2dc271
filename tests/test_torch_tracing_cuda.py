"""The span recorder on a CUDA card: the frame step with the recorder on
makes no host wait, so the recorder makes no CUDA call and reads no
device value. Skipped without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

import pytest
import torch

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

"""The span recorder on a CUDA card: the frame step with the recorder on
makes no host wait, so the recorder makes no CUDA call and reads no
device value. Skipped without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

import pytest
import torch

from supersurfel_fusion_tpu_torch import synthetic, tracing
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_recorded_frames_make_no_host_wait(cuda):
    """Three frames of bench's fr1 configuration (the default
    PipelineConfig at 640x480) after two warm-up frames (kernel build,
    first-use library set-up), under `set_sync_debug_mode("error")`."""
    cfg = PipelineConfig()
    clip = synthetic.frames(cfg.cam, 5)
    sf = SupersurfelFusion(cfg, device=cuda)
    for rgb, depth, *_ in clip[:2]:
        sf.process(rgb, depth)
    torch.cuda.synchronize()
    first = tracing.RECORDER.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        for rgb, depth, *_ in clip[2:]:
            sf.process(rgb, depth)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    frames = tracing.frames(first)
    assert [f.number for f in frames] == [first, first + 1, first + 2]
    for f in frames:
        names = [n for n, *_ in f.spans]
        assert names.count("features.describe") == cfg.vo.nb_levels
        assert {"ssf.tps", "tps.rgbd", "icp.iterate", "fusion.filter"} \
            <= set(names)

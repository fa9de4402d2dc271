"""The TPS CUDA kernels against their plain PyTorch versions, on a card.

These tests import neither JAX nor the JAX package, so they also run where
JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_tps_cuda.py

Without a CUDA device they skip (the kernels have no CPU mode); the nvcc
lookup test runs everywhere."""

import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.config import (
    CameraIntrinsics,
    PipelineConfig,
    TPSConfig,
)
from supersurfel_fusion_tpu_torch.ops import tps as tps_ref
from supersurfel_fusion_tpu_torch.ops import tps_cuda
from supersurfel_fusion_tpu_torch.ops.depth import (
    bilateral_filter,
    depth_to_disp,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TPS kernels have no CPU mode")
    return torch.device("cuda")


def _camera(width, height):
    return CameraIntrinsics(fx=width * 0.82, fy=width * 0.82,
                            cx=width / 2 - 0.5, cy=height / 2 - 0.5,
                            width=width, height=height)


def _frame(cam, k=3, device="cpu"):
    rgb, depth = synthetic.render(cam, *synthetic.trajectory(k + 1)[k])
    rgb = torch.from_numpy(rgb).to(device).float()
    d = torch.from_numpy(depth).to(device).float() / 5000.0
    return rgb, depth_to_disp(bilateral_filter(d)).contiguous()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tps_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tps_cuda._find_nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("width,height", [(128, 64), (640, 480)])
def test_segment_kernels_match_plain_versions(width, height):
    dev = _card()
    rgb, disp = _frame(_camera(width, height), device=dev)
    cfg = TPSConfig()
    tps_cuda.reset_launch_counts()
    k = tps_cuda.segment(rgb, disp, cfg)
    assert tps_cuda.launch_counts == {"tps_iteration": 10, "tps_merge": 12}
    p = tps_cuda.segment_reference(rgb, disp, cfg)
    assert (k.labels == p.labels).float().mean().item() >= 0.99
    assert float(k.stats.size.sum()) == width * height
    both = torch.isfinite(k.stats.theta[..., 2]) & torch.isfinite(
        p.stats.theta[..., 2])
    assert both.float().mean().item() > 0.9
    assert (k.stats.theta[both] - p.stats.theta[both]).abs().median() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("use_disp", [False, True])
@pytest.mark.parametrize("width,height,cs", [
    (128, 64, 16), (640, 480, 16), (176, 144, 16), (128, 64, 8),
    (176, 144, 8)])
def test_phase_and_merge_match_plain_versions(width, height, cs, use_disp):
    """tps_iteration against four phases of the plain version, tps_merge
    against the plain merge; 176x144 is divided by no iteration tile, and
    cell size 8 is not the default 16."""
    dev = _card()
    cfg = TPSConfig(cell_size=cs)
    rgb, disp = _frame(_camera(width, height), device=dev)
    H, W = height, width
    rgb_chw = rgb.permute(2, 0, 1).contiguous()
    labels = tps_ref.grid_labels(H, W, cs, dev).contiguous()
    inliers = torch.isfinite(disp).float()
    table = torch.zeros((9, H // cs, W // cs), device=dev)
    labels, inliers, table = tps_cuda.run_iterations_reference(
        rgb_chw, disp, labels, inliers, table, 2, use_disp, cfg)
    lk, ik = tps_cuda.tps_iteration(rgb_chw, disp, labels, inliers, table,
                                    use_disp, cfg)
    lp, ip = tps_cuda.iteration_reference(rgb_chw, disp, labels, inliers,
                                          table, use_disp, cfg)
    # same arithmetic in the same order, no fma: exact
    assert torch.equal(lk, lp) and torch.equal(ik, ip)
    assert not torch.equal(lp, labels)
    mk = tps_cuda.tps_merge(rgb_chw, disp, labels, inliers, table, use_disp,
                            cs)
    mp = tps_cuda.merge_reference(rgb_chw, disp, labels, inliers, table,
                                  use_disp, cs)
    # f32 sums of <= 2304 pixels in another order
    torch.testing.assert_close(mk[:6], mp[:6], rtol=1e-5, atol=1e-3)
    if not use_disp:
        assert torch.equal(mk[6:], table[6:])


@pytest.mark.cuda
def test_wrappers_refuse_bad_input():
    dev = _card()
    cfg = TPSConfig()
    rgb_chw = torch.zeros((3, 64, 128), device=dev)
    disp = torch.ones((64, 128), device=dev)
    labels = torch.zeros((64, 128), dtype=torch.int64, device=dev)
    inliers = torch.zeros((64, 128), device=dev)
    table = torch.zeros((9, 4, 8), device=dev)
    with pytest.raises(ValueError, match="labels"):
        tps_cuda.tps_iteration(rgb_chw, disp, labels, inliers, table, False,
                               cfg)
    with pytest.raises(ValueError, match="inliers"):
        tps_cuda.tps_iteration(rgb_chw, disp, labels.int(),
                               inliers.double(), table, True, cfg)
    with pytest.raises(ValueError, match="aligned"):
        tps_cuda.tps_merge(rgb_chw, torch.ones(64 * 128 + 1, device=dev)[1:]
                           .view(64, 128), labels.int(), inliers, table,
                           True, 16)
    with pytest.raises(ValueError, match="table"):
        tps_cuda.tps_merge(rgb_chw, disp, labels.int(), inliers,
                           table[:, :2], False, 16)


@pytest.mark.cuda
def test_card_pipeline_matches_cpu_pipeline():
    dev = _card()
    cfg = PipelineConfig(
        cam=CameraIntrinsics(fx=200.0, fy=200.0, cx=127.5, cy=95.5,
                             width=256, height=192))
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    gpu = SupersurfelFusion(cfg, device=dev)
    cpu = SupersurfelFusion(cfg, device="cpu")
    for k, (rgb, depth, _) in enumerate(synthetic.frames(cfg.cam, 3)):
        og = gpu.process(rgb, depth, float(k))
        oc = cpu.process(rgb, depth, float(k))
        assert bool(og.icp_valid) == bool(oc.icp_valid)
    tg, tc = np.array(gpu.trajectory), np.array(cpu.trajectory)
    assert np.abs(tg[:, :3] - tc[:, :3]).max() < 2e-3

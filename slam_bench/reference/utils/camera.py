# Frozen copy of supersurfel_fusion_tpu_torch/utils/camera.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Pinhole camera helpers (batched)."""

from __future__ import annotations

import torch

from slam_bench.reference.config import CameraIntrinsics

Tensor = torch.Tensor


def backproject(u: Tensor, v: Tensor, depth: Tensor,
                cam: CameraIntrinsics) -> Tensor:
    """Pixel (u, v) + depth (metres) -> camera-frame 3D point (..., 3)."""
    x = (u - cam.cx) * depth / cam.fx
    y = (v - cam.cy) * depth / cam.fy
    return torch.stack([x, y, depth], dim=-1)

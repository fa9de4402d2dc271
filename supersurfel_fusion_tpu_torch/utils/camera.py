"""Pinhole camera helpers (batched)."""

from __future__ import annotations

import torch

from supersurfel_fusion_tpu_torch.config import CameraIntrinsics

Tensor = torch.Tensor


def backproject(u: Tensor, v: Tensor, depth: Tensor,
                cam: CameraIntrinsics) -> Tensor:
    """Pixel (u, v) + depth (metres) -> camera-frame 3D point (..., 3)."""
    x = (u - cam.cx) * depth / cam.fx
    y = (v - cam.cy) * depth / cam.fy
    return torch.stack([x, y, depth], dim=-1)

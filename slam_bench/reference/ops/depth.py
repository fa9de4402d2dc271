# Frozen copy of supersurfel_fusion_tpu_torch/ops/depth.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Depth preprocessing: bilateral filter and disparity conversion.

Port of `supersurfel_fusion_tpu/ops/depth.py`, which replaces
`cv::cuda::bilateralFilter(depth, -1, 0.03, 4.5)` and the `depth2disp*`
kernels of the reference. The bilateral filter is a static stencil of shifted
adds, in the same order as the JAX version.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def bilateral_filter(depth: Tensor, sigma_value: float = 0.03,
                     sigma_space: float = 4.5, radius: int = 6) -> Tensor:
    """Edge-preserving depth smoothing. Invalid (0) depths contribute no
    weight to valid neighbours and stay 0 themselves."""
    inv2_sv = 0.5 / (sigma_value * sigma_value)
    inv2_ss = 0.5 / (sigma_space * sigma_space)

    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sw = math.exp(-(dy * dy + dx * dx) * inv2_ss)
            if sw < 1e-4:
                continue
            shifted = shift2d(depth, dy, dx, fill=0.0)
            diff = shifted - depth
            w = sw * torch.exp(-(diff * diff) * inv2_sv)
            w = torch.where(shifted > 0.0, w, torch.zeros_like(w))
            acc = acc + w * shifted
            wacc = wacc + w
    out = acc / torch.clamp(wacc, min=1e-12)
    return torch.where((depth > 0.0) & (wacc > 1e-6), out,
                       torch.zeros_like(out))


def depth_to_disp(depth: Tensor) -> Tensor:
    """depth (m) -> disparity 1/depth; invalid depth (<= 0) -> +inf."""
    return torch.where(depth > 0.0, 1.0 / torch.clamp(depth, min=1e-12),
                       torch.full_like(depth, math.inf))


def shift2d(img: Tensor, dy: int, dx: int, fill=0.0) -> Tensor:
    """out[y, x] = img[y + dy, x + dx], `fill` outside (static shifts)."""
    H, W = img.shape[0], img.shape[1]
    out = torch.full_like(img, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    ys, yd = (slice(dy, H), slice(0, H - dy)) if dy >= 0 else \
        (slice(0, H + dy), slice(-dy, H))
    xs, xd = (slice(dx, W), slice(0, W - dx)) if dx >= 0 else \
        (slice(0, W + dx), slice(-dx, W))
    out[yd, xd] = img[ys, xs]
    return out

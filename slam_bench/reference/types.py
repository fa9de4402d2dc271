# Frozen copy of supersurfel_fusion_tpu_torch/types.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Core containers: the surfel SoA, the model state and the camera pose.

Mirrors `supersurfel_fusion_tpu/types.py`: a fixed-capacity
struct-of-arrays where validity is encoded in `confidences` (<= 0 means
invalid/dead), so every consumer is maskable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Supersurfels(NamedTuple):
    """SoA of oriented Gaussian-ellipse surfels. All tensors share leading
    dim N (static capacity)."""

    positions: Tensor     # (N, 3) float32, world or camera frame
    colors: Tensor        # (N, 3) float32 RGB 0..255
    stamps: Tensor        # (N, 2) int32 (birth, last-seen)
    orientations: Tensor  # (N, 3, 3) float32; rows = (major, minor, normal)
    shapes: Tensor        # (N, 3, 3) float32 covariance
    dims: Tensor          # (N, 2) float32 first two eigenvalues
    confidences: Tensor   # (N,) float32; <= 0 -> invalid

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def valid(self) -> Tensor:
        return self.confidences > 0.0

    @staticmethod
    def empty(n: int, device: str | torch.device) -> "Supersurfels":
        f32 = dict(dtype=torch.float32, device=device)
        return Supersurfels(
            positions=torch.zeros((n, 3), **f32),
            colors=torch.zeros((n, 3), **f32),
            stamps=torch.zeros((n, 2), dtype=torch.int32, device=device),
            orientations=torch.eye(3, **f32).repeat(n, 1, 1),
            shapes=torch.zeros((n, 3, 3), **f32),
            dims=torch.zeros((n, 2), **f32),
            confidences=torch.full((n,), -1.0, **f32),
        )

    def prefix(self, n: int) -> "Supersurfels":
        return Supersurfels(*(a[:n] for a in self))


class ModelState(NamedTuple):
    """Global map state carried across frames."""

    surfels: Supersurfels
    nb_supersurfels: Tensor   # () int32 — count of live slots (prefix)
    nb_visible: Tensor        # () int32 — active slots visible last frame


class Pose(NamedTuple):
    """Camera-to-world rigid transform."""

    R: Tensor   # (3, 3)
    t: Tensor   # (3,)

    @staticmethod
    def identity(device: str | torch.device) -> "Pose":
        return Pose(torch.eye(3, dtype=torch.float32, device=device),
                    torch.zeros(3, dtype=torch.float32, device=device))

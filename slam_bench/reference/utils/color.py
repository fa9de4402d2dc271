# Frozen copy of supersurfel_fusion_tpu_torch/utils/color.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""RGB <-> CIELab conversion (port of `supersurfel_fusion_tpu/utils/color.py`),
so that the Lab-distance gates (ICP < 20, fusion < 15) keep their meaning.
RGB in [0, 255], channels on the last axis."""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor

_XYZ_FROM_RGB = np.array(
    [
        [0.4124, 0.3575, 0.1805],
        [0.2126, 0.7152, 0.0722],
        [0.0193, 0.1192, 0.9505],
    ],
    dtype=np.float32,
)
_RGB_FROM_XYZ = np.array(
    [
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ],
    dtype=np.float32,
)
_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)
_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float32)


_CONSTS = {"xyz_from_rgb": _XYZ_FROM_RGB, "rgb_from_xyz": _RGB_FROM_XYZ,
           "white": _WHITE}


@functools.lru_cache(maxsize=None)
def _device_const(name: str, device: torch.device) -> Tensor:
    # uploaded once per device: a host-to-device copy per call would
    # synchronise the stream every time
    return torch.as_tensor(_CONSTS[name], device=device)


def _const(name: str, like: Tensor) -> Tensor:
    return _device_const(name, like.device)


def _srgb_to_linear(c: Tensor) -> Tensor:
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _linear_to_srgb(c: Tensor) -> Tensor:
    return torch.where(c > 0.0031308, 1.055 * c ** (1.0 / 2.4) - 0.055,
                       12.92 * c)


def _cbrt(t: Tensor) -> Tensor:
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


def _f(t: Tensor) -> Tensor:
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _finv(t: Tensor) -> Tensor:
    t3 = t**3
    return torch.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)


def rgb_to_lab(rgb: Tensor) -> Tensor:
    lin = _srgb_to_linear(rgb.to(torch.float32) / 255.0)
    xyz = torch.einsum("ij,...j->...i", _const("xyz_from_rgb", lin), lin)
    xyz = xyz / _const("white", lin)
    fx, fy, fz = _f(xyz[..., 0]), _f(xyz[..., 1]), _f(xyz[..., 2])
    return torch.stack(
        [116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab_to_rgb(lab: Tensor) -> Tensor:
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = lab[..., 1] / 500.0 + fy
    fz = fy - lab[..., 2] / 200.0
    xyz = torch.stack([_finv(fx), _finv(fy), _finv(fz)], dim=-1)
    xyz = xyz * _const("white", lab)
    lin = torch.einsum("ij,...j->...i", _const("rgb_from_xyz", lab), xyz)
    return torch.clamp(_linear_to_srgb(lin), 0.0, 1.0) * 255.0


def rgb_to_gray(rgb: Tensor) -> Tensor:
    """Luma matching OpenCV's RGB2GRAY (used for feature extraction).

    Evaluated as the fused multiply-add chain fma(b, wb, fma(g, wg, r*wr))
    that the JAX package's f32 contraction gives, each fma emulated exactly
    in f64, so keypoint selection sees the same grey image bit for bit."""
    x = rgb.to(torch.float32)
    wr, wg, wb = (float(w) for w in _GRAY)
    acc = (x[..., 0] * np.float32(wr)).to(torch.float64)
    acc = (x[..., 1].to(torch.float64) * wg + acc).to(torch.float32)
    acc = (x[..., 2].to(torch.float64) * wb + acc.to(torch.float64))
    return acc.to(torch.float32)

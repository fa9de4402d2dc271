# Frozen copy of supersurfel_fusion_tpu_torch/ops/supersurfels.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Supersurfel generation: lift each superpixel to an oriented Gaussian
ellipse surfel.

Port of `supersurfel_fusion_tpu/ops/supersurfels.py` (itself a rewrite of
`computeSupersurfelCoeffs` + `computeSupersurfels`): the per-pixel moments
are summed by the cell-blocked reduction of ops/tps.py, relative to a
per-superpixel anchor point (which keeps the f32 covariance free of
cancellation), and each covariance is decomposed by the batched `eigh3x3`.
"""

from __future__ import annotations

import torch

from slam_bench.reference.config import (
    CameraIntrinsics,
    GenerationConfig,
    TPSConfig,
)
from slam_bench.reference.ops.tps import (
    TPSResult,
    _cell_centers,
    _iota,
    _rel_code,
    cell_reduce,
    lookup_cells,
)
from slam_bench.reference.types import Supersurfels
from slam_bench.reference.utils.camera import backproject
from slam_bench.reference.utils.color import lab_to_rgb, rgb_to_lab
from slam_bench.reference.utils.geometry import eigh3x3, outer3

Tensor = torch.Tensor


def generate_supersurfels(
    rgb: Tensor,
    plane_depth: Tensor,
    tps: TPSResult,
    cam: CameraIntrinsics,
    tps_cfg: TPSConfig,
    gen_cfg: GenerationConfig,
    z_min: float,
    z_max: float,
    stamp: Tensor,
) -> Supersurfels:
    """Build the frame's supersurfels (camera frame). Pixels contribute iff
    they are plane inliers with finite positive plane depth off the
    superpixel boundary; a superpixel is valid with > min_pixels pixels,
    mean z in (z_min, z_max) and elongation <= max_elongation."""
    H, W = plane_depth.shape
    dev = plane_depth.device
    cs = tps_cfg.cell_size
    gh, gw = H // cs, W // cs
    n_sp = gh * gw

    y, x = _iota(H, W, dev, torch.float32)
    good = (tps.inliers & torch.isfinite(plane_depth) & (plane_depth > 0.0)
            & (tps.boundary == 0))
    w = good.to(torch.float32)
    d = torch.where(good, plane_depth, torch.zeros_like(plane_depth))

    pos = backproject(x, y, d, cam)                            # (H, W, 3)

    cx0, cy0 = _cell_centers(gh, gw, cs, dev)
    theta = torch.nan_to_num(tps.stats.theta, nan=0.0, posinf=0.0,
                             neginf=0.0)
    disp0 = theta[..., 0] * cx0 + theta[..., 1] * cy0 + theta[..., 2]
    z0 = torch.where(disp0 > 1e-6, 1.0 / torch.clamp(disp0, min=1e-6),
                     torch.zeros_like(disp0))
    anchor = torch.stack(
        [(cx0 - cam.cx) * z0 / cam.fx, (cy0 - cam.cy) * z0 / cam.fy, z0],
        dim=-1)                                                # (GH, GW, 3)

    code = _rel_code(tps.labels, gh, gw, cs)
    anchor_px = lookup_cells(anchor, code, gh, gw, cs)         # (H, W, 3)

    g3 = good[..., None]
    rel = torch.where(g3, pos - anchor_px, torch.zeros_like(pos))
    lab = rgb_to_lab(rgb)
    lab = torch.where(g3, lab, torch.zeros_like(lab))

    feats = torch.cat(
        [
            w[..., None],
            rel,
            lab,
            torch.stack(
                [
                    rel[..., 0] * rel[..., 0],
                    rel[..., 0] * rel[..., 1],
                    rel[..., 0] * rel[..., 2],
                    rel[..., 1] * rel[..., 1],
                    rel[..., 1] * rel[..., 2],
                    rel[..., 2] * rel[..., 2],
                ],
                dim=-1,
            ),
        ],
        dim=-1,
    )
    sums = cell_reduce(feats, tps.labels, gh, gw, cs)          # (GH, GW, 13)

    n = sums[..., 0]
    safe_n = torch.clamp(n, min=1.0)
    mean_rel = sums[..., 1:4] / safe_n[..., None]
    mean_lab = sums[..., 4:7] / safe_n[..., None]
    s = sums[..., 7:13]
    m2 = torch.stack(
        [
            torch.stack([s[..., 0], s[..., 1], s[..., 2]], dim=-1),
            torch.stack([s[..., 1], s[..., 3], s[..., 4]], dim=-1),
            torch.stack([s[..., 2], s[..., 4], s[..., 5]], dim=-1),
        ],
        dim=-2,
    ) / safe_n[..., None, None]
    cov = m2 - outer3(mean_rel)
    mean_pos = anchor + mean_rel

    vecs, vals = eigh3x3(cov.reshape(-1, 3, 3))
    vecs = vecs.reshape(gh, gw, 3, 3)
    vals = vals.reshape(gh, gw, 3)

    z = mean_pos[..., 2]
    v1 = vals[..., 1]
    elong = vals[..., 0] / torch.where(torch.abs(v1) > 1e-20, v1,
                                       torch.full_like(v1, 1e-20))
    ok = (torch.isfinite(z) & (n > gen_cfg.min_pixels) & (z > z_min)
          & (z < z_max) & (elong <= gen_cfg.max_elongation))

    conf = torch.where(ok, n, torch.full_like(n, -1.0))
    color = lab_to_rgb(mean_lab)
    stamps = torch.as_tensor(stamp, dtype=torch.int32, device=dev).expand(
        n_sp, 2).contiguous()

    return Supersurfels(
        positions=mean_pos.reshape(n_sp, 3),
        colors=color.reshape(n_sp, 3),
        stamps=stamps,
        orientations=vecs.reshape(n_sp, 3, 3),
        shapes=cov.reshape(n_sp, 3, 3),
        dims=vals[..., :2].reshape(n_sp, 2),
        confidences=conf.reshape(n_sp),
    )

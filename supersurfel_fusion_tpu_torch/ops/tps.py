"""TPS (Texture-, Plane- and Size-aware) superpixel segmentation, plain
PyTorch.

Port of `supersurfel_fusion_tpu/ops/tps.py`. This module is the CPU path of
the segmentation and the oracle of the CUDA kernels in `ops/tps_cuda.py`.
The algorithm is the same: a 4-phase checkerboard label update over the
whole image, labels constrained to the 3x3 cell neighbourhood of each
pixel's grid cell, per-superpixel statistics recomputed by a cell-blocked
one-hot contraction, plane-fit moments in label-cell-centred coordinates,
RANSAC plane init from a fixed offset table and a Jacobi plane smoothing.

Energy model (same terms/weights as updateTPSRGBD_kernel):
  E = |color - mean_c|^2 + l_pos |pos - centroid|^2 + l_disp * clamp((d - theta.p)^2)
      - l_size * min(size - min_size, 0) + l_bound * boundary_count
with the n/(n-1) leave-one-out factor for the pixel's own superpixel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from supersurfel_fusion_tpu_torch import tracing
from supersurfel_fusion_tpu_torch.config import TPSConfig
from supersurfel_fusion_tpu_torch.ops.depth import shift2d
from supersurfel_fusion_tpu_torch.utils import prng
from supersurfel_fusion_tpu_torch.utils.geometry import inv3x3_sym, solve3x3

Tensor = torch.Tensor

# 3x3 cell-neighbourhood offsets indexed by code k = (dy+1)*3 + (dx+1)
_OFFS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

# checkerboard phase schedule (OFFSET_X, OFFSET_Y), in the reference's order
_PHASES = [(0, 0), (1, 1), (0, 1), (1, 0)]

# 4-neighbour offsets in the reference's candidate order: up, left, right, down
_NEIGH4 = [(-1, 0), (0, -1), (0, 1), (1, 0)]

def ransac_offsets(cs: int, nb_samples: int) -> np.ndarray:
    """(nb_samples, 3, 2) f32 offsets in [-cs/2, cs/2): the JAX package's
    `jax.random.uniform(PRNGKey(1234), (S, 3, 2), -cs/2, cs/2)` draw."""
    return prng.uniform(prng.PRNGKey(1234), (nb_samples, 3, 2),
                        -cs / 2.0, cs / 2.0)


@functools.lru_cache(maxsize=None)
def _ransac_offsets_on(cs: int, nb_samples: int, device: torch.device):
    return torch.as_tensor(ransac_offsets(cs, nb_samples), device=device)


class SuperpixelStats(NamedTuple):
    """Per-superpixel statistics on the (GH, GW) grid."""

    centroid: Tensor    # (GH, GW, 2) mean pixel (x, y), absolute coords
    color: Tensor       # (GH, GW, 3) mean color (0..255)
    size: Tensor        # (GH, GW) pixel count
    theta: Tensor       # (GH, GW, 3) disparity plane d = a*x + b*y + c


class TPSResult(NamedTuple):
    labels: Tensor      # (H, W) int32 superpixel index = gy * GW + gx
    boundary: Tensor    # (H, W) int32 count of 4-neighbours with another label
    inliers: Tensor     # (H, W) bool disparity-plane inlier
    stats: SuperpixelStats
    disp: Tensor        # (H, W) disparity used (1/filtered depth)


def _iota(H: int, W: int, device, dtype):
    y = torch.arange(H, dtype=dtype, device=device)[:, None].expand(H, W)
    x = torch.arange(W, dtype=dtype, device=device)[None, :].expand(H, W)
    return y, x


# ---------------------------------------------------------------------------
# Cell-blocked reductions and lookups
# ---------------------------------------------------------------------------


def _rel_code(labels: Tensor, gh: int, gw: int, cs: int) -> Tensor:
    """Relative 3x3 code of each pixel's label w.r.t. its own grid cell."""
    H, W = labels.shape
    y, x = _iota(H, W, labels.device, torch.int32)
    py, px = y // cs, x // cs
    gy, gx = labels // gw, labels % gw
    return (gy - py + 1) * 3 + (gx - px + 1)


def cell_reduce(features: Tensor, labels: Tensor, gh: int, gw: int,
                cs: int) -> Tensor:
    """Sum per-pixel feature vectors into their label's cell:
    (H, W, F) -> (GH, GW, F), by a one-hot contraction per (cell, code)
    and the 9 shifted partials (deterministic, no atomics)."""
    H, W, F = features.shape
    code = _rel_code(labels, gh, gw, cs)
    ks = torch.arange(9, device=labels.device, dtype=code.dtype)
    onehot = (code[..., None] == ks).to(features.dtype)
    fc = features.reshape(gh, cs, gw, cs, F)
    oc = onehot.reshape(gh, cs, gw, cs, 9)
    partial = torch.einsum("yaxbk,yaxbf->yxkf", oc, fc)  # (GH, GW, 9, F)
    out = torch.zeros((gh, gw, F), dtype=features.dtype,
                      device=features.device)
    for k, (dy, dx) in enumerate(_OFFS):
        out = out + shift2d(partial[:, :, k, :], -dy, -dx, fill=0.0)
    return out


def lookup_cells(table: Tensor, code: Tensor, gh: int, gw: int,
                 cs: int) -> Tensor:
    """Per-pixel lookup of a (GH, GW, F) table at cell = pixel cell +
    offs(code); codes outside [0, 9) or cells outside the grid read 0.
    NaN/inf entries read as 0 (a zero plane fails the `dp > 0` gate). The
    JAX package writes this as a one-hot contraction, which selects the
    same value exactly; here it is a gather."""
    H, W = code.shape
    F = table.shape[-1]
    table = torch.nan_to_num(table, nan=0.0, posinf=0.0, neginf=0.0)
    y, x = _iota(H, W, code.device, torch.int64)
    code = code.to(torch.int64)
    cy = y // cs + code // 3 - 1
    cx = x // cs + code % 3 - 1
    ok = (code >= 0) & (code < 9) & (cy >= 0) & (cy < gh) & (cx >= 0) \
        & (cx < gw)
    idx = torch.where(ok, cy * gw + cx, torch.zeros_like(cy))
    out = table.reshape(gh * gw, F)[idx]
    return torch.where(ok[..., None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# Statistics merge (replaces mergeTPSRGB(D)Coeffs_kernel)
# ---------------------------------------------------------------------------


def _cell_centers(gh: int, gw: int, cs: int, device):
    gy, gx = _iota(gh, gw, device, torch.float32)
    return gx * cs + (cs - 1) * 0.5, gy * cs + (cs - 1) * 0.5


def _merge_rgb(rgb: Tensor, labels: Tensor, gh: int, gw: int,
               cs: int) -> SuperpixelStats:
    """RGB merge: pixel count, absolute centroid and mean colour."""
    H, W, _ = rgb.shape
    y, x = _iota(H, W, rgb.device, torch.float32)
    ones = torch.ones((H, W), dtype=torch.float32, device=rgb.device)
    feats = torch.stack([x, y, rgb[..., 0], rgb[..., 1], rgb[..., 2], ones],
                        dim=-1)
    sums = cell_reduce(feats, labels, gh, gw, cs)
    n = sums[..., 5]
    safe_n = torch.clamp(n, min=1e-6)
    centroid = torch.stack([sums[..., 0] / safe_n, sums[..., 1] / safe_n],
                           dim=-1)
    color = sums[..., 2:5] / safe_n[..., None]
    theta = torch.zeros((gh, gw, 3), dtype=torch.float32, device=rgb.device)
    return SuperpixelStats(centroid, color, n, theta)


def fit_planes(disp: Tensor, labels: Tensor, inliers: Tensor,
               gh: int, gw: int, cs: int) -> Tensor:
    """LSQ disparity-plane fit per superpixel over inlier pixels, moments in
    label-cell-centred coordinates. Returns absolute-frame theta (GH, GW, 3);
    theta = (0, 0, nan) where the fit is singular."""
    H, W = disp.shape
    y, x = _iota(H, W, disp.device, torch.float32)
    gy_l = (labels // gw).to(torch.float32)
    gx_l = (labels % gw).to(torch.float32)
    xl = x - (gx_l * cs + (cs - 1) * 0.5)
    yl = y - (gy_l * cs + (cs - 1) * 0.5)
    w = inliers.to(torch.float32)
    d = torch.where(torch.isfinite(disp), disp, torch.zeros_like(disp))
    feats = torch.stack(
        [w, w * xl, w * yl, w * xl * xl, w * yl * yl, w * xl * yl,
         w * d, w * xl * d, w * yl * d],
        dim=-1,
    )
    sums = cell_reduce(feats, labels, gh, gw, cs)

    n_, sx, sy, sxx, syy, sxy, sd, sxd, syd = [sums[..., i] for i in range(9)]
    A = torch.stack(
        [
            torch.stack([sxx, sxy, sx], dim=-1),
            torch.stack([sxy, syy, sy], dim=-1),
            torch.stack([sx, sy, n_], dim=-1),
        ],
        dim=-2,
    )
    b = torch.stack([sxd, syd, sd], dim=-1)
    theta_local, ok = solve3x3(A, b, eps=1e-12)
    cx0, cy0 = _cell_centers(gh, gw, cs, disp.device)
    a_, b_ = theta_local[..., 0], theta_local[..., 1]
    c_abs = theta_local[..., 2] - a_ * cx0 - b_ * cy0
    theta = torch.stack([a_, b_, c_abs], dim=-1)
    bad = torch.stack([torch.zeros_like(c_abs), torch.zeros_like(c_abs),
                       torch.full_like(c_abs, float("nan"))], dim=-1)
    return torch.where(ok[..., None], theta, bad)


def eval_plane(theta_px: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """dp = a*x + b*y + c for per-pixel theta (H, W, 3)."""
    return theta_px[..., 0] * x + theta_px[..., 1] * y + theta_px[..., 2]


# ---------------------------------------------------------------------------
# Boundary / connectivity stencils
# ---------------------------------------------------------------------------


def boundary_count(labels: Tensor) -> Tensor:
    """#4-neighbours with a different label; out-of-image counts as
    different."""
    b = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    for dy, dx in _NEIGH4:
        nb = shift2d(labels, dy, dx, fill=-1)
        b = b + (nb != labels).to(torch.int32)
    return b


_RING = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]


def unchangeable(labels: Tensor) -> Tensor:
    """Connectivity guard: a pixel may not change label if the predicate
    (ring neighbour == own label) flips more than twice along the open
    8-ring (isUnchangeable, TPS_RGBD_kernels.cuh:178-233)."""
    eq = [shift2d(labels, dy, dx, fill=-1) == labels for dy, dx in _RING]
    jumps = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    for i in range(1, 8):
        jumps = jumps + (eq[i] != eq[i - 1]).to(torch.int32)
    return jumps > 2


# ---------------------------------------------------------------------------
# Label update (replaces updateTPSRGB(D)_kernel)
# ---------------------------------------------------------------------------


def _phase_mask(H: int, W: int, off_x: int, off_y: int, device) -> Tensor:
    """Active-pixel mask of one checkerboard phase: rows y%2==OFF_Y and
    columns with x%4 in {0,3} (OFF_X=0) or {1,2} (OFF_X=1)."""
    y, x = _iota(H, W, device, torch.int32)
    xm = x % 4
    col = (xm == 0) | (xm == 3) if off_x == 0 else (xm == 1) | (xm == 2)
    return (y % 2 == off_y) & col


def _candidate_energy(stat: Tensor, rgbv: Tensor, x: Tensor, y: Tensor,
                      disp: Tensor, cfg: TPSConfig, use_disp: bool,
                      own: bool, min_size: float):
    """Energy of assigning each pixel to the superpixel described by `stat`
    (fields: cx, cy, r, g, b, n, ta, tb, tc). Returns (E, inlier)."""
    cx, cy = stat[..., 0], stat[..., 1]
    mean_c = stat[..., 2:5]
    n = stat[..., 5]
    if own:
        s = n / torch.clamp(n - 1.0, min=1e-6)
        dsize = n - min_size
        dx_ = s * (x - cx)
        dy_ = s * (y - cy)
        dc = (rgbv - mean_c) * s[..., None]
    else:
        dsize = n + 1.0 - min_size
        dx_ = x - cx
        dy_ = y - cy
        dc = rgbv - mean_c
    E = (
        torch.sum(dc * dc, dim=-1)
        + cfg.lambda_pos * (dx_ * dx_ + dy_ * dy_)
        - cfg.lambda_size * torch.clamp(dsize, max=0.0)
    )
    inl = torch.ones(E.shape, dtype=torch.bool, device=E.device)
    if use_disp:
        dp = stat[..., 6] * x + stat[..., 7] * y + stat[..., 8]
        e = (dp - disp) ** 2
        inl = torch.isfinite(e) & (e <= cfg.thresh_disp) & (dp > 0.0)
        E = E + cfg.lambda_disp * torch.where(
            inl, e, torch.full_like(e, cfg.thresh_disp))
    return E, inl


def stat_table(stats: SuperpixelStats) -> Tensor:
    """(GH, GW, 9) = [cx, cy, r, g, b, n, ta, tb, tc]."""
    return torch.cat([stats.centroid, stats.color, stats.size[..., None],
                      stats.theta], dim=-1)


def stat_image(stats: SuperpixelStats, labels: Tensor, gh: int, gw: int,
               cs: int) -> Tensor:
    """Per-pixel stat vector of each pixel's label: (H, W, 9)."""
    return lookup_cells(stat_table(stats), _rel_code(labels, gh, gw, cs),
                        gh, gw, cs)


def phase_update(labels: Tensor, inliers: Tensor, own_stat: Tensor,
                 rgb: Tensor, disp: Tensor, phase: int, cfg: TPSConfig,
                 use_disp: bool, gh: int, gw: int):
    """One checkerboard phase of boundary-pixel label reassignment. A pixel
    that adopts a neighbour's label takes that candidate's stat vector.
    Returns (labels, inliers, own_stat)."""
    H, W, _ = rgb.shape
    dev = rgb.device
    cs = cfg.cell_size
    min_size = cs * cs / 4.0
    off_x, off_y = _PHASES[phase]

    y, x = _iota(H, W, dev, torch.float32)
    yi, xi = _iota(H, W, dev, torch.int32)
    py, px = yi // cs, xi // cs

    bounds = boundary_count(labels)
    frozen = unchangeable(labels)
    active = _phase_mask(H, W, off_x, off_y, dev) & (bounds > 0) & ~frozen

    E_best, inl_best = _candidate_energy(
        own_stat, rgb, x, y, disp, cfg, use_disp, own=True, min_size=min_size)
    E_best = E_best + cfg.lambda_bound * bounds.to(torch.float32)
    best_label = labels
    best_stat = own_stat

    neigh_labels = [shift2d(labels, dy, dx, fill=-1) for dy, dx in _NEIGH4]
    neigh_stats = [shift2d(own_stat, dy, dx, fill=0.0) for dy, dx in _NEIGH4]

    for nl, stat in zip(neigh_labels, neigh_stats):
        dyc = nl // gw - py + 1
        dxc = nl % gw - px + 1
        in_window = (dyc >= 0) & (dyc < 3) & (dxc >= 0) & (dxc < 3)
        valid = (nl >= 0) & (nl != labels) & in_window
        E, inl = _candidate_energy(
            stat, rgb, x, y, disp, cfg, use_disp, own=False,
            min_size=min_size)
        b = torch.zeros(labels.shape, dtype=torch.int32, device=dev)
        for nl2 in neigh_labels:
            b = b + (nl2 != nl).to(torch.int32)
        E = E + cfg.lambda_bound * b.to(torch.float32)
        take = active & valid & (E < E_best)
        E_best = torch.where(take, E, E_best)
        best_label = torch.where(take, nl, best_label)
        best_stat = torch.where(take[..., None], stat, best_stat)
        inl_best = torch.where(take, inl, inl_best)

    if use_disp:
        return best_label, inl_best, best_stat
    return best_label, inliers, best_stat


# ---------------------------------------------------------------------------
# RANSAC plane init (replaces initSamples/evalSamples/selectSamples_kernel)
# ---------------------------------------------------------------------------


def ransac_plane_init(disp: Tensor, labels: Tensor, stats: SuperpixelStats,
                      cfg: TPSConfig, gh: int, gw: int):
    """Robust per-superpixel disparity-plane hypotheses: `nb_samples` planes
    through 3 pixels from a fixed offset table around the centroid, scored by
    inlier count over the superpixel's pixels; the argmax wins.
    Returns (theta (GH, GW, 3), inliers (H, W))."""
    H, W = disp.shape
    dev = disp.device
    cs = cfg.cell_size
    S = cfg.nb_samples
    offs = _ransac_offsets_on(cs, S, dev)

    cx = stats.centroid[..., 0]
    cy = stats.centroid[..., 1]
    pxs = torch.clamp(torch.round(cx[..., None, None] + offs[:, :, 0]),
                      0, W - 1).to(torch.int64)          # (GH, GW, S, 3)
    pys = torch.clamp(torch.round(cy[..., None, None] + offs[:, :, 1]),
                      0, H - 1).to(torch.int64)

    d_s = disp[pys, pxs]
    l_s = labels[pys, pxs]
    gy, gx = _iota(gh, gw, dev, torch.int32)
    own = gy * gw + gx
    ok_pt = (l_s == own[..., None, None]) & torch.isfinite(d_s)

    X = torch.stack([pxs.to(torch.float32), pys.to(torch.float32),
                     torch.ones_like(d_s)], dim=-1)      # (GH, GW, S, 3, 3)
    dvec = torch.where(ok_pt, d_s, torch.full_like(d_s, float("nan")))
    theta_s, solved = solve3x3(
        X, torch.where(torch.isfinite(dvec), dvec, torch.zeros_like(dvec)))
    all_ok = torch.all(ok_pt, dim=-1)
    d3 = d_s[..., 2]
    d_fallback = torch.where(torch.isfinite(d3), d3, torch.zeros_like(d3))
    theta_fb = torch.stack([torch.zeros_like(d_fallback),
                            torch.zeros_like(d_fallback), d_fallback], dim=-1)
    theta_s = torch.where((solved & all_ok)[..., None], theta_s, theta_fb)

    y, x = _iota(H, W, dev, torch.float32)
    code = _rel_code(labels, gh, gw, cs)
    th_px = lookup_cells(theta_s.reshape(gh, gw, S * 3), code, gh, gw, cs)
    th_px = th_px.reshape(H, W, S, 3)
    dp = th_px[..., 0] * x[..., None] + th_px[..., 1] * y[..., None] \
        + th_px[..., 2]
    dd = (disp[..., None] - dp) ** 2
    votes = (torch.isfinite(dd) & (dd < cfg.thresh_disp)).to(torch.float32)
    scores = cell_reduce(votes, labels, gh, gw, cs)      # (GH, GW, S)

    best = torch.argmax(scores, dim=-1)
    theta = torch.gather(
        theta_s, 2, best[..., None, None].expand(gh, gw, 1, 3))[:, :, 0, :]

    th_sel = lookup_cells(theta, code, gh, gw, cs)
    dp_sel = eval_plane(th_sel, x, y)
    dd_sel = (dp_sel - disp) ** 2
    inliers = torch.isfinite(dd_sel) & (dd_sel < cfg.thresh_disp) \
        & (dp_sel > 0.0)
    return theta, inliers


# ---------------------------------------------------------------------------
# Plane smoothing filter (replaces initFilter/iterateFilter/finishFilter)
# ---------------------------------------------------------------------------


def smooth_planes(stats: SuperpixelStats, cfg: TPSConfig) -> Tensor:
    """Jacobi relaxation coupling neighbouring superpixels' planes. State per
    node: X = (dp(centroid), a, b)."""
    th = stats.theta
    px_ = stats.centroid[..., 0]
    py_ = stats.centroid[..., 1]
    z0 = th[..., 0] * px_ + th[..., 1] * py_ + th[..., 2]
    X = torch.stack([z0, th[..., 0], th[..., 1]], dim=-1)   # (GH, GW, 3)
    Z = X
    alpha, beta, thr = cfg.filter_alpha, cfg.filter_beta, cfg.filter_thresh
    eye = torch.eye(3, dtype=torch.float32, device=th.device)
    nan = float("nan")

    for _ in range(cfg.filter_iter):
        A = torch.zeros(X.shape[:-1] + (3, 3), dtype=torch.float32,
                        device=th.device)
        A = A + alpha * eye
        R = alpha * Z
        for dy, dx in _NEIGH4:
            Xj = shift2d(X, dy, dx, fill=nan)
            pxj = shift2d(px_, dy, dx, fill=nan)
            pyj = shift2d(py_, dy, dx, fill=nan)
            dx_ = px_ - pxj
            dy_ = py_ - pyj
            dz = X[..., 0] - Xj[..., 0]
            w = torch.isfinite(dz) & (dz * dz < thr * thr) \
                & torch.isfinite(dx_)
            zero = torch.zeros_like(dz)
            wb = torch.where(w, torch.full_like(dz, beta), zero)
            dxw = torch.where(w, dx_, zero)
            dyw = torch.where(w, dy_, zero)
            Xj0 = torch.where(w, Xj[..., 0], zero)
            Xj1 = torch.where(w, Xj[..., 1], zero)
            Xj2 = torch.where(w, Xj[..., 2], zero)
            dA = torch.stack(
                [
                    torch.stack([2 * wb, -wb * dxw, -wb * dyw], dim=-1),
                    torch.stack([-wb * dxw, wb * (2 + dxw * dxw),
                                 wb * dxw * dyw], dim=-1),
                    torch.stack([-wb * dyw, wb * dxw * dyw,
                                 wb * (2 + dyw * dyw)], dim=-1),
                ],
                dim=-2,
            )
            dR = torch.stack(
                [
                    wb * (2 * Xj0 + dxw * Xj1 + dyw * Xj2),
                    wb * (-dxw * Xj0 + 2 * Xj1),
                    wb * (-dyw * Xj0 + 2 * Xj2),
                ],
                dim=-1,
            )
            A = A + dA
            R = R + dR
        Ainv, ok = inv3x3_sym(A)
        Xn = torch.einsum("...ij,...j->...i", Ainv, R)
        X = torch.where(ok[..., None], Xn, X)

    a_, b_ = X[..., 1], X[..., 2]
    c_ = X[..., 0] - px_ * a_ - py_ * b_
    return torch.stack([a_, b_, c_], dim=-1)


def render_plane_depth(theta: Tensor, labels: Tensor, gh: int, gw: int,
                       cs: int) -> Tensor:
    """Slanted-plane depth image: depth = 1 / (theta . (x, y, 1))."""
    H, W = labels.shape
    y, x = _iota(H, W, labels.device, torch.float32)
    th_px = lookup_cells(theta, _rel_code(labels, gh, gw, cs), gh, gw, cs)
    return 1.0 / eval_plane(th_px, x, y)


# ---------------------------------------------------------------------------
# Top-level segmentation
# ---------------------------------------------------------------------------


def grid_labels(H: int, W: int, cs: int, device) -> Tensor:
    """Initial labels: each pixel's own grid cell."""
    y, x = _iota(H, W, device, torch.int32)
    return (y // cs) * (W // cs) + (x // cs)


def segment(rgb: Tensor, disp: Tensor, cfg: TPSConfig) -> TPSResult:
    """Full TPS segmentation: grid init -> nb_iters/2 RGB-only iterations ->
    RANSAC plane init -> nb_iters/2 RGBD iterations. `rgb` is (H, W, 3)
    float32 in [0, 255]; `disp` is (H, W) 1/depth."""
    H, W, _ = rgb.shape
    cs = cfg.cell_size
    if H % cs or W % cs:
        raise ValueError("image must tile by cell_size")
    gh, gw = H // cs, W // cs

    labels = grid_labels(H, W, cs, rgb.device)
    inliers = torch.zeros((H, W), dtype=torch.bool, device=rgb.device)

    with tracing.span("tps.rgb"):
        stats = _merge_rgb(rgb, labels, gh, gw, cs)
        S = stat_image(stats, labels, gh, gw, cs)
        for _ in range(cfg.nb_iters // 2):
            for phase in range(4):
                labels, inliers, S = phase_update(
                    labels, inliers, S, rgb, disp, phase, cfg,
                    use_disp=False, gh=gh, gw=gw)
                if cfg.merge_every_phase:
                    stats = _merge_rgb(rgb, labels, gh, gw, cs)
                    S = stat_image(stats, labels, gh, gw, cs)
            if not cfg.merge_every_phase:
                stats = _merge_rgb(rgb, labels, gh, gw, cs)
                S = stat_image(stats, labels, gh, gw, cs)

    with tracing.span("tps.plane_init"):
        if cfg.use_ransac:
            _, inliers = ransac_plane_init(disp, labels, stats, cfg, gh, gw)
        else:
            inliers = torch.isfinite(disp)
        theta = fit_planes(disp, labels, inliers, gh, gw, cs)
        stats = stats._replace(theta=theta)
        S = stat_image(stats, labels, gh, gw, cs)

    def remerge(labels, inliers):
        rgbm = _merge_rgb(rgb, labels, gh, gw, cs)
        theta = fit_planes(disp, labels, inliers, gh, gw, cs)
        st = SuperpixelStats(rgbm.centroid, rgbm.color, rgbm.size, theta)
        return st, stat_image(st, labels, gh, gw, cs)

    with tracing.span("tps.rgbd"):
        for _ in range(cfg.nb_iters - cfg.nb_iters // 2):
            for phase in range(4):
                labels, inliers, S = phase_update(
                    labels, inliers, S, rgb, disp, phase, cfg,
                    use_disp=True, gh=gh, gw=gw)
                if cfg.merge_every_phase:
                    stats, S = remerge(labels, inliers)
            if not cfg.merge_every_phase:
                stats, S = remerge(labels, inliers)

    return TPSResult(labels=labels, boundary=boundary_count(labels),
                     inliers=inliers, stats=stats, disp=disp)

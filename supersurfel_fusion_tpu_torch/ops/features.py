"""ORB-style feature extraction.

Port of `supersurfel_fusion_tpu/ops/features.py`: 8-level image pyramid,
FAST-9/16 corners at two thresholds (packed-bit arc test), Harris-ranked
per-cell selection, intensity-centroid orientation and rotated 256-bit
BRIEF descriptors from a numpy-seeded pattern.

The pyramid levels reproduce `jax.image.resize(..., "bilinear")` (a
triangle kernel widened by the downscale factor, i.e. antialiased) with the
same f32 weight matrices, and the Harris box filter keeps the JAX package's
float-identical shift form: a reordered sum can flip per-cell argmax picks.
Descriptors are (K, 8) 32-bit words carried as int32 bit patterns.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import numpy as np
import torch

from supersurfel_fusion_tpu_torch import tracing
from supersurfel_fusion_tpu_torch.config import VOConfig
from supersurfel_fusion_tpu_torch.ops.depth import shift2d
from supersurfel_fusion_tpu_torch.ops.tps import _iota

Tensor = torch.Tensor

# FAST-9/16 Bresenham circle (dx, dy), radius 3
_CIRCLE = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]

_PATCH_R = 20          # patch radius for orientation + descriptor sampling
_PATCH = 2 * _PATCH_R + 1
_ORI_R = 15            # intensity-centroid radius (ORB convention)


class Keypoints(NamedTuple):
    xy: Tensor        # (K, 2) float32 (x, y) at level-0 scale
    level: Tensor     # (K,) int32
    angle: Tensor     # (K,) float32 radians
    score: Tensor     # (K,) float32
    valid: Tensor     # (K,) bool
    desc: Tensor      # (K, 8) int32 bit patterns of the 256-bit descriptor

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def _level_budgets(total: int, n_levels: int, scale: float) -> List[int]:
    """Geometric split of the feature budget across levels."""
    f = 1.0 / scale
    w = [f**i for i in range(n_levels)]
    s = sum(w)
    return [max(8, int(round(total * wi / s))) for wi in w]


def _resize_weights(m: int, n: int) -> np.ndarray:
    """(m, n) f32 weights of `jax.image.resize` along one axis of size m ->
    n, bilinear with antialiasing, computed with the same f32 operations
    (and the same sequential column sums) as jax.image.compute_weight_mat."""
    scale = n / m
    inv_scale = 1.0 / scale
    f32 = np.float32
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.add.reduce(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _resize_weights_on(m: int, n: int, device: torch.device) -> Tensor:
    return torch.as_tensor(_resize_weights(m, n), device=device)


def resize_bilinear(img: Tensor, Hl: int, Wl: int) -> Tensor:
    """`jax.image.resize(img, (Hl, Wl), "bilinear")` for a 2D image (the
    f32 weights are cast to the image's dtype)."""
    H, W = img.shape
    out = img
    if Hl != H:
        wh = _resize_weights_on(H, Hl, img.device).to(img.dtype)
        out = wh.T @ out
    if Wl != W:
        out = out @ _resize_weights_on(W, Wl, img.device).to(img.dtype)
    return out


def gaussian_blur(img: Tensor, sigma: float = 2.0, radius: int = 3) -> Tensor:
    """Separable Gaussian (the 7x7 sigma=2 blur ORB applies before BRIEF)."""
    ks = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(ks)
    ks = [k / s for k in ks]
    out = torch.zeros_like(img)
    for i, k in enumerate(ks):
        out = out + k * shift2d(img, i - radius, 0, fill=0.0)
    out2 = torch.zeros_like(out)
    for i, k in enumerate(ks):
        out2 = out2 + k * shift2d(out, 0, i - radius, fill=0.0)
    return out2


def fast_scores(img: Tensor, th_hi: float, th_lo: float):
    """FAST-9/16 corner test at two thresholds: (corner_hi, corner_lo,
    score). The contiguous-arc-of-9 test is a packed-bit run-length check
    on the 16 circle comparisons."""
    taps = [shift2d(img, dy, dx, fill=0.0) for dx, dy in _CIRCLE]
    diffs = [t - img for t in taps]

    def _pack(masks):
        m = masks[0].to(torch.int32)
        for k in range(1, 16):
            m = m | (masks[k].to(torch.int32) << k)
        return m

    def _run9(m):
        ext = m | (m << 16)
        r2 = ext & (ext >> 1)
        r4 = r2 & (r2 >> 2)
        r8 = r4 & (r4 >> 4)
        r9 = r8 & (ext >> 8)
        return (r9 & 0xFFFF) != 0

    def arc_test(th):
        bright = _pack([d > th for d in diffs])
        dark = _pack([d < -th for d in diffs])
        return _run9(bright) | _run9(dark)

    H, W = img.shape
    y, x = _iota(H, W, img.device, torch.int32)
    interior = (x >= 3) & (x < W - 3) & (y >= 3) & (y < H - 3)

    corner_hi = arc_test(th_hi) & interior
    corner_lo = arc_test(th_lo) & interior

    pos = sum(torch.clamp(d - th_lo, min=0.0) for d in diffs)
    neg = sum(torch.clamp(-d - th_lo, min=0.0) for d in diffs)
    return corner_hi, corner_lo, torch.maximum(pos, neg)


def harris_response(img: Tensor, k: float = 0.04, r: int = 3) -> Tensor:
    """Harris corner response (det - k tr^2 over a (2r+1)^2 block), with the
    separable shift-chain box sum of the JAX package (same float order)."""
    ix = 0.5 * (shift2d(img, 0, 1, fill=0.0) - shift2d(img, 0, -1, fill=0.0))
    iy = 0.5 * (shift2d(img, 1, 0, fill=0.0) - shift2d(img, -1, 0, fill=0.0))

    def box(t):
        for axis in (0, 1):
            acc = t
            for i in range(1, r + 1):
                acc = acc + (shift2d(t, i, 0) + shift2d(t, -i, 0)
                             if axis == 0 else
                             shift2d(t, 0, i) + shift2d(t, 0, -i))
            t = acc
        return t

    ixx = box(ix * ix)
    iyy = box(iy * iy)
    ixy = box(ix * iy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _top_k(x: Tensor, k: int):
    """`lax.top_k`: the k largest, ties broken toward the lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _select_level_keypoints(corner_hi, corner_lo, score, harris,
                            k_budget: int, border: int, cell: int):
    """FAST-score 3x3 NMS + Harris-ranked per-cell argmax + top-k."""
    H, W = score.shape
    y, x = _iota(H, W, score.device, torch.int32)
    in_border = (x >= border) & (x < W - border) & (y >= border) \
        & (y < H - border)
    nms = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nms &= score >= shift2d(score, dy, dx, fill=-1.0)
    h = torch.clamp(harris, min=0.0)
    hkey = (h + 1.0) / (h + 1e9)
    zero = torch.zeros_like(hkey)
    key_hi = torch.where(corner_hi & in_border & nms, hkey, zero)
    key_lo = torch.where(corner_lo & in_border & nms, hkey, zero)

    Hp = (H + cell - 1) // cell * cell
    Wp = (W + cell - 1) // cell * cell

    def cellify(key):
        keyp = torch.nn.functional.pad(key, (0, Wp - W, 0, Hp - H))
        cells = keyp.reshape(Hp // cell, cell, Wp // cell, cell)
        cells = cells.permute(0, 2, 1, 3).reshape(-1, cell * cell)
        idx = torch.argmax(cells, dim=-1)
        val = torch.gather(cells, 1, idx[:, None])[:, 0]
        return idx, val

    ihi, vhi = cellify(key_hi)
    ilo, vlo = cellify(key_lo)
    use_hi = vhi > 0.0
    best_in_cell = torch.where(use_hi, ihi, ilo)
    best_val = torch.where(use_hi, vhi, vlo)
    rank = best_val + use_hi.to(torch.float32) * 1000.0

    k = min(k_budget, best_val.shape[0])
    _, top_cell = _top_k(rank, k)
    top_val = best_val[top_cell]
    flat = best_in_cell[top_cell]
    ncw = Wp // cell
    cy = (top_cell // ncw) * cell + flat // cell
    cx = (top_cell % ncw) * cell + flat % cell
    valid = top_val > 0.0
    return cx, cy, torch.where(valid, top_val, torch.zeros_like(top_val)), \
        valid


@functools.lru_cache(maxsize=None)
def _ori_masks(device: torch.device):
    yy, xx = np.mgrid[-_PATCH_R:_PATCH_R + 1, -_PATCH_R:_PATCH_R + 1]
    circ = (xx**2 + yy**2) <= _ORI_R**2
    return (torch.as_tensor((xx * circ).astype(np.float32), device=device),
            torch.as_tensor((yy * circ).astype(np.float32), device=device))


def _brief_pattern() -> np.ndarray:
    """(256, 2, 2) int32 sampling-pair offsets: the JAX package's seeded
    BRIEF-style Gaussian pairs (sigma = patch/5), same numpy draw."""
    rng = np.random.default_rng(5489)
    pts = rng.normal(0.0, 31.0 / 5.0, (256, 2, 2))
    return np.clip(np.round(pts), -13, 13).astype(np.int32)


_PATTERN = _brief_pattern()


@functools.lru_cache(maxsize=None)
def _pattern_on(device: torch.device) -> Tensor:
    return torch.as_tensor(_PATTERN, device=device).to(torch.float32)


def _extract_patches(img: Tensor, cx: Tensor, cy: Tensor) -> Tensor:
    """(K, 41, 41) patches centred on (cx, cy), clamped to the image."""
    H, W = img.shape
    y0 = torch.clamp(cy - _PATCH_R, 0, H - _PATCH)
    x0 = torch.clamp(cx - _PATCH_R, 0, W - _PATCH)
    r = torch.arange(_PATCH, device=img.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return img[rows, cols]


def _orientations(patches: Tensor) -> Tensor:
    mx, my = _ori_masks(patches.device)
    flat = patches.reshape(patches.shape[0], -1)
    m10 = flat @ mx.reshape(-1)
    m01 = flat @ my.reshape(-1)
    return torch.arctan2(m01, m10)


def _descriptors(patches_blur: Tensor, angle: Tensor) -> Tensor:
    """Rotated BRIEF at orientation-rotated offsets (nearest neighbour),
    256 bits packed into 8 int32 words (bit b of word j = pair 32j+b)."""
    pat = _pattern_on(angle.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    rx = torch.round(ca[:, None, None] * px - sa[:, None, None] * py)
    ry = torch.round(sa[:, None, None] * px + ca[:, None, None] * py)
    rx = torch.clamp(rx.to(torch.int64) + _PATCH_R, 0, _PATCH - 1)
    ry = torch.clamp(ry.to(torch.int64) + _PATCH_R, 0, _PATCH - 1)

    K = patches_blur.shape[0]
    flat = patches_blur.reshape(K, -1)
    idx = ry * _PATCH + rx                                   # (K, 256, 2)
    samples = torch.gather(flat, 1, idx.reshape(K, -1)).reshape(K, 256, 2)
    bits = (samples[..., 0] < samples[..., 1]).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=angle.device) \
        << torch.arange(32, device=angle.device)
    words = torch.sum(bits.reshape(K, 8, 32) * weights, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _level_shape(H0: int, W0: int, lvl: int, scale_factor: float):
    scale = scale_factor**lvl
    return (max(int(round(H0 / scale)), _PATCH + 2),
            max(int(round(W0 / scale)), _PATCH + 2))


def keypoint_capacity(cfg: VOConfig, H: int, W: int) -> int:
    """The static keypoint count of `detect_and_describe` on an H x W
    image: each level keeps at most its budget, and at most one keypoint
    per detection cell."""
    budgets = _level_budgets(cfg.nb_features, cfg.nb_levels, cfg.scale_factor)
    cell = int(cfg.detect_cell)
    total = 0
    for lvl in range(cfg.nb_levels):
        Hl, Wl = (H, W) if lvl == 0 else _level_shape(H, W, lvl,
                                                       cfg.scale_factor)
        n_cells = -(-Hl // cell) * -(-Wl // cell)
        total += min(budgets[lvl], n_cells)
    return total


def detect_and_describe(gray: Tensor, cfg: VOConfig) -> Keypoints:
    """Full ORB pipeline over the pyramid. Output capacity is the sum of the
    per-level budgets (static)."""
    budgets = _level_budgets(cfg.nb_features, cfg.nb_levels, cfg.scale_factor)
    H0, W0 = gray.shape
    dev = gray.device

    all_xy, all_level, all_angle, all_score, all_valid, all_desc = (
        [], [], [], [], [], [])
    img = gray
    for lvl in range(cfg.nb_levels):
        scale = cfg.scale_factor**lvl
        with tracing.span("features.score"):
            if lvl > 0:
                img = resize_bilinear(gray, *_level_shape(H0, W0, lvl,
                                                          cfg.scale_factor))
            hi, lo, score = fast_scores(img, float(cfg.ini_th_fast),
                                        float(cfg.min_th_fast))
            harris = harris_response(img) if cfg.harris_rank else score
        with tracing.span("features.select"):
            cx, cy, val, valid = _select_level_keypoints(
                hi, lo, score, harris, budgets[lvl], border=_PATCH_R + 1,
                cell=int(cfg.detect_cell))
        with tracing.span("features.describe"):
            patches = _extract_patches(img, cx, cy)
            angle = _orientations(patches)
            patches_b = _extract_patches(gaussian_blur(img), cx, cy)
            desc = _descriptors(patches_b, angle)

        all_xy.append(torch.stack([cx.to(torch.float32) * scale,
                                   cy.to(torch.float32) * scale], dim=-1))
        all_level.append(torch.full((cx.shape[0],), lvl, dtype=torch.int32,
                                    device=dev))
        all_angle.append(angle)
        all_score.append(val)
        all_valid.append(valid)
        all_desc.append(desc)

    return Keypoints(
        xy=torch.cat(all_xy),
        level=torch.cat(all_level),
        angle=torch.cat(all_angle),
        score=torch.cat(all_score),
        valid=torch.cat(all_valid),
        desc=torch.cat(all_desc),
    )

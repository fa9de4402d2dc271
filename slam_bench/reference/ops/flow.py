# Frozen copy of supersurfel_fusion_tpu_torch/ops/flow.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Dense optical flow + robust 2D similarity estimation.

Port of `supersurfel_fusion_tpu/ops/flow.py` (the MOD's replacements for
OpenCV's `estimateAffinePartial2D` and DIS optical flow):

* `estimate_similarity_ransac`: fixed-budget RANSAC, all hypotheses from
  2-point minimal samples scored at once (ranked by spatial coverage), LSQ
  refit on the winner's inliers. The hypothesis pairs are the JAX
  package's seeded `jax.random.randint` draw (`utils/prng.py`).
* `dense_flow`: coarse-to-fine pyramidal Lucas-Kanade with box-filtered
  structure tensors.

The per-element arithmetic follows the JAX version term by term. Two
changes cut launches without changing it: the five structure-tensor
inputs are box-filtered as one stacked tensor (the same shift-and-add
order, which decides rounding), and I1, gx and gy are sampled at the same
coordinates in one stacked gather.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from slam_bench.reference.ops.depth import shift2d
from slam_bench.reference.ops.features import resize_bilinear
from slam_bench.reference.ops.tps import _iota
from slam_bench.reference.utils import prng

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# 4-DoF similarity (rotation + scale + translation) RANSAC
# ---------------------------------------------------------------------------


def _similarity_from_2pts(p0, p1, q0, q1):
    """Similarity mapping p->q from two point pairs (batched).
    Returns (a, b, tx, ty) with q = [[a, -b], [b, a]] p + t."""
    dp = p1 - p0
    dq = q1 - q0
    den = torch.clamp(dp[..., 0] ** 2 + dp[..., 1] ** 2, min=1e-12)
    a = (dp[..., 0] * dq[..., 0] + dp[..., 1] * dq[..., 1]) / den
    b = (dp[..., 0] * dq[..., 1] - dp[..., 1] * dq[..., 0]) / den
    tx = q0[..., 0] - (a * p0[..., 0] - b * p0[..., 1])
    ty = q0[..., 1] - (b * p0[..., 0] + a * p0[..., 1])
    return a, b, tx, ty


def _apply_similarity(a, b, tx, ty, p):
    x = a[..., None] * p[..., 0] - b[..., None] * p[..., 1] + tx[..., None]
    y = b[..., None] * p[..., 0] + a[..., None] * p[..., 1] + ty[..., None]
    return torch.stack([x, y], dim=-1)


def _norm2(v: Tensor) -> Tensor:
    """Euclidean norm over a last axis of 2, summed in order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


@functools.lru_cache(maxsize=None)
def _pairs_on(seed: int, n_hyp: int, n: int, device: torch.device) -> Tensor:
    """(n_hyp, 2) int64 in [0, n): JAX's
    `jax.random.randint(PRNGKey(seed), (n_hyp, 2), 0, n)`."""
    pairs = prng.randint(prng.PRNGKey(seed), (n_hyp, 2), 0, n)
    return torch.as_tensor(pairs, device=device).to(torch.int64)


def coverage_rank(inl: Tensor, src_xy: Tensor, img_w: float, img_h: float,
                  grid: int) -> Tensor:
    """(n_hyp,) number of distinct grid cells holding an inlier of each
    hypothesis (inl: (n_hyp, N) bool, src_xy: (N, 2) pixels)."""
    cellw, cellh = img_w / grid, img_h / grid
    cx = torch.clamp((src_xy[:, 0] / cellw).to(torch.int64), 0, grid - 1)
    cy = torch.clamp((src_xy[:, 1] / cellh).to(torch.int64), 0, grid - 1)
    onehot = F.one_hot(cy * grid + cx, grid * grid).to(torch.float32)
    covered = (inl.to(torch.float32) @ onehot) > 0.0
    return torch.sum(covered, dim=-1).to(torch.float32)


def estimate_similarity_ransac(src: Tensor, dst: Tensor, ok: Tensor,
                               thresh: float = 4.0, n_hyp: int = 256,
                               seed: int = 1234, grid: int = 8,
                               img_w: float = 640.0, img_h: float = 480.0):
    """RANSAC similarity src->dst over masked correspondences.

    Returns (a, b, tx, ty, valid), all 0-d tensors. Hypotheses are ranked
    by spatial coverage (distinct grid cells holding an inlier), with the
    raw inlier count as tiebreak, so that a compact mover cannot out-vote
    the camera motion."""
    N = src.shape[0]
    idx = _pairs_on(seed, n_hyp, N, src.device)
    i0, i1 = idx[:, 0], idx[:, 1]
    p0, p1 = src[i0], src[i1]
    q0, q1 = dst[i0], dst[i1]
    pair_ok = ok[i0] & ok[i1] & (_norm2(p1 - p0) > 1e-3)

    a, b, tx, ty = _similarity_from_2pts(p0, p1, q0, q1)
    pred = _apply_similarity(a, b, tx, ty, src[None, :, :])   # (n_hyp, N, 2)
    err = _norm2(pred - dst[None, :, :])
    inl = (err < thresh) & ok[None, :]

    coverage = coverage_rank(inl, src, img_w, img_h, grid)
    n_inl_h = torch.sum(inl, dim=1).to(torch.float32)
    scores = torch.where(pair_ok, coverage * 4096.0 + n_inl_h,
                         torch.full_like(n_inl_h, -1.0))
    best = torch.argmax(scores)
    # a 1-element index, not a 0-d one: indexing with a 0-d tensor reads
    # it on the host and waits for the device
    best_inl = inl.index_select(0, best.reshape(1))[0] & ok

    # LSQ refit on the winning inliers: normal equations of
    # [[x, -y, 1, 0], [y, x, 0, 1]] . (a b tx ty) = (u, v)
    w = best_inl.to(torch.float32)
    sw = torch.clamp(torch.sum(w), min=1e-6)
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    sxx = torch.sum(w * (x * x + y * y))
    sx = torch.sum(w * x)
    sy = torch.sum(w * y)
    su = torch.sum(w * u)
    sv = torch.sum(w * v)
    sxu = torch.sum(w * (x * u + y * v))
    syu = torch.sum(w * (x * v - y * u))
    zero = torch.zeros_like(sxx)
    A = torch.stack([
        torch.stack([sxx, zero, sx, sy]),
        torch.stack([zero, sxx, -sy, sx]),
        torch.stack([sx, -sy, sw, zero]),
        torch.stack([sy, sx, zero, sw]),
    ])
    rhs = torch.stack([sxu, syu, su, sv])
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    # solve_ex: no host sync for the error check; a singular system gives
    # non-finite values, which `valid` rejects as the JAX version does
    sol, _ = torch.linalg.solve_ex(A + eye * 1e-6, rhs)
    n_in = torch.sum(best_inl.to(torch.int32))
    valid = (n_in >= 6) & torch.all(torch.isfinite(sol))
    one = torch.ones_like(sxx)
    a_f = torch.where(valid, sol[0], one)
    b_f = torch.where(valid, sol[1], zero)
    tx_f = torch.where(valid, sol[2], zero)
    ty_f = torch.where(valid, sol[3], zero)
    return a_f, b_f, tx_f, ty_f, valid


def warp_similarity(img: Tensor, a, b, tx, ty, fill: float = 0.0) -> Tensor:
    """Warp with the forward map convention of cv::warpAffine: output(x, y)
    = img(M^-1 (x, y)) for M = [[a, -b, tx], [b, a, ty]]. Bilinear."""
    H, W = img.shape
    y, x = _iota(H, W, img.device, torch.float32)
    det = torch.clamp(a * a + b * b, min=1e-12)
    xs = (a * (x - tx) + b * (y - ty)) / det
    ys = (-b * (x - tx) + a * (y - ty)) / det
    return bilinear_sample(img, xs, ys, fill)


def bilinear_sample(img: Tensor, xs: Tensor, ys: Tensor,
                    fill: float = 0.0) -> Tensor:
    """Sample img (H, W), or a stack (C, H, W) at shared coordinates, at
    float pixel coordinates xs, ys; `fill` outside [0, W-1] x [0, H-1]."""
    H, W = img.shape[-2], img.shape[-1]
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    ok = (xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1)
    x0c = torch.clamp(x0, 0, W - 2)
    y0c = torch.clamp(y0, 0, H - 2)
    fx = xs - x0c
    fy = ys - y0c
    flat = img.reshape(*img.shape[:-2], H * W)
    i00 = y0c * W + x0c
    corners = torch.stack([i00, i00 + 1, i00 + W, i00 + W + 1]).reshape(-1)
    vals = flat[..., corners].reshape(*img.shape[:-2], 4, *xs.shape)
    v00, v01, v10, v11 = vals.unbind(-1 - xs.dim())
    out = (v00 * (1 - fx) * (1 - fy)
           + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy
           + v11 * fx * fy)
    return torch.where(ok, out, torch.full_like(out, fill))


def se3_depth_residual(depth_cur: Tensor, depth_prev: Tensor, R: Tensor,
                       t: Tensor, fx: float, fy: float, cx: float, cy: float,
                       z_min: float = 0.2, z_max: float = 4.0) -> Tensor:
    """Per-pixel signed rigid-motion depth residual sample(prev_depth,
    proj(X')) - X'.z with X' = R^T (backproject(u, v, depth_cur) - t).

    (R, t) maps previous-camera points to current-camera points. Positive
    values mark pixels newly covered by a mover, negative ones background
    it revealed. Returns (H, W), 0 where a depth is invalid or out of
    range."""
    H, W = depth_cur.shape
    y, x = _iota(H, W, depth_cur.device, torch.float32)
    z = depth_cur
    X = torch.stack([(x - cx) * z / fx, (y - cy) * z / fy, z], dim=-1)
    Xp = (X - t) @ R                     # == R^T (X - t), row-vector form
    zp = Xp[..., 2]
    safe = torch.where(torch.abs(zp) > 1e-6, zp, torch.full_like(zp, 1e-6))
    up = Xp[..., 0] * fx / safe + cx
    vp = Xp[..., 1] * fy / safe + cy
    zs = bilinear_sample(depth_prev, up, vp, 0.0)
    # zs is deliberately not bounded above: a mover in front of a far
    # background shows up exactly as zs >> zp
    ok = ((z >= z_min) & (z < z_max) & (zp >= z_min) & (zp < z_max)
          & (zs >= z_min)
          & (up >= 0) & (up <= W - 1) & (vp >= 0) & (vp <= H - 1))
    return torch.where(ok, zs - zp, torch.zeros_like(zs))


# ---------------------------------------------------------------------------
# Pyramidal Lucas-Kanade dense flow
# ---------------------------------------------------------------------------


def _box(img: Tensor, r: int) -> Tensor:
    """Separable (2r+1)^2 box filter over the last two axes, zero outside,
    summed tap by tap from -r to r as the JAX version's shifted adds."""
    H, W = img.shape[-2], img.shape[-1]
    p = F.pad(img, (0, 0, r, r))
    acc = torch.zeros_like(img)
    for d in range(-r, r + 1):
        acc = acc + p[..., r + d:r + d + H, :]
    p = F.pad(acc, (r, r))
    acc = torch.zeros_like(img)
    for d in range(-r, r + 1):
        acc = acc + p[..., r + d:r + d + W]
    return acc


def _lk_level(I0: Tensor, I1: Tensor, flow: Tensor, iters: int,
              r: int) -> Tensor:
    """Refine flow at one level: I0(x) ~ I1(x + flow)."""
    gx = 0.5 * (shift2d(I1, 0, 1, fill=0.0) - shift2d(I1, 0, -1, fill=0.0))
    gy = 0.5 * (shift2d(I1, 1, 0, fill=0.0) - shift2d(I1, -1, 0, fill=0.0))
    stack = torch.stack([I1, gx, gy])

    H, W = I0.shape
    yy, xx = _iota(H, W, I0.device, torch.float32)
    lam = 1e-3 * (2 * r + 1) ** 2
    for _ in range(iters):
        xs = xx + flow[..., 0]
        ys = yy + flow[..., 1]
        I1w, gxw, gyw = bilinear_sample(stack, xs, ys, 0.0).unbind(0)
        it = I1w - I0
        # windowed structure tensor
        a11, a12, a22, b1, b2 = _box(torch.stack(
            [gxw * gxw, gxw * gyw, gyw * gyw, gxw * it, gyw * it]), r)
        det = a11 * a22 - a12 * a12
        det = det + lam * (a11 + a22) + lam * lam
        den = torch.clamp(det, min=1e-9)
        du = -(a22 * b1 - a12 * b2) / den
        dv = -(-a12 * b1 + a11 * b2) / den
        du = torch.clamp(du, -4.0, 4.0)
        dv = torch.clamp(dv, -4.0, 4.0)
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def _resize_flow(flow: Tensor, nh: int, nw: int) -> Tensor:
    """`jax.image.resize(flow, (nh, nw, 2), "bilinear")`: each channel."""
    return torch.stack([resize_bilinear(flow[..., c], nh, nw)
                        for c in range(flow.shape[-1])], dim=-1)


def dense_flow(I0: Tensor, I1: Tensor, levels: int = 4, iters: int = 3,
               r: int = 4) -> Tensor:
    """Coarse-to-fine dense flow I0 -> I1, (H, W, 2) in pixels."""
    H, W = I0.shape
    pyr0, pyr1 = [I0], [I1]
    for lv in range(1, levels):
        s = 2**lv
        pyr0.append(resize_bilinear(I0, H // s, W // s))
        pyr1.append(resize_bilinear(I1, H // s, W // s))

    flow = torch.zeros(pyr0[-1].shape + (2,), dtype=torch.float32,
                       device=I0.device)
    for lv in range(levels - 1, -1, -1):
        flow = _lk_level(pyr0[lv], pyr1[lv], flow, iters, r)
        if lv > 0:
            nh, nw = pyr0[lv - 1].shape
            flow = _resize_flow(flow, nh, nw) * 2.0
    return flow

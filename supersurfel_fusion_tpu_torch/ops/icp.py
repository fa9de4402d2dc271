"""Dense frame-to-model registration: symmetric point-to-plane ICP.

Port of `supersurfel_fusion_tpu/ops/icp.py` (a rewrite of
`DenseRegistration::featureConstrainedSymmetricICP` and its fused
correspondence + normal-equation kernel). The JAX Gauss-Newton loop is a
`lax.while_loop` with an early exit; here it runs a fixed `nb_iters` steps
and, once the exit condition holds, every loop variable is frozen by mask.
That costs no host sync per step and gives the same iteration count and the
same final error, system and inlier count.

Parameterization: solve (J^T J) x = J^T r with x = (rot_axis, tran);
theta = 0.5*atan(|rot_axis|); tran *= cos(theta);
T_iter = R(theta) * T(tran) * R(theta); accumulate T_inc = T_iter * T_inc.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from supersurfel_fusion_tpu_torch.config import CameraIntrinsics, ICPConfig
from supersurfel_fusion_tpu_torch.ops.tps import _iota, _rel_code, lookup_cells
from supersurfel_fusion_tpu_torch.parallel.mesh import psum_packed
from supersurfel_fusion_tpu_torch.types import Supersurfels
from supersurfel_fusion_tpu_torch.utils.camera import backproject
from supersurfel_fusion_tpu_torch.utils.color import rgb_to_lab
from supersurfel_fusion_tpu_torch.utils.geometry import (
    axis_angle_to_mat,
    normalize,
    orthonormalize,
)

Tensor = torch.Tensor


class ICPResult(NamedTuple):
    R_rel: Tensor      # (3, 3)
    t_rel: Tensor      # (3,)
    valid: Tensor      # () bool
    inliers: Tensor    # () float — inlier count of the last iteration
    error: Tensor      # () float — sqrt(r / inliers) of the last iteration
    # () int32 gate bitmask: 1=min_inliers ok, 2=cov gate ok, 4=translation
    # gate ok, 8=ran >0 iterations. valid == (code == 15).
    code: Tensor = None
    cov_diag: Tensor = None  # (6,) pose covariance diagonal (gate input)
    iters: Tensor = None     # () int32 Gauss-Newton iterations run


def build_target_maps(frame: Supersurfels, labels: Tensor,
                      plane_depth: Tensor, cam: CameraIntrinsics,
                      cell_size: int, z_min: float = 0.2,
                      z_max: float = 5.0) -> Tensor:
    """Per-pixel target fields for projective association: (H, W, 10) =
    [pt(3), nt(3), lab(3), valid(1)]."""
    H, W = labels.shape
    gh, gw = H // cell_size, W // cell_size

    code = _rel_code(labels, gh, gw, cell_size)
    table = torch.cat(
        [
            frame.orientations[:, 2, :].reshape(gh, gw, 3),
            rgb_to_lab(frame.colors).reshape(gh, gw, 3),
            (frame.confidences > 0.0).to(torch.float32).reshape(gh, gw, 1),
        ],
        dim=-1,
    )
    per_px = lookup_cells(table, code, gh, gw, cell_size)      # (H, W, 7)

    y, x = _iota(H, W, labels.device, torch.float32)
    zt = plane_depth
    depth_ok = torch.isfinite(zt) & (zt >= z_min) & (zt <= z_max)
    zts = torch.where(depth_ok, zt, torch.zeros_like(zt))
    pt = backproject(x, y, zts, cam)
    valid = (per_px[..., 6] > 0.5) & depth_ok
    return torch.cat([pt, per_px[..., 0:3], per_px[..., 3:6],
                      valid[..., None].to(torch.float32)], dim=-1)


def _build_system(src_pos: Tensor, src_normal: Tensor, src_lab: Tensor,
                  src_mask: Tensor, target_maps: Tensor, R: Tensor,
                  t: Tensor, cam: CameraIntrinsics, cfg: ICPConfig):
    """One linearization: returns (JtJ (6,6), Jtr (6,), r, inliers)."""
    H, W, _ = target_maps.shape
    ps = src_pos @ R.T + t                                     # (N, 3)
    zs = torch.where(ps[:, 2] != 0, ps[:, 2], torch.full_like(ps[:, 2], 1e-9))
    u = torch.round(ps[:, 0] * cam.fx / zs + cam.cx)
    v = torch.round(ps[:, 1] * cam.fy / zs + cam.cy)
    # clamp before the int cast: far-off projections would overflow int32
    u = torch.clamp(u, -1.0, float(W)).to(torch.int64)
    v = torch.clamp(v, -1.0, float(H)).to(torch.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (ps[:, 2] > 0)
    idx = torch.clamp(v, 0, H - 1) * W + torch.clamp(u, 0, W - 1)

    tm = target_maps.reshape(H * W, 10)[idx]                   # (N, 10)
    pt, nt, tlab, tvalid = tm[:, 0:3], tm[:, 3:6], tm[:, 6:9], tm[:, 9]

    ns = normalize(src_normal @ R.T)
    color_dist = torch.linalg.norm(src_lab - tlab, dim=-1)
    dist = torch.linalg.norm(ps - pt, dim=-1)
    ndot = torch.abs(torch.sum(ns * nt, dim=-1))

    ok = (src_mask & inb & (tvalid > 0.5)
          & (color_dist < cfg.max_color_dist) & (dist < cfg.max_dist)
          & (ndot > cfg.min_normal_dot))

    d = pt - ps
    c1 = torch.linalg.cross(pt, ns, dim=-1)
    c2 = torch.linalg.cross(ps, nt, dim=-1)
    dn1 = torch.sum(d * ns, dim=-1)
    dn2 = torch.sum(d * nt, dim=-1)

    w = ok.to(torch.float32)
    x1 = torch.cat([c1, ns], dim=-1) * w[:, None]              # (N, 6)
    x2 = torch.cat([c2, nt], dim=-1) * w[:, None]

    JtJ = x1.T @ x1 + x2.T @ x2
    Jtr = x1.T @ (dn1 * w) + x2.T @ (dn2 * w)
    r = torch.sum((dn2 ** 2) * w)
    inliers = torch.sum(w)
    return JtJ, Jtr, r, inliers


def _precond_solve(JtJ: Tensor, Jtr: Tensor, damping: float = 1e-7,
                   abs_damping: float = 0.0):
    """Jacobi-preconditioned 6x6 solve: S (S JtJ S) S^-1 x = S Jtr, with an
    optional Tikhonov term `abs_damping` on the raw system. Returns
    (x, S, A)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(JtJ), min=1e-20))
    S = 1.0 / d
    A = JtJ * S[:, None] * S[None, :]
    A = A + torch.eye(6, dtype=JtJ.dtype, device=JtJ.device) * damping
    if abs_damping:
        A = A + torch.diag(abs_damping * S * S)
    # solve_ex: no error check, so no host sync; a singular A gives
    # non-finite entries, which the callers zero
    y, _ = torch.linalg.solve_ex(A, Jtr * S)
    return y * S, S, A


def _apply_solution(Xp: Tensor):
    """x = (rot_axis, tran) -> T_iter = R(theta)*T(tran*cos)*R(theta)."""
    rot_axis = Xp[0:3]
    tran = Xp[3:6]
    nrm = torch.linalg.norm(rot_axis)
    angle = 0.5 * torch.arctan(nrm)
    axis = rot_axis / torch.clamp(nrm, min=1e-12)
    Rh = axis_angle_to_mat(axis, angle)
    tc = tran * torch.cos(angle)
    R_iter = orthonormalize(Rh @ Rh)
    t_iter = Rh @ tc
    return R_iter, t_iter


def symmetric_icp(model: Supersurfels, nb_visible: Tensor,
                  target_maps: Tensor, R_view: Tensor, t_view: Tensor,
                  cam: CameraIntrinsics, cfg: ICPConfig,
                  mesh=None) -> ICPResult:
    """Frame-to-model refinement. `model` is in world frame; (R_view,
    t_view) is the current world->camera estimate. Returns the relative
    camera-frame correction (R_rel, t_rel).

    `mesh` (`parallel/mesh.py`): `model` is this rank's block of the
    capacity-sharded model and `nb_visible` its local visible count; each
    iteration sums the normal equations (JtJ, Jtr, r, inliers) over the
    ranks in one collective, so every rank takes the same step. Without
    it nothing changes."""
    dev = model.positions.device
    N = model.capacity
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    src_mask = (ids < nb_visible) & (model.confidences > 0.0)
    src_lab = rgb_to_lab(model.colors)
    src_normal = model.orientations[:, 2, :]

    it = torch.zeros((), dtype=torch.int32, device=dev)
    R_inc = torch.eye(3, dtype=torch.float32, device=dev)
    t_inc = torch.zeros(3, dtype=torch.float32, device=dev)
    prev_err = torch.full((), float(np.finfo(np.float32).max),
                          dtype=torch.float32, device=dev)
    JtJ_k = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    inl_k = torch.zeros((), dtype=torch.float32, device=dev)
    enough_k = torch.ones((), dtype=torch.bool, device=dev)
    cont = torch.ones((), dtype=torch.bool, device=dev)

    for _ in range(cfg.nb_iters):
        R_c = R_inc @ R_view
        t_c = R_inc @ t_view + t_inc
        JtJ, Jtr, r, inl = _build_system(
            model.positions, src_normal, src_lab, src_mask, target_maps,
            R_c, t_c, cam, cfg)
        if mesh is not None:
            JtJ, Jtr, r, inl = psum_packed((JtJ, Jtr, r, inl), mesh)
        err = torch.sqrt(r / torch.clamp(inl, min=1.0))
        enough = inl >= cfg.min_inliers
        Xp, _, _ = _precond_solve(JtJ, Jtr, abs_damping=cfg.solve_damping)
        Xp = torch.where(torch.isfinite(Xp), Xp, torch.zeros_like(Xp))
        R_it, t_it = _apply_solution(Xp)
        R_new = torch.where(enough, R_it @ R_inc, R_inc)
        t_new = torch.where(enough, R_it @ t_inc + t_it, t_inc)
        improving = (err / torch.clamp(prev_err, min=1e-20)) \
            <= cfg.rel_error_break
        # the while-loop body runs only while `cont`: freeze everything after
        R_inc = torch.where(cont, R_new, R_inc)
        t_inc = torch.where(cont, t_new, t_inc)
        prev_err = torch.where(cont, err, prev_err)
        JtJ_k = torch.where(cont, JtJ, JtJ_k)
        inl_k = torch.where(cont, inl, inl_k)
        enough_k = torch.where(cont, enough, enough_k)
        it = it + cont.to(torch.int32)
        cont = cont & enough & improving

    err, JtJ, inl, enough = prev_err, JtJ_k, inl_k, enough_k
    _, S, A = _precond_solve(JtJ, torch.zeros(6, dtype=JtJ.dtype, device=dev),
                             abs_damping=cfg.solve_damping)
    Ainv, _ = torch.linalg.inv_ex(A)
    cov_diag = torch.diagonal(Ainv) * S * S
    cov_ok = torch.all(cov_diag < cfg.cov_thresh) & torch.all(
        torch.isfinite(cov_diag))
    t_ok = torch.linalg.norm(t_inc) <= cfg.max_translation
    ran = it > 0
    valid = enough & cov_ok & t_ok & ran
    code = (enough.to(torch.int32) + 2 * cov_ok.to(torch.int32)
            + 4 * t_ok.to(torch.int32) + 8 * ran.to(torch.int32))

    R_rel = R_inc.T
    t_rel = -(R_rel @ t_inc)
    return ICPResult(R_rel=R_rel, t_rel=t_rel, valid=valid, inliers=inl,
                     error=err, code=code, cov_diag=cov_diag, iters=it)

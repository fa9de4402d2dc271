# Frozen copy of supersurfel_fusion_tpu_torch/ops/vo.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test. `reset_local_map`, which only
# loop closure calls, is left out.
"""Sparse visual odometry: persistent 3D local map + robust motion-only PnP.

Port of `supersurfel_fusion_tpu/ops/vo.py` (a rewrite of SparseVO,
LocalMap and PnPSolver): a fixed-capacity local-map SoA updated with masked
writes and a stable compaction, brute-force Hamming matching + GMS + a pixel
gate, and a Cauchy-robust Gauss-Newton PnP (nb_passes x nb_gn_iters).
JAX's `mode="drop"` scatters become writes into a sentinel row.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slam_bench.reference.config import CameraIntrinsics, VOConfig
from slam_bench.reference.ops.features import Keypoints
from slam_bench.reference.ops.fusion import scatter_set_drop
from slam_bench.reference.ops.icp import _precond_solve
from slam_bench.reference.ops.matching import (
    gms_filter,
    match_bruteforce,
)
from slam_bench.reference.utils.geometry import (
    axis_angle_to_mat,
    orthonormalize,
)

Tensor = torch.Tensor


class LocalMap(NamedTuple):
    positions: Tensor     # (M, 3) world frame
    desc: Tensor          # (M, 8) int32 descriptor words
    counters: Tensor      # (M,) int32 untracked counters
    valid: Tensor         # (M,) bool

    @staticmethod
    def empty(m: int, device) -> "LocalMap":
        return LocalMap(
            positions=torch.zeros((m, 3), dtype=torch.float32, device=device),
            desc=torch.zeros((m, 8), dtype=torch.int32, device=device),
            counters=torch.zeros((m,), dtype=torch.int32, device=device),
            valid=torch.zeros((m,), dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]


class VOMatches(NamedTuple):
    map_pos: Tensor       # (K, 3) matched map point (world)
    kp_xy: Tensor         # (K, 2) matched keypoint pixel
    map_idx: Tensor       # (K,) int32 matched map slot or -1
    ok: Tensor            # (K,) bool
    n: Tensor             # () int32


def _pixel_of(xy: Tensor, H: int, W: int):
    ui = torch.clamp(torch.round(xy[:, 0]), 0, W - 1).to(torch.int64)
    vi = torch.clamp(torch.round(xy[:, 1]), 0, H - 1).to(torch.int64)
    return ui, vi


def find_matches(lmap: LocalMap, kp: Keypoints, R: Tensor, t: Tensor,
                 cam: CameraIntrinsics, cfg: VOConfig
                 ) -> Tuple[VOMatches, LocalMap]:
    """Match frame keypoints against visible local-map points ((R, t) is
    camera->world), with the counter++ / counter-- bookkeeping."""
    Rv = R.T
    tv = -(Rv @ t)
    p_view = lmap.positions @ Rv.T + tv
    z = p_view[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = p_view[:, 0] * cam.fx / safe_z + cam.cx
    v = p_view[:, 1] * cam.fy / safe_z + cam.cy
    vis = (lmap.valid & (z >= 0.2) & (z <= 5.0)
           & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height))
    proj = torch.stack([u, v], dim=-1)

    counters = torch.where(lmap.valid, lmap.counters + 1, lmap.counters)

    midx, _, mok = match_bruteforce(kp.desc, kp.valid, lmap.desc, vis)
    midx = midx.to(torch.int64)
    mxy = proj[midx]
    inl = gms_filter(kp.xy, mxy, mok, float(cam.width), float(cam.height))
    px_dist = torch.linalg.norm(kp.xy - mxy, dim=-1)
    ok = inl & (px_dist < cfg.match_max_px_dist)

    M = lmap.capacity
    dec = torch.zeros((M + 1,), dtype=torch.int32, device=t.device)
    dec = dec.index_add_(0, torch.where(ok, midx, torch.full_like(midx, M)),
                         torch.ones_like(midx, dtype=torch.int32))[:M]
    counters = counters - dec

    matches = VOMatches(
        map_pos=lmap.positions[midx],
        kp_xy=kp.xy,
        map_idx=torch.where(ok, midx, torch.full_like(midx, -1)).to(
            torch.int32),
        ok=ok,
        n=torch.sum(ok.to(torch.int32)),
    )
    return matches, lmap._replace(counters=counters)


def _pnp_system(R: Tensor, t: Tensor, p3d: Tensor, uv: Tensor,
                w_mask: Tensor, cam: CameraIntrinsics, delta2: float):
    """Gauss-Newton normal equations of the reprojection objective with
    Cauchy IRLS weights; left-multiplied view increment exp([v, w])."""
    Rv = R.T
    tv = -(Rv @ t)
    pc = p3d @ Rv.T + tv
    z = torch.clamp(pc[:, 2], min=1e-6)
    u_hat = pc[:, 0] * cam.fx / z + cam.cx
    v_hat = pc[:, 1] * cam.fy / z + cam.cy
    r_u = u_hat - uv[:, 0]
    r_v = v_hat - uv[:, 1]
    chi2 = r_u**2 + r_v**2

    w_cauchy = 1.0 / (1.0 + chi2 / delta2)
    w = torch.where(w_mask & (pc[:, 2] > 0.05), w_cauchy,
                    torch.zeros_like(w_cauchy))

    x, y = pc[:, 0], pc[:, 1]
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    du = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1)
    dv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1)

    def cross_cols(dd):
        cx_ = dd[:, 1] * pc[:, 2] - dd[:, 2] * pc[:, 1]
        cy_ = dd[:, 2] * pc[:, 0] - dd[:, 0] * pc[:, 2]
        cz_ = dd[:, 0] * pc[:, 1] - dd[:, 1] * pc[:, 0]
        return torch.stack([-cx_, -cy_, -cz_], -1)

    Ju = torch.cat([du, cross_cols(du)], dim=-1)
    Jv = torch.cat([dv, cross_cols(dv)], dim=-1)
    Juw = Ju * w[:, None]
    Jvw = Jv * w[:, None]
    JtJ = Juw.T @ Ju + Jvw.T @ Jv
    Jtr = Juw.T @ r_u + Jvw.T @ r_v
    return JtJ, Jtr, chi2


def pnp_solve(R0: Tensor, t0: Tensor, p3d: Tensor, uv: Tensor, ok: Tensor,
              cam: CameraIntrinsics, cfg: VOConfig):
    """Robust motion-only pose solve. Returns (R, t, valid, inlier_mask)."""
    delta2 = cfg.chi2_threshold
    R, t, active = R0, t0, ok
    for _ in range(cfg.nb_passes):
        for _ in range(cfg.nb_gn_iters):
            JtJ, Jtr, _ = _pnp_system(R, t, p3d, uv, active, cam, delta2)
            dx, _, _ = _precond_solve(JtJ, -Jtr, damping=1e-6)
            dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
            dv_, dw = dx[:3], dx[3:]
            ang = torch.linalg.norm(dw)
            axis = dw / torch.clamp(ang, min=1e-12)
            dR = axis_angle_to_mat(axis, ang)
            Rv = R.T
            tv = -(Rv @ t)
            Rv_new = dR @ Rv
            tv_new = dR @ tv + dv_
            R = orthonormalize(Rv_new.T)
            t = -(R @ tv_new)
        _, _, chi2 = _pnp_system(R, t, p3d, uv, active, cam, delta2)
        active = active & (chi2 <= cfg.chi2_threshold)

    n_in = torch.sum(active.to(torch.int32))
    n_all = torch.clamp(torch.sum(ok.to(torch.int32)), min=1)
    jump = torch.linalg.norm(t - t0)
    valid = ((n_in.to(torch.float32)
              >= cfg.min_inlier_ratio * n_all.to(torch.float32))
             & (jump < cfg.max_translation_jump)
             & torch.all(torch.isfinite(t)))
    return (torch.where(valid, R, R0), torch.where(valid, t, t0), valid,
            active)


def _keypoints_world(kp: Keypoints, depth0: Tensor, R: Tensor, t: Tensor,
                     cam: CameraIntrinsics):
    H, W = depth0.shape
    ui, vi = _pixel_of(kp.xy, H, W)
    z = depth0[vi, ui]
    p_cam = torch.stack(
        [z * (kp.xy[:, 0] - cam.cx) / cam.fx,
         z * (kp.xy[:, 1] - cam.cy) / cam.fy, z], dim=-1)
    return z, p_cam @ R.T + t


def update_local_map(lmap: LocalMap, kp: Keypoints, depth0: Tensor,
                     matches: VOMatches, R: Tensor, t: Tensor,
                     cam: CameraIntrinsics, cfg: VOConfig,
                     static_kp: Tensor | None = None,
                     labels: Tensor | None = None,
                     static_sp: Tensor | None = None) -> LocalMap:
    """Replace matched map points, evict untracked ones, insert unmatched
    new points into free slots in a stable order (LocalMap::update +
    clean).

    `static_kp`: optional per-keypoint static mask (MOD path).
    `labels`/`static_sp`: when given (MOD path), existing map points whose
    projection lands on a dynamic superpixel are evicted, so that a mover
    that slipped into the map does not keep feeding PnP
    (LocalMap::updateMOD)."""
    M = lmap.capacity
    dev = t.device
    H, W = depth0.shape
    z, p_world = _keypoints_world(kp, depth0, R, t, cam)
    has_depth = kp.valid & (z >= 0.2) & (z <= 5.0)
    if static_kp is not None:
        has_depth = has_depth & static_kp
    midx = matches.map_idx.to(torch.int64)

    rep = has_depth & (midx >= 0)
    rep_tgt = torch.where(rep, midx, torch.full_like(midx, M))
    positions = scatter_set_drop(lmap.positions, rep_tgt, p_world)
    desc = scatter_set_drop(lmap.desc, rep_tgt, kp.desc)

    keep = lmap.valid & (lmap.counters < cfg.untracked_threshold)
    if labels is not None and static_sp is not None:
        # the map points as they were before this frame's replacements
        Rv = R.T
        tv = -(Rv @ t)
        p_view = lmap.positions @ Rv.T + tv
        zm = p_view[:, 2]
        safe_zm = torch.where(torch.abs(zm) > 1e-9, zm,
                              torch.full_like(zm, 1e-9))
        um = p_view[:, 0] * cam.fx / safe_zm + cam.cx
        vm = p_view[:, 1] * cam.fy / safe_zm + cam.cy
        in_img = ((zm > 0) & (um >= 0) & (um < cam.width) & (vm >= 0)
                  & (vm < cam.height))
        # a NaN pixel reads cell 0, as XLA's float-to-int conversion gives
        uv = torch.nan_to_num(torch.stack([um, vm], dim=-1), nan=0.0)
        ui_m, vi_m = _pixel_of(uv, H, W)
        on_dynamic = in_img & ~static_sp[labels[vi_m, ui_m].to(torch.int64)]
        keep = keep & ~on_dynamic

    ins = has_depth & (midx < 0)
    free = ~keep
    ins_rank = torch.cumsum(ins.to(torch.int64), 0) - 1
    # free slots first, each group in index order
    order = torch.argsort(torch.where(free, 0, 1), stable=True)
    n_free = torch.sum(free.to(torch.int64))
    ins_slot = torch.where(ins & (ins_rank < n_free),
                           order[torch.clamp(ins_rank, 0, M - 1)],
                           torch.full_like(ins_rank, M))
    positions = scatter_set_drop(positions, ins_slot, p_world)
    desc = scatter_set_drop(desc, ins_slot, kp.desc)
    # index_fill_ takes the value as a scalar argument; `t[idx] = True`
    # copies it from pageable host memory, which waits for the device
    inserted = torch.zeros((M + 1,), dtype=torch.bool, device=dev)
    inserted = inserted.index_fill_(0, ins_slot, True)[:M]

    valid = keep | inserted
    counters = torch.where(inserted, torch.zeros_like(lmap.counters),
                           lmap.counters)
    return LocalMap(positions=positions, desc=desc, counters=counters,
                    valid=valid)

"""SLAM orchestrator: the per-frame pipeline.

Port of `supersurfel_fusion_tpu/pipeline.py` (the equivalent of
`SupersurfelFusion::processFrame`) for the default configuration:

    depth bilateral filter -> disparity -> TPS superpixels -> plane smoothing
    -> slanted-plane depth -> supersurfel generation -> sparse VO ->
    symmetric ICP against the model -> fusion / insertion / filtering.

The frame step queues its work on the state's device and needs no host
sync. On a CUDA device the TPS iteration loop runs on the hand-written
kernels of `ops/tps_cuda.py`; on the CPU it runs the plain `ops/tps.py`.
Moving-object detection, ferns and loop closure are later slices of the
port: a configuration that enables them is refused. Each stage runs under a
`torch.profiler.record_function` range named "ssf.<stage>", which
`tools/profile_frame.py` reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.device import resolve_device
from supersurfel_fusion_tpu_torch.ops import fusion as fusion_ops
from supersurfel_fusion_tpu_torch.ops import icp as icp_ops
from supersurfel_fusion_tpu_torch.ops import tps as tps_ops
from supersurfel_fusion_tpu_torch.ops import tps_cuda
from supersurfel_fusion_tpu_torch.ops import vo as vo_ops
from supersurfel_fusion_tpu_torch.ops.depth import (
    bilateral_filter,
    depth_to_disp,
)
from supersurfel_fusion_tpu_torch.ops.features import detect_and_describe
from supersurfel_fusion_tpu_torch.ops.supersurfels import (
    generate_supersurfels,
)
from supersurfel_fusion_tpu_torch.types import ModelState, Pose, Supersurfels
from supersurfel_fusion_tpu_torch.utils.color import rgb_to_gray
from supersurfel_fusion_tpu_torch.utils.geometry import orthonormalize

Tensor = torch.Tensor


class SLAMState(NamedTuple):
    """The state carried across frames (the JAX SLAMState without the MOD,
    fern and keyframe-store fields, which come with their slices)."""

    model: ModelState
    pose: Pose               # camera -> world
    stamp: Tensor            # () int32
    local_map: vo_ops.LocalMap
    vis_peak: Tensor         # () int32 peak visible count
    dropped_total: Tensor    # () int32 insertions dropped at capacity
    # (max_frames, 12) float32 — per-frame pose [R.flat(9) | t(3)] written at
    # index `stamp` each step, read once after the run
    traj: Tensor


class FrameOutput(NamedTuple):
    pose: Pose
    vo_valid: Tensor
    vo_matches: Tensor
    icp_valid: Tensor
    icp_inliers: Tensor
    icp_error: Tensor
    icp_code: Tensor        # () int32 gate bitmask (ops/icp.py:ICPResult.code)
    icp_cov: Tensor         # (6,) pose covariance diagonal
    nb_supersurfels: Tensor
    nb_visible: Tensor
    labels: Tensor          # (H, W) superpixel index image
    plane_depth: Tensor     # (H, W) slanted-plane depth
    n_fused: Tensor
    n_inserted: Tensor
    n_removed: Tensor


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for the options this slice of the port does not run."""
    off = {
        "mod.enabled": cfg.mod.enabled,
        "ferns.enabled": cfg.ferns.enabled,
        "enable_loop_closure": cfg.enable_loop_closure,
        "fusion.freeze_on_tracking_loss": cfg.fusion.freeze_on_tracking_loss,
        "fusion.insert_requires_icp": cfg.fusion.insert_requires_icp,
    }
    on = [k for k, v in off.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


def init_state(cfg: PipelineConfig,
               device: str | torch.device = "cuda") -> SLAMState:
    check_supported(cfg)
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    model = ModelState(
        surfels=Supersurfels.empty(cfg.fusion.nb_supersurfels_max, dev),
        nb_supersurfels=torch.zeros((), **i32),
        nb_visible=torch.zeros((), **i32),
    )
    return SLAMState(
        model=model,
        pose=Pose.identity(dev),
        stamp=torch.zeros((), **i32),
        local_map=vo_ops.LocalMap.empty(cfg.vo.local_map_capacity, dev),
        vis_peak=torch.zeros((), **i32),
        dropped_total=torch.zeros((), **i32),
        traj=torch.zeros((cfg.max_frames, 12), dtype=torch.float32,
                         device=dev),
    )


def _segment(rgb: Tensor, disp: Tensor, cfg: PipelineConfig):
    if rgb.device.type == "cuda" and not cfg.tps.merge_every_phase:
        return tps_cuda.segment(rgb, disp, cfg.tps)
    return tps_ops.segment(rgb, disp, cfg.tps)


def _icp_step(state: SLAMState, frame: Supersurfels, labels: Tensor,
              plane_depth: Tensor, pose: Pose, cfg: PipelineConfig):
    """Dense ICP against the visible model prefix; the pose takes the
    correction where ICP is valid. Returns (ICPResult, pose)."""
    dev = labels.device
    if not cfg.enable_icp:
        f32 = dict(dtype=torch.float32, device=dev)
        icp = icp_ops.ICPResult(
            R_rel=torch.eye(3, **f32), t_rel=torch.zeros(3, **f32),
            valid=torch.zeros((), dtype=torch.bool, device=dev),
            inliers=torch.zeros((), **f32), error=torch.zeros((), **f32),
            code=torch.zeros((), dtype=torch.int32, device=dev),
            cov_diag=torch.zeros((6,), **f32))
        return icp, pose
    R_view = pose.R.T
    t_view = -(R_view @ pose.t)
    target_maps = icp_ops.build_target_maps(
        frame, labels, plane_depth, cfg.cam, cfg.tps.cell_size,
        cfg.fusion.range_min, cfg.fusion.range_max)
    vcap = min(cfg.fusion.visible_cap, cfg.fusion.nb_supersurfels_max)
    icp = icp_ops.symmetric_icp(
        state.model.surfels.prefix(vcap), state.model.nb_visible,
        target_maps, R_view, t_view, cfg.cam, cfg.icp)
    use = icp.valid & (state.model.nb_visible > 0)
    R_new = orthonormalize(pose.R @ icp.R_rel)
    t_new = pose.R @ icp.t_rel + pose.t
    return icp, Pose(torch.where(use, R_new, pose.R),
                     torch.where(use, t_new, pose.t))


def _upload(a, dev: torch.device) -> Tensor:
    """Host frame -> device. From pinned memory the copy is asynchronous,
    so the host can queue the frame's work without waiting for the GPU."""
    t = torch.as_tensor(a)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def process_frame(state: SLAMState, rgb, depth, cfg: PipelineConfig):
    """One SLAM step on the state's device.

    rgb: (H, W, 3) uint8 or float32 [0, 255]; depth: (H, W) raw uint16
    counts (scaled by cfg.depth_scale) or float32 metres (0 invalid), as
    numpy arrays or tensors. Integer inputs are converted on the device.
    Returns (new_state, outputs)."""
    check_supported(cfg)
    dev = state.stamp.device
    rgb = _upload(rgb, dev)
    depth = _upload(depth, dev)
    if rgb.dtype != torch.float32:
        rgb = rgb.to(torch.float32)
    if depth.dtype in (torch.uint16, torch.int32):
        depth = depth.to(torch.float32) * cfg.depth_scale
    elif depth.dtype != torch.float32:
        depth = depth.to(torch.float32)

    cam = cfg.cam
    cs = cfg.tps.cell_size
    gh, gw = cfg.grid_h, cfg.grid_w

    # 1. depth prefilter + disparity
    with record_function("ssf.depth"):
        fdepth = bilateral_filter(depth, cfg.bilateral_sigma_value,
                                  cfg.bilateral_sigma_space,
                                  cfg.bilateral_radius)
        disp = depth_to_disp(fdepth)

    # 2-5. TPS superpixels + plane smoothing + slanted-plane depth
    with record_function("ssf.tps"):
        tps = _segment(rgb, disp, cfg)
    with record_function("ssf.planes"):
        theta_s = tps_ops.smooth_planes(tps.stats, cfg.tps)
        tps = tps._replace(stats=tps.stats._replace(theta=theta_s))
        plane_depth = tps_ops.render_plane_depth(theta_s, tps.labels, gh, gw,
                                                 cs)

    # 6. supersurfel generation (camera frame)
    with record_function("ssf.supersurfels"):
        frame = generate_supersurfels(
            rgb, plane_depth, tps, cam, cfg.tps, cfg.generation,
            cfg.fusion.range_min, cfg.fusion.range_max, state.stamp)

    # 7-8. sparse feature VO
    pose = state.pose
    lmap = state.local_map
    if cfg.enable_sparse_vo:
        with record_function("ssf.features"):
            kp = detect_and_describe(rgb_to_gray(rgb), cfg.vo)
        with record_function("ssf.vo"):
            matches, lmap = vo_ops.find_matches(lmap, kp, pose.R, pose.t,
                                                cam, cfg.vo)
            R_vo, t_vo, pnp_ok, _ = vo_ops.pnp_solve(
                pose.R, pose.t, matches.map_pos, matches.kp_xy, matches.ok,
                cam, cfg.vo)
        vo_valid = pnp_ok & (matches.n >= cfg.vo.min_matches)
        pose = Pose(torch.where(vo_valid, R_vo, pose.R),
                    torch.where(vo_valid, t_vo, pose.t))
        vo_matches = matches.n
    else:
        vo_valid = torch.zeros((), dtype=torch.bool, device=dev)
        vo_matches = torch.zeros((), dtype=torch.int32, device=dev)

    # 9. dense symmetric ICP refinement against the visible model
    with record_function("ssf.icp"):
        icp, pose = _icp_step(state, frame, tps.labels, plane_depth, pose,
                              cfg)

    # 12. local-map maintenance with the final fused pose
    if cfg.enable_sparse_vo:
        with record_function("ssf.local_map"):
            lmap = vo_ops.update_local_map(lmap, kp, fdepth, matches, pose.R,
                                           pose.t, cam, cfg.vo)

    # 13. model update / bootstrap
    with record_function("ssf.fusion"):
        model, fusion_stats = fusion_ops.update_model(
            state.model, frame, tps.labels, plane_depth, pose.R, pose.t, cam,
            cfg.fusion, cfg.conf_thresh, state.stamp)

    # this frame's pose into the on-device trajectory ring (frames past
    # max_frames overwrite the last slot)
    traj_row = torch.cat([pose.R.reshape(9), pose.t]).to(torch.float32)
    slot = torch.clamp(state.stamp, max=cfg.max_frames - 1).to(torch.int64)
    traj = state.traj.index_copy(0, slot[None], traj_row[None])

    new_state = SLAMState(
        model=model, pose=pose, stamp=state.stamp + 1, local_map=lmap,
        vis_peak=torch.maximum(state.vis_peak, model.nb_visible),
        dropped_total=state.dropped_total + fusion_stats.n_dropped,
        traj=traj,
    )
    out = FrameOutput(
        pose=pose,
        vo_valid=vo_valid,
        vo_matches=vo_matches,
        icp_valid=icp.valid,
        icp_inliers=icp.inliers,
        icp_error=icp.error,
        icp_code=icp.code,
        icp_cov=icp.cov_diag,
        nb_supersurfels=model.nb_supersurfels,
        nb_visible=model.nb_visible,
        labels=tps.labels,
        plane_depth=plane_depth,
        n_fused=fusion_stats.n_fused,
        n_inserted=fusion_stats.n_inserted,
        n_removed=fusion_stats.n_removed,
    )
    return new_state, out


def mat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (qx, qy, qz, qw)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


class SupersurfelFusion:
    """Host-side runner: feeds numpy frames to `process_frame` and collects
    TUM-format poses."""

    def __init__(self, cfg: PipelineConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.state = init_state(cfg, device)
        self.stamps: list[float] = []

    def process(self, rgb: np.ndarray, depth: np.ndarray,
                timestamp: Optional[float] = None) -> FrameOutput:
        # integer encodings stay intact: process_frame converts on-device
        self.state, out = process_frame(self.state, rgb, depth, self.cfg)
        if timestamp is not None:
            self.stamps.append(timestamp)
        return out

    @property
    def trajectory(self) -> list:
        """TUM rows (tx ty tz qx qy qz qw), one per timestamped frame."""
        if not self.stamps:
            return []
        n = min(len(self.stamps), self.cfg.max_frames)
        traj = self.state.traj[:n].cpu().numpy().astype(np.float64)
        rows = [np.concatenate([row[9:12],
                                mat_to_quat_np(row[:9].reshape(3, 3))])
                for row in traj]
        rows += [rows[-1]] * (len(self.stamps) - n)
        return rows

    @property
    def pose(self) -> Pose:
        return self.state.pose

# Frozen copy of supersurfel_fusion_tpu_torch/pipeline.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test. Changes: `_segment` runs
# the plain TPS loop (`ops/tps.py`) on every device, where the program
# runs its CUDA kernels on a card; what the benchmark's configurations do
# not run is left out (ferns, loop closure and the deformation graph, the
# sharded step's hook, the host-side runner), and `init_state` refuses a
# configuration that turns ferns or loop closure on.
"""SLAM orchestrator: the per-frame pipeline.

Port of `supersurfel_fusion_tpu/pipeline.py` (the equivalent of
`SupersurfelFusion::processFrame`) for the default configuration:

    depth bilateral filter -> disparity -> TPS superpixels -> plane smoothing
    -> slanted-plane depth -> supersurfel generation -> [moving-object
    detection] -> sparse VO -> symmetric ICP against the model -> fusion /
    insertion / filtering.

The frame step queues its work on the state's device and needs no host
sync. On a CUDA device the TPS iteration loop runs on the hand-written
kernels of `ops/tps_cuda.py`; on the CPU it runs the plain `ops/tps.py`.
Moving-object detection (`mod.enabled`, with the person detector when
`mod.use_yolo` names weights) marks dynamic superpixels, which are kept
out of VO, ICP, fusion and the local map. The default-off options run as
in the JAX package:
temporal heat for MOD (`mod.temporal_heat`), and two protections against
tracking loss on frames whose ICP was gate-rejected against a live model
(`fusion.freeze_on_tracking_loss` keeps the whole model,
`fusion.insert_requires_icp` only skips insertion), both selects on the
device. Each stage runs under a `torch.profiler.record_function` range
named "ssf.<stage>".
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from slam_bench.reference.config import PipelineConfig
from slam_bench.reference.device import resolve_device
from slam_bench.reference.models.person_detector import (
    PersonDetector,
    load_detector,
)
from slam_bench.reference.ops import fusion as fusion_ops
from slam_bench.reference.ops import icp as icp_ops
from slam_bench.reference.ops import motion as motion_ops
from slam_bench.reference.ops import tps as tps_ops
from slam_bench.reference.ops import vo as vo_ops
from slam_bench.reference.ops.depth import (
    bilateral_filter,
    depth_to_disp,
)
from slam_bench.reference.ops.features import (
    Keypoints,
    detect_and_describe,
    keypoint_capacity,
)
from slam_bench.reference.ops.supersurfels import (
    generate_supersurfels,
)
from slam_bench.reference.types import ModelState, Pose, Supersurfels
from slam_bench.reference.utils.color import rgb_to_gray
from slam_bench.reference.utils.geometry import orthonormalize

Tensor = torch.Tensor


class SLAMState(NamedTuple):
    """The state carried across frames (the JAX SLAMState; the person
    detector takes the place of its parameter dict)."""

    model: ModelState
    pose: Pose               # camera -> world
    stamp: Tensor            # () int32
    local_map: vo_ops.LocalMap
    mod_prev: motion_ops.MODPrev
    vis_peak: Tensor         # () int32 peak visible count
    dropped_total: Tensor    # () int32 insertions dropped at capacity
    # (max_frames, 12) float32 — per-frame pose [R.flat(9) | t(3)] written at
    # index `stamp` each step, read once after the run
    traj: Tensor
    # the person detector with its weights (mod.use_yolo with a
    # weights_path), else None
    detector: Optional[PersonDetector] = None


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
    static_sp: Tensor       # (N_sp,) bool — False = detected as moving (MOD)
    n_fused: Tensor
    n_inserted: Tensor
    n_removed: Tensor


def init_state(cfg: PipelineConfig,
               device: str | torch.device = "cuda") -> SLAMState:
    if cfg.ferns.enabled or cfg.enable_loop_closure:
        raise NotImplementedError(
            "the benchmark's reference runs with ferns and loop closure "
            "off; their code is not part of it")
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    model = ModelState(
        surfels=Supersurfels.empty(cfg.fusion.nb_supersurfels_max, dev),
        nb_supersurfels=torch.zeros((), **i32),
        nb_visible=torch.zeros((), **i32),
    )
    kp_cap = keypoint_capacity(cfg.vo, cfg.cam.height, cfg.cam.width)
    # a missing weights file raises: there is no quiet fallback to the
    # simple path, which runs only when no weights are named
    detector = None
    if cfg.mod.enabled and cfg.mod.use_yolo and cfg.mod.weights_path:
        detector = load_detector(cfg.mod.weights_path, dev)
    return SLAMState(
        model=model,
        pose=Pose.identity(dev),
        stamp=torch.zeros((), **i32),
        local_map=vo_ops.LocalMap.empty(cfg.vo.local_map_capacity, dev),
        mod_prev=motion_ops.init_prev(cfg.cam.height, cfg.cam.width,
                                      kp_cap, cfg.tps.cell_size, dev),
        vis_peak=torch.zeros((), **i32),
        dropped_total=torch.zeros((), **i32),
        traj=torch.zeros((cfg.max_frames, 12), dtype=torch.float32,
                         device=dev),
        detector=detector,
    )


def _segment(rgb: Tensor, disp: Tensor, cfg: PipelineConfig):
    return tps_ops.segment(rgb, disp, cfg.tps)


def _target_maps(frame: Supersurfels, labels: Tensor, plane_depth: Tensor,
                 cfg: PipelineConfig) -> Tensor:
    return icp_ops.build_target_maps(
        frame, labels, plane_depth, cfg.cam, cfg.tps.cell_size,
        cfg.fusion.range_min, cfg.fusion.range_max)


def _icp_step(state: SLAMState, frame: Supersurfels, labels: Tensor,
              plane_depth: Tensor, pose: Pose, cfg: PipelineConfig):
    """Dense ICP against the visible model prefix; the pose takes the
    correction where ICP is valid. Returns (ICPResult, pose, the frame's
    target maps or None with ICP off)."""
    dev = labels.device
    if not cfg.enable_icp:
        f32 = dict(dtype=torch.float32, device=dev)
        icp = icp_ops.ICPResult(
            R_rel=torch.eye(3, **f32), t_rel=torch.zeros(3, **f32),
            valid=torch.zeros((), dtype=torch.bool, device=dev),
            inliers=torch.zeros((), **f32), error=torch.zeros((), **f32),
            code=torch.zeros((), dtype=torch.int32, device=dev),
            cov_diag=torch.zeros((6,), **f32))
        return icp, pose, None
    R_view = pose.R.T
    t_view = -(R_view @ pose.t)
    target_maps = _target_maps(frame, labels, plane_depth, cfg)
    vcap = min(cfg.fusion.visible_cap, cfg.fusion.nb_supersurfels_max)
    icp = icp_ops.symmetric_icp(
        state.model.surfels.prefix(vcap), state.model.nb_visible,
        target_maps, R_view, t_view, cfg.cam, cfg.icp)
    use = icp.valid & (state.model.nb_visible > 0)
    R_new = orthonormalize(pose.R @ icp.R_rel)
    t_new = pose.R @ icp.t_rel + pose.t
    return icp, Pose(torch.where(use, R_new, pose.R),
                     torch.where(use, t_new, pose.t)), target_maps


def _upload(a, dev: torch.device) -> Tensor:
    """Host frame -> device. From pinned memory the copy is asynchronous,
    so the host can queue the frame's work without waiting for the GPU."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()       # a decoded PNG: torch wants writable memory
    t = torch.as_tensor(a)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class FrontEnd(NamedTuple):
    fdepth: Tensor                 # (H, W) bilateral-filtered depth
    tps: tps_ops.TPSResult         # superpixels, with smoothed planes
    plane_depth: Tensor            # (H, W) slanted-plane depth
    frame: Supersurfels            # the frame's supersurfels (camera frame)


def front_end(rgb: Tensor, depth: Tensor, cfg: PipelineConfig,
              stamp: Tensor) -> FrontEnd:
    """Steps 1-6 of the frame step on float rgb (H, W, 3) and depth (H, W)
    metres: depth prefilter, TPS superpixels, plane smoothing,
    slanted-plane depth and supersurfel generation."""
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
            rgb, plane_depth, tps, cfg.cam, cfg.tps, cfg.generation,
            cfg.fusion.range_min, cfg.fusion.range_max, stamp)
    return FrontEnd(fdepth, tps, plane_depth, frame)


def frame_inputs(rgb, depth, cfg: PipelineConfig, dev: torch.device):
    """rgb (H, W, 3) and depth (H, W) as float32 tensors on `dev`, depth
    in metres: uint8/float rgb, raw uint16 depth counts (scaled by
    cfg.depth_scale) or float32 metres, as numpy arrays or tensors.
    Integer inputs are converted on the device."""
    rgb = _upload(rgb, dev)
    depth = _upload(depth, dev)
    if rgb.dtype != torch.float32:
        rgb = rgb.to(torch.float32)
    if depth.dtype in (torch.uint16, torch.int32):
        depth = depth.to(torch.float32) * cfg.depth_scale
    elif depth.dtype != torch.float32:
        depth = depth.to(torch.float32)
    return rgb, depth


class MotionVO(NamedTuple):
    frame: Supersurfels            # dynamic superpixels' confidence -1
    kp: Optional[Keypoints]        # keypoints (static ones valid), or None
    matches: Optional[vo_ops.VOMatches]  # VO matches, or None without VO
    local_map: vo_ops.LocalMap
    mod_prev: motion_ops.MODPrev
    pose: Pose                     # the VO pose
    vo_valid: Tensor
    vo_matches: Tensor
    is_static_sp: Tensor           # (N_sp,) bool


def motion_and_vo(rgb: Tensor, fe: FrontEnd, pose: Pose,
                  lmap: vo_ops.LocalMap, mod_prev: motion_ops.MODPrev,
                  detector: Optional[PersonDetector],
                  cfg: PipelineConfig) -> MotionVO:
    """Steps 7-8 of the frame step: moving-object detection and sparse
    feature VO."""
    dev = rgb.device
    cam = cfg.cam
    frame = fe.frame
    is_static_sp = torch.ones((cfg.nb_superpixels,), dtype=torch.bool,
                              device=dev)
    if not cfg.enable_sparse_vo:
        return MotionVO(frame, None, None, lmap, mod_prev, pose,
                        torch.zeros((), dtype=torch.bool, device=dev),
                        torch.zeros((), dtype=torch.int32, device=dev),
                        is_static_sp)
    with record_function("ssf.features"):
        gray = rgb_to_gray(rgb)
        kp = detect_and_describe(gray, cfg.vo)
    if cfg.mod.enabled:
        with record_function("ssf.mod"):
            # MOD reads the bilateral-filtered depth (keypoint 3D and the
            # SE(3) depth residual need metric depth at corners)
            is_static_sp, static_kp, mod_prev = motion_ops.detect_motion(
                gray, fe.fdepth, mod_prev, kp, frame, fe.tps, cam, cfg.tps,
                cfg.mod, detector=detector)
            # dynamic superpixels are kept out of fusion, ICP and VO
            frame = frame._replace(confidences=torch.where(
                is_static_sp, frame.confidences,
                torch.full_like(frame.confidences, -1.0)))
            kp = kp._replace(valid=static_kp)
    with record_function("ssf.vo"):
        matches, lmap = vo_ops.find_matches(lmap, kp, pose.R, pose.t, cam,
                                            cfg.vo)
        R_vo, t_vo, pnp_ok, _ = vo_ops.pnp_solve(
            pose.R, pose.t, matches.map_pos, matches.kp_xy, matches.ok, cam,
            cfg.vo)
    vo_valid = pnp_ok & (matches.n >= cfg.vo.min_matches)
    pose = Pose(torch.where(vo_valid, R_vo, pose.R),
                torch.where(vo_valid, t_vo, pose.t))
    return MotionVO(frame, kp, matches, lmap, mod_prev, pose, vo_valid,
                    matches.n, is_static_sp)


def update_local_map(mv: MotionVO, fdepth: Tensor, labels: Tensor,
                     pose: Pose, lmap: vo_ops.LocalMap,
                     cfg: PipelineConfig) -> vo_ops.LocalMap:
    """Step 12: local-map maintenance with the final fused pose."""
    if not cfg.enable_sparse_vo:
        return lmap
    with record_function("ssf.local_map"):
        mod_args = dict(labels=labels, static_sp=mv.is_static_sp) \
            if cfg.mod.enabled else {}
        return vo_ops.update_local_map(lmap, mv.kp, fdepth, mv.matches,
                                       pose.R, pose.t, cfg.cam, cfg.vo,
                                       **mod_args)


def process_frame(state: SLAMState, rgb, depth, cfg: PipelineConfig):
    """One SLAM step on the state's device.

    rgb: (H, W, 3) uint8 or float32 [0, 255]; depth: (H, W) raw uint16
    counts (scaled by cfg.depth_scale) or float32 metres (0 invalid), as
    numpy arrays or tensors. Integer inputs are converted on the device.
    Returns (new_state, outputs)."""
    dev = state.stamp.device
    rgb, depth = frame_inputs(rgb, depth, cfg, dev)

    cam = cfg.cam
    fe = front_end(rgb, depth, cfg, state.stamp)
    fdepth, tps, plane_depth = fe.fdepth, fe.tps, fe.plane_depth

    # 7-8. moving-object detection + sparse feature VO
    mv = motion_and_vo(rgb, fe, state.pose, state.local_map, state.mod_prev,
                       state.detector, cfg)
    frame, kp, pose, lmap = mv.frame, mv.kp, mv.pose, mv.local_map
    mod_prev, is_static_sp = mv.mod_prev, mv.is_static_sp
    vo_valid, vo_matches = mv.vo_valid, mv.vo_matches

    # 9. dense symmetric ICP refinement against the visible model
    with record_function("ssf.icp"):
        icp, pose, _ = _icp_step(state, frame, tps.labels,
                                           plane_depth, pose, cfg)

    # 10. local-map maintenance with the final fused pose
    lmap = update_local_map(mv, fdepth, tps.labels, pose, lmap, cfg)

    # 11. model update / bootstrap. Two default-off protections against
    # tracking loss, for frames whose ICP was gate-rejected against a live
    # model (the pose is VO-only and may drift): insert_requires_icp
    # inserts no new surfels while fusion, visibility and filtering stay
    # live; freeze_on_tracking_loss keeps the whole model and zeroes the
    # stats. Both are selects on the device, no host wait.
    model_in = state.model
    icp_ok = icp.valid | (state.model.nb_supersurfels == 0)
    gate_insert = cfg.fusion.insert_requires_icp and cfg.enable_icp
    with record_function("ssf.fusion"):
        model, fusion_stats = fusion_ops.update_model(
            model_in, frame, tps.labels, plane_depth, pose.R, pose.t, cam,
            cfg.fusion, cfg.conf_thresh, state.stamp,
            allow_insert=icp_ok if gate_insert else None)
        if cfg.fusion.freeze_on_tracking_loss and cfg.enable_icp:
            model, fusion_stats = fusion_ops.where_tree(
                icp_ok, (model, fusion_stats),
                (model_in, fusion_ops.FusionStats(*(
                    torch.zeros_like(v) for v in fusion_stats))))

    # this frame's pose into the on-device trajectory ring (frames past
    # max_frames overwrite the last slot)
    traj_row = torch.cat([pose.R.reshape(9), pose.t]).to(torch.float32)
    slot = torch.clamp(state.stamp, max=cfg.max_frames - 1).to(torch.int64)
    traj = state.traj.index_copy(0, slot[None], traj_row[None])

    new_state = SLAMState(
        model=model, pose=pose, stamp=state.stamp + 1, local_map=lmap,
        mod_prev=mod_prev,
        vis_peak=torch.maximum(state.vis_peak, model.nb_visible),
        dropped_total=state.dropped_total + fusion_stats.n_dropped,
        traj=traj,
        detector=state.detector,
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
        static_sp=is_static_sp,
        n_fused=fusion_stats.n_fused,
        n_inserted=fusion_stats.n_inserted,
        n_removed=fusion_stats.n_removed,
    )
    return new_state, out

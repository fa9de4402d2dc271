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
out of VO, ICP, fusion and the local map. Ferns (`ferns.enabled`) look
each frame up among the keyframes and store new ones; loop closure
(`enable_loop_closure`) then relocalizes a revisit against its keyframe
and deforms the map. The default-off options run as in the JAX package:
temporal heat for MOD (`mod.temporal_heat`), and two protections against
tracking loss on frames whose ICP was gate-rejected against a live model
(`fusion.freeze_on_tracking_loss` keeps the whole model,
`fusion.insert_requires_icp` only skips insertion), both selects on the
device. Each stage runs under a `torch.profiler.record_function` range
named "ssf.<stage>", which `tools/profile_frame.py` reads.

One step needs the host: with loop closure on, the frame step reads the
fern gate once per frame and runs `close_global_loop` only on a frame
where it fires (the JAX package's `lax.cond`). That is one host wait per
frame, and none with loop closure off.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.device import resolve_device
from supersurfel_fusion_tpu_torch.eval.trajectory import mat_to_quat_np
from supersurfel_fusion_tpu_torch.models.person_detector import (
    PersonDetector,
    load_detector,
)
from supersurfel_fusion_tpu_torch.ops import deformation
from supersurfel_fusion_tpu_torch.ops import ferns as ferns_ops
from supersurfel_fusion_tpu_torch.ops import fusion as fusion_ops
from supersurfel_fusion_tpu_torch.ops import icp as icp_ops
from supersurfel_fusion_tpu_torch.ops import loop_closure as lc_ops
from supersurfel_fusion_tpu_torch.ops import motion as motion_ops
from supersurfel_fusion_tpu_torch.ops import tps as tps_ops
from supersurfel_fusion_tpu_torch.ops import tps_cuda
from supersurfel_fusion_tpu_torch.ops import vo as vo_ops
from supersurfel_fusion_tpu_torch.ops.depth import (
    bilateral_filter,
    depth_to_disp,
)
from supersurfel_fusion_tpu_torch.ops.features import (
    Keypoints,
    detect_and_describe,
    keypoint_capacity,
)
from supersurfel_fusion_tpu_torch.ops.supersurfels import (
    generate_supersurfels,
)
from supersurfel_fusion_tpu_torch.types import ModelState, Pose, Supersurfels
from supersurfel_fusion_tpu_torch.utils.color import rgb_to_gray
from supersurfel_fusion_tpu_torch.utils.geometry import orthonormalize

Tensor = torch.Tensor


class SLAMState(NamedTuple):
    """The state carried across frames (the JAX SLAMState; the person
    detector takes the place of its parameter dict)."""

    model: ModelState
    pose: Pose               # camera -> world
    stamp: Tensor            # () int32
    local_map: vo_ops.LocalMap
    mod_prev: motion_ops.MODPrev
    kf_store: lc_ops.KeyframeStore
    prev_fern_id: Tensor     # () int32
    last_lc_stamp: Tensor    # () int32
    lc_count: Tensor         # () int32 accepted loop closures
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
    # with ferns on: the best keyframe, whether the frame is a new one
    fern_id: Optional[Tensor] = None     # () int32
    fern_new: Optional[Tensor] = None    # () bool
    # with loop closure on: the gate (read on the host) and the verdict
    lc_gate: Optional[bool] = None
    lc_accepted: Optional[Tensor] = None  # () bool


def init_state(cfg: PipelineConfig,
               device: str | torch.device = "cuda") -> SLAMState:
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
    if cfg.enable_loop_closure and cfg.enable_sparse_vo \
            and dev.type == "cuda":
        deformation.warm_up(dev)
    return SLAMState(
        model=model,
        pose=Pose.identity(dev),
        stamp=torch.zeros((), **i32),
        local_map=vo_ops.LocalMap.empty(cfg.vo.local_map_capacity, dev),
        mod_prev=motion_ops.init_prev(cfg.cam.height, cfg.cam.width,
                                      kp_cap, cfg.tps.cell_size, dev),
        kf_store=lc_ops.KeyframeStore.empty(
            cfg.ferns.max_keyframes, cfg.ferns.nb_ferns, kp_cap,
            cfg.nb_superpixels, dev),
        prev_fern_id=torch.full((), -1, **i32),
        last_lc_stamp=torch.full((), -(10**6), **i32),
        lc_count=torch.zeros((), **i32),
        vis_peak=torch.zeros((), **i32),
        dropped_total=torch.zeros((), **i32),
        traj=torch.zeros((cfg.max_frames, 12), dtype=torch.float32,
                         device=dev),
        detector=detector,
    )


def _segment(rgb: Tensor, disp: Tensor, cfg: PipelineConfig):
    if rgb.device.type == "cuda" and not cfg.tps.merge_every_phase:
        return tps_cuda.segment(rgb, disp, cfg.tps)
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


def keypoints_3d(kp, fdepth: Tensor, cfg: PipelineConfig):
    """Keypoint 3D positions (camera frame) from the filtered depth, and
    whether their depth is in range (computeFilteredKeypoints3D)."""
    cam = cfg.cam
    ui = torch.clamp(torch.round(kp.xy[:, 0]).to(torch.int64), 0,
                     cam.width - 1)
    vi = torch.clamp(torch.round(kp.xy[:, 1]).to(torch.int64), 0,
                     cam.height - 1)
    zk = fdepth[vi, ui]
    ok = (zk >= cfg.fusion.range_min) & (zk <= cfg.fusion.range_max)
    p3d = torch.stack([zk * (kp.xy[:, 0] - cam.cx) / cam.fx,
                       zk * (kp.xy[:, 1] - cam.cy) / cam.fy, zk], dim=-1)
    return p3d, ok


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
                  detector: Optional[PersonDetector], cfg: PipelineConfig,
                  agree=None) -> MotionVO:
    """Steps 7-8 of the frame step: moving-object detection and sparse
    feature VO. `agree`, if given, maps MOD's (is_static_sp, static_kp)
    (and with temporal heat the new heat map) to the values every rank of
    a sharded step uses."""
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
            if agree is not None:
                is_static_sp, static_kp, heat = agree(
                    is_static_sp, static_kp,
                    mod_prev.heat if cfg.mod.temporal_heat else None)
                mod_prev = mod_prev._replace(kp_valid=static_kp)
                if heat is not None:
                    mod_prev = mod_prev._replace(heat=heat)
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


def fern_codes(rgb: Tensor, fdepth: Tensor, cfg: PipelineConfig) -> Tensor:
    """The frame's (n_ferns,) fern codes."""
    cam = cfg.cam
    table = ferns_ops.make_fern_table(cfg.ferns, cam.width, cam.height,
                                      cfg.fusion.range_max, rgb.device)
    return ferns_ops.compute_codes(rgb, fdepth, *table,
                                   cfg.ferns.pyramid_level)


def reset_map_if(accepted: Tensor, kp, fdepth: Tensor, pose: Pose,
                 lmap: vo_ops.LocalMap,
                 cfg: PipelineConfig) -> vo_ops.LocalMap:
    """An accepted closure resets the VO local map at the corrected pose
    (a masked device update)."""
    reset_map = vo_ops.reset_local_map(kp, fdepth, pose.R, pose.t, cfg.cam,
                                       cfg.vo.local_map_capacity)
    return fusion_ops.where_tree(accepted, reset_map, lmap)


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
        icp, pose, target_maps = _icp_step(state, frame, tps.labels,
                                           plane_depth, pose, cfg)

    # 10-11. fern place recognition + global loop closure
    kf_store = state.kf_store
    prev_fern_id = state.prev_fern_id
    last_lc = state.last_lc_stamp
    lc_count = state.lc_count
    model_surfels = state.model.surfels
    fern_out = {}
    use_ferns = (cfg.ferns.enabled or cfg.enable_loop_closure) \
        and cfg.enable_sparse_vo
    if use_ferns:
        with record_function("ssf.ferns"):
            codes = fern_codes(rgb, fdepth, cfg)
            best_id, _, is_new = ferns_ops.query(kf_store.db, codes,
                                                 cfg.ferns.new_frame_thresh)
            kp_p3d, kp_depth_ok = keypoints_3d(kp, fdepth, cfg)
        fern_out = dict(fern_id=best_id, fern_new=is_new)
    if use_ferns and cfg.enable_loop_closure:
        with record_function("ssf.loop_closure"):
            db = kf_store.db
            gap = cfg.ferns.min_frame_gap
            kf_stamp_best = lc_ops.take_row(db.stamps, best_id)
            gate = (~is_new & (db.count > 0) & (best_id != prev_fern_id)
                    & (state.stamp - last_lc > gap)
                    & (state.stamp - kf_stamp_best > gap))
            # the one host wait of the frame step: the branch runs only
            # on a frame where the gate fires
            fire = bool(gate)
            accepted = torch.zeros((), dtype=torch.bool, device=dev)
            if fire:
                if target_maps is None:
                    target_maps = _target_maps(frame, tps.labels,
                                               plane_depth, cfg)
                lc = lc_ops.close_global_loop(
                    kf_store, best_id, model_surfels,
                    state.model.nb_supersurfels, frame, kp, kp_p3d,
                    kp_depth_ok, target_maps, pose, state.stamp, cam,
                    cfg.icp)
                accepted = lc.accepted
                pose = lc.pose
                model_surfels = lc.model
                kf_store = kf_store._replace(db=db._replace(
                    poses_R=lc.kf_poses_R, poses_t=lc.kf_poses_t))
                last_lc = torch.where(accepted, state.stamp, last_lc)
                lc_count = lc_count + accepted.to(torch.int32)
                lmap = reset_map_if(accepted, kp, fdepth, pose, lmap, cfg)
        fern_out.update(lc_gate=fire, lc_accepted=accepted)
    if use_ferns:
        # a new keyframe takes the next id (ferns.cu: bestKeyFrameId =
        # keyFrames.size())
        prev_fern_id = torch.where(is_new, kf_store.db.count, best_id)

    # 12. local-map maintenance with the final fused pose
    lmap = update_local_map(mv, fdepth, tps.labels, pose, lmap, cfg)

    # 13. model update / bootstrap. Two default-off protections against
    # tracking loss, for frames whose ICP was gate-rejected against a live
    # model (the pose is VO-only and may drift): insert_requires_icp
    # inserts no new surfels while fusion, visibility and filtering stay
    # live; freeze_on_tracking_loss keeps the whole model and zeroes the
    # stats. Both are selects on the device, no host wait.
    model_in = state.model._replace(surfels=model_surfels)
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

    # 14. new-keyframe snapshot (Ferns::addKeyFrame), masked on the device
    if use_ferns:
        with record_function("ssf.ferns"):
            kf_store = lc_ops.add_keyframe_payload(
                kf_store, codes, pose, state.stamp, kp, kp_p3d, kp_depth_ok,
                frame, when=is_new)

    # this frame's pose into the on-device trajectory ring (frames past
    # max_frames overwrite the last slot)
    traj_row = torch.cat([pose.R.reshape(9), pose.t]).to(torch.float32)
    slot = torch.clamp(state.stamp, max=cfg.max_frames - 1).to(torch.int64)
    traj = state.traj.index_copy(0, slot[None], traj_row[None])

    new_state = SLAMState(
        model=model, pose=pose, stamp=state.stamp + 1, local_map=lmap,
        mod_prev=mod_prev, kf_store=kf_store, prev_fern_id=prev_fern_id,
        last_lc_stamp=last_lc, lc_count=lc_count,
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
        **fern_out,
    )
    return new_state, out


class SupersurfelFusion:
    """Host-side runner: feeds numpy frames to `process_frame` and collects
    TUM-format poses."""

    def __init__(self, cfg: PipelineConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.state = init_state(cfg, device)
        self.stamps: list[float] = []
        self._cap_warned = False

    def process(self, rgb: np.ndarray, depth: np.ndarray,
                timestamp: Optional[float] = None) -> FrameOutput:
        # integer encodings stay intact: process_frame converts on-device
        self.state, out = process_frame(self.state, rgb, depth, self.cfg)
        if timestamp is not None:
            self.stamps.append(timestamp)
            if (len(self.stamps) > self.cfg.max_frames
                    and not self._cap_warned):
                self._cap_warned = True
                warnings.warn(
                    f"frame count exceeded PipelineConfig.max_frames="
                    f"{self.cfg.max_frames}; trajectory poses past the cap "
                    "overwrite the last slot", stacklevel=2)
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

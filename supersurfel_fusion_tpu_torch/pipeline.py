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
device. Each frame step is a frame span of the port's span recorder
(`tracing.py`); each stage in it is one function called through
`graphs.stage`, which opens its "ssf.<stage>" span and profiler range and
runs it op by op or, in `SupersurfelFusion` on a CUDA device, as a CUDA
graph (`graphs.py`, where `HOST_STAGES` names those whose Python runs
every frame). The benchmark (`slam_bench/`) reads both the ranges and
the spans.

One step needs the host: with loop closure on, the frame step reads the
fern gate once per frame and runs `close_global_loop` only on a frame
where it fires (the JAX package's `lax.cond`). That is one host wait per
frame, and none with loop closure off. A frame where it fires counts
`lc.gate` in the recorder, its closure records the parts
`lc.relocalise`, `lc.align` and `lc.deform` inside the `loop_closure`
stage, and its outputs hold the closure's map (`lc_model`) and arguments
(`lc_inputs`), so that the closure can be checked on its own inputs.
"""

from __future__ import annotations

import warnings
from contextlib import nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from supersurfel_fusion_tpu_torch import graphs, tracing
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


# the names of `close_global_loop`'s tensor arguments, in order
LC_INPUTS = ("store", "best_id", "model", "nb_supersurfels", "frame", "kp",
             "kp_p3d", "kp_depth_ok", "target_maps", "pose", "stamp")


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
    # on a frame whose gate fired: the positions of the model that
    # `close_global_loop` returned, before fusion compacts it, and the
    # tensor arguments it was called with, by name (the same tensors, not
    # copies); None on every other frame
    lc_model: Optional[Tensor] = None    # (capacity, 3)
    lc_inputs: Optional[dict] = None


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
    return SLAMState(
        model=model,
        kf_store=lc_ops.KeyframeStore.empty(
            cfg.ferns.max_keyframes, cfg.ferns.nb_ferns, kp_cap,
            cfg.nb_superpixels, dev),
        vis_peak=torch.zeros((), **i32),
        dropped_total=torch.zeros((), **i32),
        traj=torch.zeros((cfg.max_frames, 12), dtype=torch.float32,
                         device=dev),
        **init_carried(cfg, dev, kp_cap),
    )


def init_carried(cfg: PipelineConfig, dev: torch.device, kp_cap: int) -> dict:
    """The state fields the single-device and the sharded step start
    alike, the person detector among them (where `cfg` names its
    weights); with loop closure on a card, the graph solver warmed up."""
    i32 = dict(dtype=torch.int32, device=dev)
    # a missing weights file raises: there is no quiet fallback to the
    # simple path, which runs only when no weights are named
    detector = None
    if cfg.mod.enabled and cfg.mod.use_yolo and cfg.mod.weights_path:
        detector = load_detector(cfg.mod.weights_path, dev)
    if cfg.enable_loop_closure and cfg.enable_sparse_vo \
            and dev.type == "cuda":
        deformation.warm_up(dev)
    return dict(
        pose=Pose.identity(dev),
        stamp=torch.zeros((), **i32),
        local_map=vo_ops.LocalMap.empty(cfg.vo.local_map_capacity, dev),
        mod_prev=motion_ops.init_prev(cfg.cam.height, cfg.cam.width,
                                      kp_cap, cfg.tps.cell_size, dev),
        prev_fern_id=torch.full((), -1, **i32),
        last_lc_stamp=torch.full((), -(10**6), **i32),
        lc_count=torch.zeros((), **i32),
        detector=detector)


def _segment(rgb: Tensor, disp: Tensor, cfg: PipelineConfig):
    if rgb.device.type == "cuda" and not cfg.tps.merge_every_phase:
        return tps_cuda.segment(rgb, disp, cfg.tps)
    return tps_ops.segment(rgb, disp, cfg.tps)


def _target_maps(frame: Supersurfels, labels: Tensor, plane_depth: Tensor,
                 cfg: PipelineConfig) -> Tensor:
    return icp_ops.build_target_maps(
        frame, labels, plane_depth, cfg.cam, cfg.tps.cell_size,
        cfg.fusion.range_min, cfg.fusion.range_max)


def _icp_step(model: ModelState, frame: Supersurfels, labels: Tensor,
              plane_depth: Tensor, pose: Pose, cfg: PipelineConfig):
    """Stage icp: dense ICP against the visible model prefix; the pose
    takes the correction where ICP is valid. Returns (ICPResult, pose, the
    frame's target maps or None with ICP off)."""
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
    with tracing.span("icp.targets"):
        target_maps = _target_maps(frame, labels, plane_depth, cfg)
    vcap = min(cfg.fusion.visible_cap, cfg.fusion.nb_supersurfels_max)
    with tracing.span("icp.iterate"):
        icp = icp_ops.symmetric_icp(
            model.surfels.prefix(vcap), model.nb_visible,
            target_maps, R_view, t_view, cfg.cam, cfg.icp)
    use = icp.valid & (model.nb_visible > 0)
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


def _as_float(rgb: Tensor, depth: Tensor, cfg: PipelineConfig):
    """rgb and depth as float32, depth in metres (raw uint16 or int32
    counts scaled by cfg.depth_scale); float32 inputs pass unchanged."""
    if rgb.dtype != torch.float32:
        rgb = rgb.to(torch.float32)
    if depth.dtype in (torch.uint16, torch.int32):
        depth = depth.to(torch.float32) * cfg.depth_scale
    elif depth.dtype != torch.float32:
        depth = depth.to(torch.float32)
    return rgb, depth


class FrontEnd(NamedTuple):
    fdepth: Tensor                 # (H, W) bilateral-filtered depth
    tps: tps_ops.TPSResult         # superpixels, with smoothed planes
    plane_depth: Tensor            # (H, W) slanted-plane depth
    frame: Supersurfels            # the frame's supersurfels (camera frame)
    rgb: Optional[Tensor] = None   # (H, W, 3) float32 rgb


def _depth(rgb: Tensor, depth: Tensor, cfg: PipelineConfig):
    """Stage depth: the inputs as float32, the depth prefilter and the
    disparity. Returns (rgb, filtered depth, disparity)."""
    rgb, depth = _as_float(rgb, depth, cfg)
    fdepth = bilateral_filter(depth, cfg.bilateral_sigma_value,
                              cfg.bilateral_sigma_space, cfg.bilateral_radius)
    return rgb, fdepth, depth_to_disp(fdepth)


def _planes(tps: tps_ops.TPSResult, cfg: PipelineConfig):
    """Stage planes: plane smoothing and the slanted-plane depth. Returns
    (tps with the smoothed planes, plane depth)."""
    theta_s = tps_ops.smooth_planes(tps.stats, cfg.tps)
    tps = tps._replace(stats=tps.stats._replace(theta=theta_s))
    return tps, tps_ops.render_plane_depth(theta_s, tps.labels, cfg.grid_h,
                                           cfg.grid_w, cfg.tps.cell_size)


def front_end(rgb: Tensor, depth: Tensor, cfg: PipelineConfig,
              stamp: Tensor) -> FrontEnd:
    """Steps 1-6 of the frame step on rgb (H, W, 3) and depth (H, W) on the
    device (as `process_frame` takes them; integer inputs are converted in
    stage depth): depth prefilter, TPS superpixels, plane smoothing,
    slanted-plane depth and supersurfel generation."""
    # 1. depth prefilter + disparity
    rgb, fdepth, disp = graphs.stage("depth", _depth, rgb, depth, cfg)
    # 2-5. TPS superpixels + plane smoothing + slanted-plane depth
    tps = graphs.stage("tps", _segment, rgb, disp, cfg)
    tps, plane_depth = graphs.stage("planes", _planes, tps, cfg)
    # 6. supersurfel generation (camera frame)
    frame = graphs.stage(
        "supersurfels", generate_supersurfels, rgb, plane_depth, tps,
        cfg.cam, cfg.tps, cfg.generation, cfg.fusion.range_min,
        cfg.fusion.range_max, stamp)
    return FrontEnd(fdepth, tps, plane_depth, frame, rgb)


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
    frame = fe.frame
    is_static_sp = torch.ones((cfg.nb_superpixels,), dtype=torch.bool,
                              device=dev)
    if not cfg.enable_sparse_vo:
        return MotionVO(frame, None, None, lmap, mod_prev, pose,
                        torch.zeros((), dtype=torch.bool, device=dev),
                        torch.zeros((), dtype=torch.int32, device=dev),
                        is_static_sp)
    gray, kp = graphs.stage("features", _features, rgb, cfg)
    if cfg.mod.enabled:
        frame, kp, mod_prev, is_static_sp = graphs.stage(
            "mod", _mod, gray, fe.fdepth, mod_prev, kp, frame, fe.tps,
            detector, cfg, agree)
    matches, lmap, pose, vo_valid = graphs.stage("vo", _vo, kp, pose, lmap,
                                                 cfg)
    return MotionVO(frame, kp, matches, lmap, mod_prev, pose, vo_valid,
                    matches.n, is_static_sp)


def _features(rgb: Tensor, cfg: PipelineConfig):
    """Stage features: the grey image and its keypoints."""
    gray = rgb_to_gray(rgb)
    return gray, detect_and_describe(gray, cfg.vo)


def _mod(gray, fdepth, mod_prev, kp, frame, tps, detector, cfg, agree):
    """Stage mod: moving-object detection; dynamic superpixels and
    keypoints are kept out of fusion, ICP and VO. Returns (frame, kp,
    MOD context, is_static_sp)."""
    # MOD reads the bilateral-filtered depth (keypoint 3D and the SE(3)
    # depth residual need metric depth at corners)
    is_static_sp, static_kp, mod_prev = motion_ops.detect_motion(
        gray, fdepth, mod_prev, kp, frame, tps, cfg.cam, cfg.tps, cfg.mod,
        detector=detector)
    if agree is not None:
        is_static_sp, static_kp, heat = agree(
            is_static_sp, static_kp,
            mod_prev.heat if cfg.mod.temporal_heat else None)
        mod_prev = mod_prev._replace(kp_valid=static_kp)
        if heat is not None:
            mod_prev = mod_prev._replace(heat=heat)
    frame = frame._replace(confidences=torch.where(
        is_static_sp, frame.confidences,
        torch.full_like(frame.confidences, -1.0)))
    return frame, kp._replace(valid=static_kp), mod_prev, is_static_sp


def _vo(kp: Keypoints, pose: Pose, lmap: vo_ops.LocalMap,
        cfg: PipelineConfig):
    """Stage vo: matches against the local map and the PnP pose, taken
    where VO is valid. Returns (matches, local map, pose, VO valid)."""
    with tracing.span("vo.match"):
        matches, lmap = vo_ops.find_matches(lmap, kp, pose.R, pose.t,
                                            cfg.cam, cfg.vo)
    with tracing.span("vo.pnp"):
        R_vo, t_vo, pnp_ok, _ = vo_ops.pnp_solve(
            pose.R, pose.t, matches.map_pos, matches.kp_xy, matches.ok,
            cfg.cam, cfg.vo)
    vo_valid = pnp_ok & (matches.n >= cfg.vo.min_matches)
    pose = Pose(torch.where(vo_valid, R_vo, pose.R),
                torch.where(vo_valid, t_vo, pose.t))
    return matches, lmap, pose, vo_valid


def fern_codes(rgb: Tensor, fdepth: Tensor, cfg: PipelineConfig) -> Tensor:
    """The frame's (n_ferns,) fern codes."""
    cam = cfg.cam
    table = ferns_ops.make_fern_table(cfg.ferns, cam.width, cam.height,
                                      cfg.fusion.range_max, rgb.device)
    return ferns_ops.compute_codes(rgb, fdepth, *table,
                                   cfg.ferns.pyramid_level)


class FernLookup(NamedTuple):
    """What stage ferns finds of the frame (`keypoints_3d` for the last
    two)."""

    codes: Tensor        # (n_ferns,)
    best_id: Tensor      # () int32 the best keyframe
    is_new: Tensor       # () bool the frame is a new keyframe
    kp_p3d: Tensor
    kp_depth_ok: Tensor

    def gate(self, count: Tensor, kf_stamp: Tensor, prev_fern_id: Tensor,
             stamp: Tensor, last_lc: Tensor, gap: int) -> bool:
        """Whether frame `stamp` tries a loop closure, read on the host:
        the frame step's one wait. `kf_stamp`: the best keyframe's
        stamp."""
        return bool(~self.is_new & (count > 0)
                    & (self.best_id != prev_fern_id)
                    & (stamp - last_lc > gap) & (stamp - kf_stamp > gap))

    def next_id(self, count: Tensor) -> Tensor:
        """The next frame's `prev_fern_id`: a new keyframe takes the next
        id (ferns.cu: bestKeyFrameId = keyFrames.size())."""
        return torch.where(self.is_new, count, self.best_id)


def _ferns(rgb: Tensor, fdepth: Tensor, kp: Keypoints, db,
           cfg: PipelineConfig) -> FernLookup:
    """Stage ferns: the frame's codes looked up among the keyframes."""
    codes = fern_codes(rgb, fdepth, cfg)
    best_id, _, is_new = ferns_ops.query(db, codes,
                                         cfg.ferns.new_frame_thresh)
    return FernLookup(codes, best_id, is_new, *keypoints_3d(kp, fdepth, cfg))


class LoopCarry(NamedTuple):
    """The carried values a loop closure corrects."""

    pose: Pose
    surfels: Supersurfels    # the model (a sharded step: this rank's block)
    kf_store: lc_ops.KeyframeStore
    last_lc: Tensor          # () int32 stamp of the last accepted closure
    lc_count: Tensor         # () int32 accepted closures
    local_map: vo_ops.LocalMap

    def closed(self, lc: lc_ops.LoopClosureResult, stamp: Tensor,
               kp: Keypoints, fdepth: Tensor,
               cfg: PipelineConfig) -> "LoopCarry":
        """The carried values after the closure `lc` of frame `stamp`; an
        accepted one resets the VO local map at the corrected pose."""
        acc = lc.accepted
        kf_store = self.kf_store._replace(db=self.kf_store.db._replace(
            poses_R=lc.kf_poses_R, poses_t=lc.kf_poses_t))
        last_lc = torch.where(acc, stamp, self.last_lc)
        lc_count = self.lc_count + acc.to(torch.int32)
        reset = vo_ops.reset_local_map(kp, fdepth, *lc.pose, cfg.cam,
                                       cfg.vo.local_map_capacity)
        return LoopCarry(lc.pose, lc.model, kf_store, last_lc, lc_count,
                         fusion_ops.where_tree(acc, reset, self.local_map))


def _loop_closure(fl: FernLookup, c: LoopCarry, nb_supersurfels: Tensor,
                  prev_fern_id: Tensor, stamp: Tensor, frame: Supersurfels,
                  kp: Keypoints, fdepth: Tensor, labels: Tensor,
                  plane_depth: Tensor, target_maps: Optional[Tensor],
                  cfg: PipelineConfig):
    """Stage loop_closure: the closure where the fern gate fires (the JAX
    package's `lax.cond`). Returns (carried values, FrameOutput fields)."""
    db = c.kf_store.db
    fire = fl.gate(db.count, lc_ops.take_row(db.stamps, fl.best_id),
                   prev_fern_id, stamp, c.last_lc, cfg.ferns.min_frame_gap)
    accepted = torch.zeros((), dtype=torch.bool, device=stamp.device)
    if not fire:
        return c, dict(lc_gate=fire, lc_accepted=accepted)
    tracing.count("lc.gate")
    if target_maps is None:
        target_maps = _target_maps(frame, labels, plane_depth, cfg)
    lc_args = (c.kf_store, fl.best_id, c.surfels, nb_supersurfels, frame, kp,
               fl.kp_p3d, fl.kp_depth_ok, target_maps, c.pose, stamp)
    lc = lc_ops.close_global_loop(*lc_args, cfg.cam, cfg.icp)
    return c.closed(lc, stamp, kp, fdepth, cfg), dict(
        lc_gate=fire, lc_accepted=lc.accepted, lc_model=lc.model.positions,
        lc_inputs=dict(zip(LC_INPUTS, lc_args)))


def update_local_map(mv: MotionVO, fdepth: Tensor, labels: Tensor,
                     pose: Pose, lmap: vo_ops.LocalMap,
                     cfg: PipelineConfig) -> vo_ops.LocalMap:
    """Step 12: local-map maintenance with the final fused pose."""
    if not cfg.enable_sparse_vo:
        return lmap
    # MOD's labels and static superpixels (static_kp is not passed)
    mod = (labels, mv.is_static_sp) if cfg.mod.enabled else (None, None)
    return graphs.stage("local_map", vo_ops.update_local_map, lmap, mv.kp,
                        fdepth, mv.matches, pose.R, pose.t, cfg.cam, cfg.vo,
                        None, *mod)


def process_frame(state: SLAMState, rgb, depth, cfg: PipelineConfig):
    """One SLAM step on the state's device, recorded as one frame span.

    rgb: (H, W, 3) uint8 or float32 [0, 255]; depth: (H, W) raw uint16
    counts (scaled by cfg.depth_scale) or float32 metres (0 invalid), as
    numpy arrays or tensors. Integer inputs are converted on the device.
    Returns (new_state, outputs)."""
    with tracing.frame():
        return _step(state, rgb, depth, cfg)


def _fusion(model_in: ModelState, frame: Supersurfels, labels: Tensor,
            plane_depth: Tensor, pose: Pose, icp_valid: Tensor,
            stamp: Tensor, traj: Tensor, vis_peak: Tensor,
            dropped_total: Tensor, cfg: PipelineConfig):
    """Stage fusion: the model update / bootstrap, then this frame's pose
    into the on-device trajectory ring and the state's counters. Returns
    (model, fusion stats, next stamp, trajectory, peak visible, dropped
    total).

    Two default-off protections against tracking loss, for frames whose
    ICP was gate-rejected against a live model (the pose is VO-only and
    may drift): insert_requires_icp inserts no new surfels while fusion,
    visibility and filtering stay live; freeze_on_tracking_loss keeps the
    whole model and zeroes the stats. Both are selects on the device, no
    host wait."""
    icp_ok = icp_valid | (model_in.nb_supersurfels == 0)
    gate_insert = cfg.fusion.insert_requires_icp and cfg.enable_icp
    model, fusion_stats = fusion_ops.update_model(
        model_in, frame, labels, plane_depth, pose.R, pose.t, cfg.cam,
        cfg.fusion, cfg.conf_thresh, stamp,
        allow_insert=icp_ok if gate_insert else None)
    if cfg.fusion.freeze_on_tracking_loss and cfg.enable_icp:
        model, fusion_stats = fusion_ops.where_tree(
            icp_ok, (model, fusion_stats),
            (model_in, fusion_ops.FusionStats(*(
                torch.zeros_like(v) for v in fusion_stats))))
    # frames past max_frames overwrite the last slot of the ring
    traj_row = torch.cat([pose.R.reshape(9), pose.t]).to(torch.float32)
    slot = torch.clamp(stamp, max=cfg.max_frames - 1).to(torch.int64)
    traj = traj.index_copy(0, slot[None], traj_row[None])
    return (model, fusion_stats, stamp + 1, traj,
            torch.maximum(vis_peak, model.nb_visible),
            dropped_total + fusion_stats.n_dropped)


def _step(state: SLAMState, rgb, depth, cfg: PipelineConfig):
    dev = state.stamp.device
    rgb, depth = _upload(rgb, dev), _upload(depth, dev)

    fe = front_end(rgb, depth, cfg, state.stamp)
    rgb, fdepth, tps, plane_depth = fe.rgb, fe.fdepth, fe.tps, fe.plane_depth

    # 7-8. moving-object detection + sparse feature VO
    mv = motion_and_vo(rgb, fe, state.pose, state.local_map, state.mod_prev,
                       state.detector, cfg)
    frame, kp, pose = mv.frame, mv.kp, mv.pose

    # 9. dense symmetric ICP refinement against the visible model
    icp, pose, target_maps = graphs.stage("icp", _icp_step, state.model,
                                          frame, tps.labels, plane_depth,
                                          pose, cfg)

    # 10-11. fern place recognition + global loop closure
    use_ferns = (cfg.ferns.enabled or cfg.enable_loop_closure) \
        and cfg.enable_sparse_vo
    lc = LoopCarry(pose, state.model.surfels, state.kf_store,
                   state.last_lc_stamp, state.lc_count, mv.local_map)
    prev_fern_id = state.prev_fern_id
    fern_out = {}
    if use_ferns:
        fl = graphs.stage("ferns", _ferns, rgb, fdepth, kp,
                          state.kf_store.db, cfg)
        fern_out = dict(fern_id=fl.best_id, fern_new=fl.is_new)
        if cfg.enable_loop_closure:
            lc, out = graphs.stage(
                "loop_closure", _loop_closure, fl, lc,
                state.model.nb_supersurfels, prev_fern_id, state.stamp,
                frame, kp, fdepth, tps.labels, plane_depth, target_maps, cfg)
            fern_out.update(out)
        prev_fern_id = fl.next_id(lc.kf_store.db.count)
    pose, kf_store = lc.pose, lc.kf_store

    # 12. local-map maintenance with the final fused pose
    lmap = update_local_map(mv, fdepth, tps.labels, pose, lc.local_map, cfg)

    # 13. model update / bootstrap, the trajectory ring
    model, fusion_stats, stamp, traj, vis_peak, dropped_total = graphs.stage(
        "fusion", _fusion, state.model._replace(surfels=lc.surfels),
        frame, tps.labels, plane_depth, pose, icp.valid, state.stamp,
        state.traj, state.vis_peak, state.dropped_total, cfg)

    # 14. new-keyframe snapshot (Ferns::addKeyFrame), masked on the device
    if use_ferns:
        kf_store = graphs.stage(
            "ferns", lc_ops.add_keyframe_payload, kf_store, fl.codes, pose,
            state.stamp, kp, fl.kp_p3d, fl.kp_depth_ok, frame, fl.is_new)

    new_state = SLAMState(
        model=model, pose=pose, stamp=stamp, local_map=lmap,
        mod_prev=mv.mod_prev, kf_store=kf_store, prev_fern_id=prev_fern_id,
        last_lc_stamp=lc.last_lc, lc_count=lc.lc_count, vis_peak=vis_peak,
        dropped_total=dropped_total, traj=traj, detector=state.detector,
    )
    out = FrameOutput(
        pose=pose,
        vo_valid=mv.vo_valid,
        vo_matches=mv.vo_matches,
        icp_valid=icp.valid,
        icp_inliers=icp.inliers,
        icp_error=icp.error,
        icp_code=icp.code,
        icp_cov=icp.cov_diag,
        nb_supersurfels=model.nb_supersurfels,
        nb_visible=model.nb_visible,
        labels=tps.labels,
        plane_depth=plane_depth,
        static_sp=mv.is_static_sp,
        n_fused=fusion_stats.n_fused,
        n_inserted=fusion_stats.n_inserted,
        n_removed=fusion_stats.n_removed,
        **fern_out,
    )
    return new_state, out


class SupersurfelFusion:
    """Host-side runner: feeds numpy frames to `process_frame` and collects
    TUM-format poses. On a CUDA device the stages of its steps run as CUDA
    graphs (`graphs.py`), captured in the second frame; the state and the
    outputs it returns are never written by a later frame."""

    def __init__(self, cfg: PipelineConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.state = init_state(cfg, device)
        dev = self.state.stamp.device
        self.graphs = graphs.StageGraphs(dev) if dev.type == "cuda" else None
        self.stamps: list[float] = []
        self._cap_warned = False

    def process(self, rgb: np.ndarray, depth: np.ndarray,
                timestamp: Optional[float] = None) -> FrameOutput:
        # integer encodings stay intact: process_frame converts on-device.
        # It is called through the module, where a test may patch it.
        run = nullcontext() if self.graphs is None else self.graphs.step()
        with run:
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

    def graph_report(self, frames: list) -> dict:
        """How far the CUDA graphs engage: the stages and parts captured
        and the host ms of their capture (none on the CPU), and over the
        recorder's `frames` the mean stages and parts per frame replayed
        and run eagerly and the ops run eagerly between parts
        (`tracing.stage_counts`)."""
        rep = self.graphs.report() if self.graphs is not None \
            else {"captured": [], "capture_ms": 0.0}
        return {**rep, **tracing.stage_counts(frames)}

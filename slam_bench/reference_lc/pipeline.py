# Steps 10-14 copied from supersurfel_fusion_tpu_torch/pipeline.py
# (`_step`, `fern_codes`, `keypoints_3d`, `reset_map_if`, `init_state`'s
# keyframe store) and `reset_local_map` from its ops/vo.py, both at commit
# 193edc4, with their imports renamed: part of the loop-closure cell's
# plain reference, which imports nothing of the program under test. Steps
# 1-9 and 12 are the frozen reference's (`slam_bench/reference/pipeline.py`:
# the plain TPS loop on every device, the stages op by op); steps 10-11 run
# this package's ferns, loop closure and deformation graph. Departures from
# the C++ reference are those of the modules it calls: a rigid 3D-3D
# RANSAC for EPnP in the relocalisation (`ops/loop_closure.py`) and a dense
# float64 Cholesky solve for CHOLMOD in the graph (`ops/deformation.py`).
"""The frame step with fern place recognition and global loop closure, for
the benchmark's loop-closure cell.

Per frame: the frozen reference's front end, VO and ICP; then the frame's
fern codes and their lookup among the keyframes; the gate (a revisit of a
keyframe other than the last one looked up, more than `min_frame_gap`
frames after the keyframe and after the last accepted closure), read on
the host; on a frame where it fires, `close_global_loop` (relocalisation
against the keyframe, the dense alignment, the graph solve, the deformed
map and keyframe poses) and, where the closure is accepted, the VO local
map reset at the corrected pose; then the local map, fusion into the
(deformed) model, and the frame stored as a keyframe where it is new.

`FrameOutput.lc_model` holds, on a frame whose gate fired, the positions
of the model that the closure returned, before fusion compacts it, and
`lc_inputs` the closure's arguments by name (`LC_INPUTS`, then `cam` and
`icp_cfg`), as the program's outputs hold them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from slam_bench.reference import pipeline as base
from slam_bench.reference.config import PipelineConfig
from slam_bench.reference.device import resolve_device
from slam_bench.reference.ops import fusion as fusion_ops
from slam_bench.reference.ops import motion as motion_ops
from slam_bench.reference.ops import vo as vo_ops
from slam_bench.reference.ops.features import Keypoints, keypoint_capacity
from slam_bench.reference.types import ModelState, Pose
from slam_bench.reference_lc.ops import ferns as ferns_ops
from slam_bench.reference_lc.ops import loop_closure as lc_ops

Tensor = torch.Tensor


class SLAMState(NamedTuple):
    """The frozen reference's state with the keyframe store and the
    loop-closure counters (the program's field names)."""

    model: ModelState
    pose: Pose
    stamp: Tensor            # () int32
    local_map: vo_ops.LocalMap
    mod_prev: motion_ops.MODPrev
    kf_store: lc_ops.KeyframeStore
    prev_fern_id: Tensor     # () int32
    last_lc_stamp: Tensor    # () int32
    lc_count: Tensor         # () int32 accepted loop closures
    vis_peak: Tensor         # () int32
    dropped_total: Tensor    # () int32
    traj: Tensor             # (max_frames, 12) float32
    detector: Optional[object] = None


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
    icp_code: Tensor
    icp_cov: Tensor
    nb_supersurfels: Tensor
    nb_visible: Tensor
    labels: Tensor
    plane_depth: Tensor
    static_sp: Tensor
    n_fused: Tensor
    n_inserted: Tensor
    n_removed: Tensor
    fern_id: Optional[Tensor] = None     # () int32
    fern_new: Optional[Tensor] = None    # () bool
    lc_gate: Optional[bool] = None
    lc_accepted: Optional[Tensor] = None  # () bool
    # on a frame whose gate fired: the positions of the model that the
    # closure returned, and the closure's arguments
    lc_model: Optional[Tensor] = None    # (capacity, 3)
    lc_inputs: Optional[dict] = None


def init_state(cfg: PipelineConfig,
               device: str | torch.device = "cuda") -> SLAMState:
    """The frozen reference's initial state with an empty keyframe store
    (`ferns.max_keyframes` rows)."""
    dev = resolve_device(device)
    # the frozen reference refuses ferns and loop closure: its state is
    # built without them, and the keyframe store added here
    s = base.init_state(dataclasses.replace(
        cfg, ferns=dataclasses.replace(cfg.ferns, enabled=False),
        enable_loop_closure=False), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    kp_cap = keypoint_capacity(cfg.vo, cfg.cam.height, cfg.cam.width)
    return SLAMState(
        model=s.model, pose=s.pose, stamp=s.stamp, local_map=s.local_map,
        mod_prev=s.mod_prev,
        kf_store=lc_ops.KeyframeStore.empty(
            cfg.ferns.max_keyframes, cfg.ferns.nb_ferns, kp_cap,
            cfg.nb_superpixels, dev),
        prev_fern_id=torch.full((), -1, **i32),
        last_lc_stamp=torch.full((), -(10**6), **i32),
        lc_count=torch.zeros((), **i32),
        vis_peak=s.vis_peak, dropped_total=s.dropped_total, traj=s.traj,
        detector=s.detector)


def keypoints_3d(kp: Keypoints, fdepth: Tensor, cfg: PipelineConfig):
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


def fern_codes(rgb: Tensor, fdepth: Tensor, cfg: PipelineConfig) -> Tensor:
    """The frame's (n_ferns,) fern codes."""
    cam = cfg.cam
    table = ferns_ops.make_fern_table(cfg.ferns, cam.width, cam.height,
                                      cfg.fusion.range_max, rgb.device)
    return ferns_ops.compute_codes(rgb, fdepth, *table,
                                   cfg.ferns.pyramid_level)


def reset_local_map(kp: Keypoints, depth0: Tensor, R: Tensor, t: Tensor,
                    cam, m: int) -> vo_ops.LocalMap:
    """Rebuild the map from the current frame (LocalMap::reset)."""
    z, p_world = vo_ops._keypoints_world(kp, depth0, R, t, cam)
    good = kp.valid & (z >= 0.2) & (z <= 5.0)
    out = vo_ops.LocalMap.empty(m, t.device)
    k = min(kp.capacity, m)
    positions = out.positions.clone()
    positions[:k] = p_world[:k]
    desc = out.desc.clone()
    desc[:k] = kp.desc[:k]
    valid = out.valid.clone()
    valid[:k] = good[:k]
    return vo_ops.LocalMap(positions=positions, desc=desc,
                           counters=out.counters, valid=valid)


def reset_map_if(accepted: Tensor, kp: Keypoints, fdepth: Tensor,
                 pose: Pose, lmap: vo_ops.LocalMap,
                 cfg: PipelineConfig) -> vo_ops.LocalMap:
    """An accepted closure resets the VO local map at the corrected pose
    (a masked device update)."""
    reset = reset_local_map(kp, fdepth, pose.R, pose.t, cfg.cam,
                            cfg.vo.local_map_capacity)
    return fusion_ops.where_tree(accepted, reset, lmap)


def process_frame(state: SLAMState, rgb, depth, cfg: PipelineConfig):
    """One SLAM step on the state's device, ferns and loop closure on.
    Returns (new_state, outputs)."""
    if not (cfg.enable_sparse_vo and (cfg.ferns.enabled
                                      or cfg.enable_loop_closure)):
        raise ValueError("this reference runs ferns with sparse VO on")
    dev = state.stamp.device
    rgb, depth = base.frame_inputs(rgb, depth, cfg, dev)
    cam = cfg.cam
    fe = base.front_end(rgb, depth, cfg, state.stamp)
    fdepth, tps, plane_depth = fe.fdepth, fe.tps, fe.plane_depth

    # 7-8. moving-object detection + sparse feature VO
    mv = base.motion_and_vo(rgb, fe, state.pose, state.local_map,
                            state.mod_prev, state.detector, cfg)
    frame, kp, pose, lmap = mv.frame, mv.kp, mv.pose, mv.local_map

    # 9. dense symmetric ICP refinement against the visible model
    icp, pose, target_maps = base._icp_step(state, frame, tps.labels,
                                            plane_depth, pose, cfg)

    # 10. fern place recognition
    kf_store = state.kf_store
    last_lc, lc_count = state.last_lc_stamp, state.lc_count
    model_surfels = state.model.surfels
    codes = fern_codes(rgb, fdepth, cfg)
    best_id, _, is_new = ferns_ops.query(kf_store.db, codes,
                                         cfg.ferns.new_frame_thresh)
    kp_p3d, kp_depth_ok = keypoints_3d(kp, fdepth, cfg)
    lc_out = {}
    # 11. global loop closure where the gate (read on the host) fires
    if cfg.enable_loop_closure:
        db = kf_store.db
        gap = cfg.ferns.min_frame_gap
        kf_stamp_best = lc_ops.take_row(db.stamps, best_id)
        gate = (~is_new & (db.count > 0) & (best_id != state.prev_fern_id)
                & (state.stamp - last_lc > gap)
                & (state.stamp - kf_stamp_best > gap))
        fire = bool(gate)
        accepted = torch.zeros((), dtype=torch.bool, device=dev)
        lc_model = lc_inputs = None
        if fire:
            if target_maps is None:
                target_maps = base._target_maps(frame, tps.labels,
                                                plane_depth, cfg)
            lc_args = (kf_store, best_id, model_surfels,
                       state.model.nb_supersurfels, frame, kp, kp_p3d,
                       kp_depth_ok, target_maps, pose, state.stamp)
            lc = lc_ops.close_global_loop(*lc_args, cam, cfg.icp)
            lc_inputs = dict(zip(LC_INPUTS, lc_args), cam=cam,
                             icp_cfg=cfg.icp)
            accepted = lc.accepted
            pose = lc.pose
            model_surfels = lc.model
            lc_model = lc.model.positions
            kf_store = kf_store._replace(db=db._replace(
                poses_R=lc.kf_poses_R, poses_t=lc.kf_poses_t))
            last_lc = torch.where(accepted, state.stamp, last_lc)
            lc_count = lc_count + accepted.to(torch.int32)
            lmap = reset_map_if(accepted, kp, fdepth, pose, lmap, cfg)
        lc_out = dict(lc_gate=fire, lc_accepted=accepted, lc_model=lc_model,
                      lc_inputs=lc_inputs)
    # a new keyframe takes the next id (ferns.cu: bestKeyFrameId =
    # keyFrames.size())
    prev_fern_id = torch.where(is_new, kf_store.db.count, best_id)

    # 12. local-map maintenance with the final fused pose
    lmap = base.update_local_map(mv, fdepth, tps.labels, pose, lmap, cfg)

    # 13. model update / bootstrap into the (deformed) model, the
    # trajectory ring (the frozen reference's step 11)
    model_in = state.model._replace(surfels=model_surfels)
    icp_ok = icp.valid | (model_in.nb_supersurfels == 0)
    gate_insert = cfg.fusion.insert_requires_icp and cfg.enable_icp
    model, fusion_stats = fusion_ops.update_model(
        model_in, frame, tps.labels, plane_depth, pose.R, pose.t, cam,
        cfg.fusion, cfg.conf_thresh, state.stamp,
        allow_insert=icp_ok if gate_insert else None)
    if cfg.fusion.freeze_on_tracking_loss and cfg.enable_icp:
        model, fusion_stats = fusion_ops.where_tree(
            icp_ok, (model, fusion_stats),
            (model_in, fusion_ops.FusionStats(*(
                torch.zeros_like(v) for v in fusion_stats))))
    traj_row = torch.cat([pose.R.reshape(9), pose.t]).to(torch.float32)
    slot = torch.clamp(state.stamp, max=cfg.max_frames - 1).to(torch.int64)
    traj = state.traj.index_copy(0, slot[None], traj_row[None])

    # 14. new-keyframe snapshot (Ferns::addKeyFrame), masked on the device
    kf_store = lc_ops.add_keyframe_payload(
        kf_store, codes, pose, state.stamp, kp, kp_p3d, kp_depth_ok, frame,
        when=is_new)

    new_state = SLAMState(
        model=model, pose=pose, stamp=state.stamp + 1, local_map=lmap,
        mod_prev=mv.mod_prev, kf_store=kf_store, prev_fern_id=prev_fern_id,
        last_lc_stamp=last_lc, lc_count=lc_count,
        vis_peak=torch.maximum(state.vis_peak, model.nb_visible),
        dropped_total=state.dropped_total + fusion_stats.n_dropped,
        traj=traj, detector=state.detector)
    out = FrameOutput(
        pose=pose, vo_valid=mv.vo_valid, vo_matches=mv.vo_matches,
        icp_valid=icp.valid, icp_inliers=icp.inliers, icp_error=icp.error,
        icp_code=icp.code, icp_cov=icp.cov_diag,
        nb_supersurfels=model.nb_supersurfels, nb_visible=model.nb_visible,
        labels=tps.labels, plane_depth=plane_depth,
        static_sp=mv.is_static_sp, n_fused=fusion_stats.n_fused,
        n_inserted=fusion_stats.n_inserted,
        n_removed=fusion_stats.n_removed, fern_id=best_id, fern_new=is_new,
        **lc_out)
    return new_state, out

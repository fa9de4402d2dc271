"""The whole frame step over the "map" axis: the model and the keyframe
store sharded over the ranks of a process group.

Port of `supersurfel_fusion_tpu/parallel/pipeline_sharded.py`. The
global model (the array that grows with the scene) is block-sharded over
the ranks and the keyframe store round robin; the frame's images and
surfels are small and replicated. Every rank runs this step on its own
block, in its own process:

  replicated : the front half of `pipeline.py` (bilateral filter, TPS
               superpixels on the CUDA kernels, plane smoothing,
               slanted-plane depth, supersurfels), MOD, sparse VO, the
               fern codes
  sharded    : dense symmetric ICP, the 6x6 system summed over the ranks
               each iteration (`ops/icp.py` with a mesh)
  sharded    : the fern query over the sharded store (one int32 minimum)
               and the best keyframe's stamp (one int32 sum)
  sharded    : global loop closure on a frame where the gate fires: the
               keyframe's payload broadcast from its owner, the graph's
               nodes gathered from every rank, matching, RANSAC, ICP and
               the graph solve replicated, the deformation applied to each
               rank's block
  sharded    : model fusion, insertion, filtering and compaction
               (`parallel/sharding.py`: one int32 minimum)
  sharded    : the keyframe snapshot, stored on its owner rank

The loop-closure gate is read on the host once per frame (as in the
single-device step); it is computed from replicated values only (the
query's minimum, the summed stamp), so every rank takes the same branch.

Replicated values must be bit-identical on every rank, or the summed ICP
systems mix different poses. With MOD on and more than one rank, rank
0's MOD decision (which superpixels and keypoints are static, and with
`mod.temporal_heat` the heat map carried to the next frame) is broadcast
to all ranks: MOD's cluster statistics are float sums by atomic adds on
CUDA, whose rounding may differ between processes.

`fusion.freeze_on_tracking_loss` keeps every rank's block on a frame
whose ICP was gate-rejected against a live model, by a select with a
replicated predicate (the collectives stay out of divergent control
flow). `fusion.insert_requires_icp` is refused: the JAX package's sharded
step does not implement it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from supersurfel_fusion_tpu_torch import tracing
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.models.person_detector import (
    PersonDetector,
    load_detector,
)
from supersurfel_fusion_tpu_torch.ops import deformation
from supersurfel_fusion_tpu_torch.ops import icp as icp_ops
from supersurfel_fusion_tpu_torch.ops import loop_closure as lc_ops
from supersurfel_fusion_tpu_torch.ops import motion as motion_ops
from supersurfel_fusion_tpu_torch.ops import vo as vo_ops
from supersurfel_fusion_tpu_torch.ops.features import keypoint_capacity
from supersurfel_fusion_tpu_torch.ops.fusion import where_tree
from supersurfel_fusion_tpu_torch.parallel import kf_sharded as kf_sh
from supersurfel_fusion_tpu_torch.parallel.mesh import Mesh, psum
from supersurfel_fusion_tpu_torch.parallel.sharding import (
    DistributedModel,
    local_model_update,
    make_distributed_model,
)
from supersurfel_fusion_tpu_torch.pipeline import (
    _target_maps,
    fern_codes,
    frame_inputs,
    front_end,
    keypoints_3d,
    motion_and_vo,
    reset_map_if,
    update_local_map,
)
from supersurfel_fusion_tpu_torch.types import Pose
from supersurfel_fusion_tpu_torch.utils.geometry import orthonormalize

Tensor = torch.Tensor


class ShardedSLAMState(NamedTuple):
    """One rank's state. `model` and `kf_store` hold this rank's rows
    (the store's `db.count` is the replicated global count); everything
    else is replicated."""

    model: DistributedModel
    kf_store: lc_ops.KeyframeStore
    pose: Pose
    stamp: Tensor                # () int32
    local_map: vo_ops.LocalMap
    mod_prev: motion_ops.MODPrev
    prev_fern_id: Tensor         # () int32
    last_lc_stamp: Tensor        # () int32
    lc_count: Tensor             # () int32
    # () int32 visible surfels over all ranks after the last frame
    nb_visible_total: Tensor
    detector: Optional[PersonDetector] = None


class ShardedFrameOutput(NamedTuple):
    pose: Pose
    nb_total: Tensor            # () int32 live surfels over all ranks
    vo_valid: Tensor
    icp_valid: Tensor
    fern_id: Optional[Tensor] = None
    fern_new: Optional[Tensor] = None
    lc_gate: Optional[bool] = None
    lc_accepted: Optional[Tensor] = None


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for the option the sharded step does not run:
    `fusion.insert_requires_icp`, which the JAX package's sharded step
    does not implement either (it ignores the flag)."""
    if cfg.fusion.insert_requires_icp:
        raise NotImplementedError(
            "the sharded step does not run fusion.insert_requires_icp (the "
            "JAX package's sharded step lacks it)")


def init_sharded_state(cfg: PipelineConfig, mesh: Mesh) -> ShardedSLAMState:
    """This rank's empty state on the mesh's device. The model's and the
    keyframe store's capacities must divide by the number of ranks."""
    check_supported(cfg)
    dev = mesh.device
    i32 = dict(dtype=torch.int32, device=dev)
    kp_cap = keypoint_capacity(cfg.vo, cfg.cam.height, cfg.cam.width)
    rows = kf_sh.local_rows(cfg.ferns.max_keyframes, mesh.axis_size)
    detector = None
    if cfg.mod.enabled and cfg.mod.use_yolo and cfg.mod.weights_path:
        detector = load_detector(cfg.mod.weights_path, dev)
    if cfg.enable_loop_closure and cfg.enable_sparse_vo \
            and dev.type == "cuda":
        deformation.warm_up(dev)
    return ShardedSLAMState(
        model=make_distributed_model(cfg.fusion.nb_supersurfels_max, mesh),
        kf_store=lc_ops.KeyframeStore.empty(rows, cfg.ferns.nb_ferns, kp_cap,
                                            cfg.nb_superpixels, dev),
        pose=Pose.identity(dev),
        stamp=torch.zeros((), **i32),
        local_map=vo_ops.LocalMap.empty(cfg.vo.local_map_capacity, dev),
        mod_prev=motion_ops.init_prev(cfg.cam.height, cfg.cam.width, kp_cap,
                                      cfg.tps.cell_size, dev),
        prev_fern_id=torch.full((), -1, **i32),
        last_lc_stamp=torch.full((), -(10**6), **i32),
        lc_count=torch.zeros((), **i32),
        nb_visible_total=torch.zeros((), **i32),
        detector=detector,
    )


def _rank0(mesh: Mesh):
    """(is_static_sp, static_kp, heat or None) -> rank 0's values on every
    rank: a sum in which the other ranks contribute zeros (one int32
    collective; the f32 heat travels as its bit pattern)."""

    def agree(static_sp: Tensor, static_kp: Tensor, heat=None):
        n, k = static_sp.shape[0], static_kp.shape[0]
        parts = [static_sp.to(torch.int32), static_kp.to(torch.int32)]
        if heat is not None:
            parts.append(heat.reshape(-1).view(torch.int32))
        mine = torch.cat(parts)
        if mesh.axis_index:
            mine = torch.zeros_like(mine)
        got = psum(mine, mesh)
        heat0 = None if heat is None else \
            got[n + k:].view(torch.float32).reshape(heat.shape)
        return got[:n] > 0, got[n:n + k] > 0, heat0

    return agree


def make_process_frame_sharded(mesh: Mesh, cfg: PipelineConfig):
    """The sharded frame step: step(state, rgb, depth) -> (state,
    ShardedFrameOutput), with the inputs of `pipeline.process_frame`.
    Every rank calls it with the same frame."""
    check_supported(cfg)
    cam = cfg.cam
    use_ferns = (cfg.ferns.enabled or cfg.enable_loop_closure) \
        and cfg.enable_sparse_vo
    agree = _rank0(mesh) if mesh.axis_size > 1 else None

    def step(state: ShardedSLAMState, rgb, depth):
        dev = mesh.device
        rgb, depth = frame_inputs(rgb, depth, cfg, dev)
        stamp = state.stamp
        surfels = state.model.surfels
        nb_loc = state.model.nb_local
        nb_vis = state.model.nb_visible_local

        # replicated front half, MOD and VO (pipeline.py steps 1-8)
        fe = front_end(rgb, depth, cfg, stamp)
        fdepth, tps, plane_depth = fe.fdepth, fe.tps, fe.plane_depth
        mv = motion_and_vo(rgb, fe, state.pose, state.local_map,
                           state.mod_prev, state.detector, cfg, agree=agree)
        frame, kp, pose, lmap = mv.frame, mv.kp, mv.pose, mv.local_map

        # dense ICP over the sharded model (step 9)
        target_maps = None
        icp_valid = torch.zeros((), dtype=torch.bool, device=dev)
        if cfg.enable_icp or cfg.enable_loop_closure:
            target_maps = _target_maps(frame, tps.labels, plane_depth, cfg)
        if cfg.enable_icp:
            with tracing.stage("icp"):
                R_view = pose.R.T
                t_view = -(R_view @ pose.t)
                icp = icp_ops.symmetric_icp(surfels, nb_vis, target_maps,
                                            R_view, t_view, cam, cfg.icp,
                                            mesh=mesh)
                use = icp.valid & (state.nb_visible_total > 0)
                R_new = orthonormalize(pose.R @ icp.R_rel)
                t_new = pose.R @ icp.t_rel + pose.t
                pose = Pose(torch.where(use, R_new, pose.R),
                            torch.where(use, t_new, pose.t))
                icp_valid = icp.valid

        # fern place recognition + global loop closure (steps 10-11)
        kf_store = state.kf_store
        prev_fern_id = state.prev_fern_id
        last_lc = state.last_lc_stamp
        lc_count = state.lc_count
        out = {}
        if use_ferns:
            with tracing.stage("ferns"):
                kf_gids = kf_sh.global_ids(kf_store.db.codes.shape[0], mesh)
                codes = fern_codes(rgb, fdepth, cfg)
                best_id, _, is_new = kf_sh.query_sharded(
                    kf_store.db.codes, kf_store.db.count, codes,
                    cfg.ferns.new_frame_thresh, mesh)
                kp_p3d, kp_depth_ok = keypoints_3d(kp, fdepth, cfg)
            out.update(fern_id=best_id, fern_new=is_new)
        if use_ferns and cfg.enable_loop_closure:
            with tracing.stage("loop_closure"):
                db = kf_store.db
                gap = cfg.ferns.min_frame_gap
                kf_stamp_best = kf_sh.get_stamp_sharded(db.stamps, best_id,
                                                        mesh)
                gate = (~is_new & (db.count > 0) & (best_id != prev_fern_id)
                        & (stamp - last_lc > gap)
                        & (stamp - kf_stamp_best > gap))
                # the frame's one host read; the same value on every rank
                fire = bool(gate)
                accepted = torch.zeros((), dtype=torch.bool, device=dev)
                if fire:
                    payload = kf_sh.get_payload_sharded(kf_store, best_id,
                                                        mesh)
                    lc = lc_ops.close_global_loop(
                        kf_store, best_id, surfels, nb_loc, frame, kp,
                        kp_p3d, kp_depth_ok, target_maps, pose, stamp, cam,
                        cfg.icp, mesh=mesh, payload=payload,
                        kf_gids=kf_gids)
                    accepted = lc.accepted
                    pose = lc.pose
                    surfels = lc.model
                    kf_store = kf_store._replace(db=db._replace(
                        poses_R=lc.kf_poses_R, poses_t=lc.kf_poses_t))
                    last_lc = torch.where(accepted, stamp, last_lc)
                    lc_count = lc_count + accepted.to(torch.int32)
                    lmap = reset_map_if(accepted, kp, fdepth, pose, lmap,
                                        cfg)
            out.update(lc_gate=fire, lc_accepted=accepted)
        if use_ferns:
            prev_fern_id = torch.where(is_new, kf_store.db.count, best_id)

        # local map (step 12)
        lmap = update_local_map(mv, fdepth, tps.labels, pose, lmap, cfg)

        # sharded fusion, insertion, filtering and compaction (step 13):
        # no bootstrap branch; on an empty model nothing matches and the
        # first frame inserts on rank 0
        with tracing.stage("fusion"):
            new_surfels, nb_live, nb_vis_new = local_model_update(
                surfels, nb_loc, nb_vis, frame, tps.labels, plane_depth,
                pose.R, pose.t, stamp, cam, cfg.fusion, cfg.conf_thresh,
                mesh)
            if cfg.fusion.freeze_on_tracking_loss and cfg.enable_icp:
                # replicated predicate: icp.valid comes from the summed
                # system, the total from one more int32 sum
                keep = icp_valid | (psum(nb_loc, mesh) == 0)
                new_surfels, nb_live, nb_vis_new = where_tree(
                    keep, (new_surfels, nb_live, nb_vis_new),
                    (surfels, nb_loc, nb_vis))
            tot = psum(torch.stack([nb_live, nb_vis_new]), mesh)

        # keyframe snapshot on its owner rank (step 14)
        if use_ferns:
            with tracing.stage("ferns"):
                kf_store, _ = kf_sh.add_keyframe_sharded(
                    kf_store, kf_store.db.count, codes, pose.R, pose.t,
                    stamp, kp.xy, kp_p3d, kp.desc, kp.valid & kp_depth_ok,
                    frame.positions, frame.orientations[:, 2, :],
                    frame.colors, frame.confidences > 0.0, mesh,
                    when=is_new)

        new_state = ShardedSLAMState(
            model=DistributedModel(new_surfels, nb_live, nb_vis_new),
            kf_store=kf_store, pose=pose, stamp=stamp + 1, local_map=lmap,
            mod_prev=mv.mod_prev, prev_fern_id=prev_fern_id,
            last_lc_stamp=last_lc, lc_count=lc_count,
            nb_visible_total=tot[1], detector=state.detector)
        return new_state, ShardedFrameOutput(
            pose=pose, nb_total=tot[0], vo_valid=mv.vo_valid,
            icp_valid=icp_valid, **out)

    return step

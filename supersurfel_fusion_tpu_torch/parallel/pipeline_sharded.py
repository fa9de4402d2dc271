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

from supersurfel_fusion_tpu_torch import graphs
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.models.person_detector import PersonDetector
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
    FernLookup,
    LoopCarry,
    _target_maps,
    _upload,
    fern_codes,
    front_end,
    init_carried,
    keypoints_3d,
    motion_and_vo,
    update_local_map,
)
from supersurfel_fusion_tpu_torch.types import Pose, Supersurfels
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
    kp_cap = keypoint_capacity(cfg.vo, cfg.cam.height, cfg.cam.width)
    rows = kf_sh.local_rows(cfg.ferns.max_keyframes, mesh.axis_size)
    return ShardedSLAMState(
        model=make_distributed_model(cfg.fusion.nb_supersurfels_max, mesh),
        kf_store=lc_ops.KeyframeStore.empty(rows, cfg.ferns.nb_ferns, kp_cap,
                                            cfg.nb_superpixels, dev),
        nb_visible_total=torch.zeros((), dtype=torch.int32, device=dev),
        **init_carried(cfg, dev, kp_cap),
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


def _icp(model: DistributedModel, nb_visible_total: Tensor,
         target_maps: Tensor, pose: Pose, mesh: Mesh, cfg: PipelineConfig):
    """Stage icp over the sharded model. Returns (pose, ICP valid)."""
    R_view = pose.R.T
    t_view = -(R_view @ pose.t)
    icp = icp_ops.symmetric_icp(model.surfels, model.nb_visible_local,
                                target_maps, R_view, t_view, cfg.cam,
                                cfg.icp, mesh=mesh)
    use = icp.valid & (nb_visible_total > 0)
    R_new = orthonormalize(pose.R @ icp.R_rel)
    t_new = pose.R @ icp.t_rel + pose.t
    return Pose(torch.where(use, R_new, pose.R),
                torch.where(use, t_new, pose.t)), icp.valid


def _ferns(rgb: Tensor, fdepth: Tensor, kp, db, mesh: Mesh,
           cfg: PipelineConfig):
    """Stage ferns. Returns (each local row's global id, FernLookup)."""
    kf_gids = kf_sh.global_ids(db.codes.shape[0], mesh)
    codes = fern_codes(rgb, fdepth, cfg)
    best_id, _, is_new = kf_sh.query_sharded(
        db.codes, db.count, codes, cfg.ferns.new_frame_thresh, mesh)
    return kf_gids, FernLookup(codes, best_id, is_new,
                               *keypoints_3d(kp, fdepth, cfg))


def _loop_closure(fl: FernLookup, c: LoopCarry, kf_gids: Tensor,
                  nb_loc: Tensor, prev_fern_id: Tensor, stamp: Tensor,
                  frame: Supersurfels, kp, fdepth: Tensor,
                  target_maps: Tensor, mesh: Mesh, cfg: PipelineConfig):
    """Stage loop_closure over the sharded model and store. Returns
    (carried values, ShardedFrameOutput fields)."""
    db = c.kf_store.db
    fire = fl.gate(db.count,
                   kf_sh.get_stamp_sharded(db.stamps, fl.best_id, mesh),
                   prev_fern_id, stamp, c.last_lc, cfg.ferns.min_frame_gap)
    accepted = torch.zeros((), dtype=torch.bool, device=stamp.device)
    if fire:
        payload = kf_sh.get_payload_sharded(c.kf_store, fl.best_id, mesh)
        lc = lc_ops.close_global_loop(
            c.kf_store, fl.best_id, c.surfels, nb_loc, frame, kp, fl.kp_p3d,
            fl.kp_depth_ok, target_maps, c.pose, stamp, cfg.cam, cfg.icp,
            mesh=mesh, payload=payload, kf_gids=kf_gids)
        accepted = lc.accepted
        c = c.closed(lc, stamp, kp, fdepth, cfg)
    return c, dict(lc_gate=fire, lc_accepted=accepted)


def _fusion(model: DistributedModel, frame: Supersurfels, labels: Tensor,
            plane_depth: Tensor, pose: Pose, stamp: Tensor,
            icp_valid: Tensor, mesh: Mesh, cfg: PipelineConfig):
    """Stage fusion, with no bootstrap branch: on an empty model nothing
    matches and the first frame inserts on rank 0. Returns (the model,
    its live and visible counts summed over the ranks)."""
    new = DistributedModel(*local_model_update(
        *model, frame, labels, plane_depth, pose.R, pose.t, stamp, cfg.cam,
        cfg.fusion, cfg.conf_thresh, mesh))
    if cfg.fusion.freeze_on_tracking_loss and cfg.enable_icp:
        # replicated predicate: icp.valid comes from the summed system, the
        # total from one more int32 sum
        keep = icp_valid | (psum(model.nb_local, mesh) == 0)
        new = where_tree(keep, new, model)
    return new, psum(torch.stack([new.nb_local, new.nb_visible_local]), mesh)


def _keyframe(kf_store: lc_ops.KeyframeStore, fl: FernLookup, pose: Pose,
              stamp: Tensor, kp, frame: Supersurfels, mesh: Mesh):
    """Stage ferns' keyframe snapshot, stored on its owner rank."""
    return kf_sh.add_keyframe_sharded(
        kf_store, kf_store.db.count, fl.codes, pose.R, pose.t, stamp, kp.xy,
        fl.kp_p3d, kp.desc, kp.valid & fl.kp_depth_ok, frame.positions,
        frame.orientations[:, 2, :], frame.colors, frame.confidences > 0.0,
        mesh, when=fl.is_new)[0]


def make_process_frame_sharded(mesh: Mesh, cfg: PipelineConfig):
    """The sharded frame step: step(state, rgb, depth) -> (state,
    ShardedFrameOutput), with the inputs of `pipeline.process_frame`.
    Every rank calls it with the same frame."""
    check_supported(cfg)
    use_ferns = (cfg.ferns.enabled or cfg.enable_loop_closure) \
        and cfg.enable_sparse_vo
    agree = _rank0(mesh) if mesh.axis_size > 1 else None

    def step(state: ShardedSLAMState, rgb, depth):
        dev = mesh.device
        rgb, depth = _upload(rgb, dev), _upload(depth, dev)
        stamp = state.stamp

        # replicated front half, MOD and VO (pipeline.py steps 1-8)
        fe = front_end(rgb, depth, cfg, stamp)
        rgb, fdepth, tps = fe.rgb, fe.fdepth, fe.tps
        plane_depth = fe.plane_depth
        mv = motion_and_vo(rgb, fe, state.pose, state.local_map,
                           state.mod_prev, state.detector, cfg, agree=agree)
        frame, kp, pose = mv.frame, mv.kp, mv.pose

        # dense ICP over the sharded model (step 9)
        target_maps = None
        icp_valid = torch.zeros((), dtype=torch.bool, device=dev)
        if cfg.enable_icp or cfg.enable_loop_closure:
            target_maps = _target_maps(frame, tps.labels, plane_depth, cfg)
        if cfg.enable_icp:
            pose, icp_valid = graphs.stage("icp", _icp, state.model,
                                           state.nb_visible_total,
                                           target_maps, pose, mesh, cfg)

        # fern place recognition + global loop closure (steps 10-11)
        lc = LoopCarry(pose, state.model.surfels, state.kf_store,
                       state.last_lc_stamp, state.lc_count, mv.local_map)
        prev_fern_id = state.prev_fern_id
        out = {}
        if use_ferns:
            kf_gids, fl = graphs.stage("ferns", _ferns, rgb, fdepth, kp,
                                       state.kf_store.db, mesh, cfg)
            out.update(fern_id=fl.best_id, fern_new=fl.is_new)
            if cfg.enable_loop_closure:
                lc, lc_out = graphs.stage(
                    "loop_closure", _loop_closure, fl, lc, kf_gids,
                    state.model.nb_local, prev_fern_id, stamp, frame, kp,
                    fdepth, target_maps, mesh, cfg)
                out.update(lc_out)
            prev_fern_id = fl.next_id(lc.kf_store.db.count)
        pose, kf_store = lc.pose, lc.kf_store

        # local map (step 12)
        lmap = update_local_map(mv, fdepth, tps.labels, pose, lc.local_map,
                                cfg)

        # sharded fusion, insertion, filtering and compaction (step 13)
        model, tot = graphs.stage(
            "fusion", _fusion, state.model._replace(surfels=lc.surfels),
            frame, tps.labels, plane_depth, pose, stamp, icp_valid, mesh, cfg)

        # keyframe snapshot on its owner rank (step 14)
        if use_ferns:
            kf_store = graphs.stage("ferns", _keyframe, kf_store, fl, pose,
                                    stamp, kp, frame, mesh)

        new_state = ShardedSLAMState(
            model=model, kf_store=kf_store, pose=pose, stamp=stamp + 1,
            local_map=lmap, mod_prev=mv.mod_prev, prev_fern_id=prev_fern_id,
            last_lc_stamp=lc.last_lc, lc_count=lc.lc_count,
            nb_visible_total=tot[1], detector=state.detector)
        return new_state, ShardedFrameOutput(
            pose=pose, nb_total=tot[0], vo_valid=mv.vo_valid,
            icp_valid=icp_valid, **out)

    return step

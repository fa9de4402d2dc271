"""Global loop closure: fern-triggered relocalization and map deformation.

Port of `supersurfel_fusion_tpu/ops/loop_closure.py` (the reference's
`SupersurfelFusion::closeGlobalLoop`):

  keyframe <-> current feature matching (Hamming + GMS) -> rigid 3D-3D
  RANSAC -> dense ICP of the keyframe's surfels against the current frame
  -> loop-corrected pose -> 50 sampled constraints (+ pins) ->
  deformation-graph Gauss-Newton -> accept/reject -> apply to the model
  and the keyframe pose graph.

Inside a frame step the branch records three parts of its stage in the
port's span recorder (`tracing.py`): `lc.relocalise` (matching, GMS and
the RANSAC), `lc.align` (the dense ICP) and `lc.deform` (the graph, its
bindings and solve, and the deformation of the model and keyframe poses).

`ransac_rigid_3d` also serves the MOD's depth-residual cue, which fits the
camera's rigid motion from matched keypoints. It is the composition of
three pieces around its two SVDs (`rigid_hypotheses`, `rigid_refit`,
`rigid_result`; the fit itself `kabsch_moments` and `kabsch_rotation`),
which MOD calls one by one so that the stage runner can capture the work
between the SVDs (`ops/motion.py`). Everything but the SVDs is
fixed-shape and reads nothing on the host; the frame step decides on the
host whether to run `close_global_loop` at all (one wait per frame,
`pipeline.py`).
Over a sharded model and keyframe store (`parallel/`), the same function
samples the graph's nodes on every rank and deforms each rank's block.

The SVD is `torch.linalg.svd`; on a card it reads its convergence flags
on the host, so each waits for the device. R = V S U^T does not change
when a singular pair changes sign, so nondegenerate hypotheses agree with
the JAX package; degenerate triples (repeated draws) may not, and score
low.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from supersurfel_fusion_tpu_torch import tracing
from supersurfel_fusion_tpu_torch.config import CameraIntrinsics, ICPConfig
from supersurfel_fusion_tpu_torch.ops import deformation as defo
from supersurfel_fusion_tpu_torch.ops.features import Keypoints
from supersurfel_fusion_tpu_torch.ops.ferns import (
    FernDB,
    add_keyframe,
    masked_put,
    store_slot,
)
from supersurfel_fusion_tpu_torch.ops.flow import coverage_rank
from supersurfel_fusion_tpu_torch.ops.icp import symmetric_icp
from supersurfel_fusion_tpu_torch.ops.matching import (
    gms_filter,
    match_bruteforce,
)
from supersurfel_fusion_tpu_torch.types import Pose, Supersurfels
from supersurfel_fusion_tpu_torch.utils import prng
from supersurfel_fusion_tpu_torch.utils.geometry import orthonormalize

Tensor = torch.Tensor


class KeyframeStore(NamedTuple):
    """Fern DB and per-keyframe payloads (the reference's KeyFrame)."""

    db: FernDB
    kp_xy: Tensor       # (K, KP, 2)
    kp_p3d: Tensor      # (K, KP, 3) keyframe-camera-frame points
    kp_desc: Tensor     # (K, KP, 8) int32 bit patterns
    kp_valid: Tensor    # (K, KP) bool
    sf_pos: Tensor      # (K, F, 3) keyframe-camera-frame surfel positions
    sf_normal: Tensor   # (K, F, 3)
    sf_color: Tensor    # (K, F, 3)
    sf_valid: Tensor    # (K, F) bool

    @staticmethod
    def empty(max_kf: int, n_ferns: int, kp_cap: int, f_cap: int,
              device: str | torch.device) -> "KeyframeStore":
        f32 = dict(dtype=torch.float32, device=device)
        b = dict(dtype=torch.bool, device=device)
        return KeyframeStore(
            db=FernDB.empty(max_kf, n_ferns, device),
            kp_xy=torch.zeros((max_kf, kp_cap, 2), **f32),
            kp_p3d=torch.zeros((max_kf, kp_cap, 3), **f32),
            kp_desc=torch.zeros((max_kf, kp_cap, 8), dtype=torch.int32,
                                device=device),
            kp_valid=torch.zeros((max_kf, kp_cap), **b),
            sf_pos=torch.zeros((max_kf, f_cap, 3), **f32),
            sf_normal=torch.zeros((max_kf, f_cap, 3), **f32),
            sf_color=torch.zeros((max_kf, f_cap, 3), **f32),
            sf_valid=torch.zeros((max_kf, f_cap), **b),
        )

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.db, *self[1:]))


def add_keyframe_payload(store: KeyframeStore, codes: Tensor, pose: Pose,
                         stamp: Tensor, kp: Keypoints, kp_p3d: Tensor,
                         kp_depth_ok: Tensor, frame: Supersurfels,
                         when: Tensor | None = None) -> KeyframeStore:
    """Snapshot the current frame as a keyframe (Ferns::addKeyFrame and the
    processFrame snapshot): a masked device update, a no-op when the store
    is full or `when` (a () bool tensor) is False."""
    ok, k = store_slot(store.db, when)

    def put(dst, src):
        return masked_put(dst, src, ok, k)

    return KeyframeStore(
        db=add_keyframe(store.db, codes, pose.R, pose.t, stamp, when),
        kp_xy=put(store.kp_xy, kp.xy),
        kp_p3d=put(store.kp_p3d, kp_p3d),
        kp_desc=put(store.kp_desc, kp.desc),
        kp_valid=put(store.kp_valid, kp.valid & kp_depth_ok),
        sf_pos=put(store.sf_pos, frame.positions),
        sf_normal=put(store.sf_normal, frame.orientations[:, 2, :]),
        sf_color=put(store.sf_color, frame.colors),
        sf_valid=put(store.sf_valid, frame.confidences > 0.0),
    )


def _det3(M: Tensor) -> Tensor:
    """Determinant of (..., 3, 3) matrices, by cofactors of the first row."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def kabsch_moments(P: Tensor, Q: Tensor, w: Tensor):
    """The first half of a weighted rigid fit Q ~ R P + t (batched over
    leading dims): the weighted means (mp, mq) and the cross-covariance H,
    whose SVD the second half, `kabsch_rotation`, takes."""
    ws = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    mp = torch.sum(P * w[..., None], -2) / ws
    mq = torch.sum(Q * w[..., None], -2) / ws
    Pc = (P - mp[..., None, :]) * w[..., None]
    Qc = Q - mq[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", Pc, Qc)
    return mp, mq, H


def kabsch_rotation(U: Tensor, Vt: Tensor, mp: Tensor, mq: Tensor):
    """The second half of the fit: (R, t) from the SVD U S Vt of H and the
    means."""
    V = Vt.transpose(-1, -2)
    d = _det3(V @ U.transpose(-1, -2))
    S = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (V * S[..., None, :]) @ U.transpose(-1, -2)      # V S U^T
    t = mq - torch.einsum("...ij,...j->...i", R, mp)
    return R, t


def _kabsch(P: Tensor, Q: Tensor, w: Tensor):
    """Weighted rigid fit Q ~ R P + t (batched over leading dims)."""
    mp, mq, H = kabsch_moments(P, Q, w)
    U, _, Vt = torch.linalg.svd(H)
    return kabsch_rotation(U, Vt, mp, mq)


@functools.lru_cache(maxsize=None)
def _draw_on(seed: int, n_hyp: int, device: torch.device) -> Tensor:
    """(n_hyp, 3) int64 in [0, 2**30): JAX's
    `jax.random.randint(PRNGKey(seed), (n_hyp, 3), 0, 1 << 30)`."""
    draw = prng.randint(prng.PRNGKey(seed), (n_hyp, 3), 0, 1 << 30)
    return torch.as_tensor(draw, device=device).to(torch.int64)


def ransac_rigid_3d(src: Tensor, dst: Tensor, ok: Tensor, n_hyp: int = 256,
                    thresh: float = 0.05, seed: int = 7,
                    min_inliers: int = 30, min_ratio: float = 0.3,
                    src_xy: Tensor | None = None,
                    img_w: float = 640.0, img_h: float = 480.0,
                    cov_grid: int = 8):
    """RANSAC rigid transform dst ~ R src + t from masked 3D pairs.

    Hypothesis triples are drawn from the valid subset (valid-first order,
    draws modulo the valid count). With `src_xy` (pixel positions of the
    src points), hypotheses are ranked by spatial coverage with the raw
    inlier count as tiebreak. Returns (R, t, valid, n_in).

    The three pieces around its two SVDs, `rigid_hypotheses`,
    `rigid_refit` and `rigid_result`, are also called one by one, by
    MOD's parts (`ops/motion.py`); composed here they run the same ops in
    the same order."""
    hyp, w3, n_ok = rigid_hypotheses(src, dst, ok, n_hyp, seed)
    U, _, Vt = torch.linalg.svd(hyp[2])
    fit, best_inl = rigid_refit(U, Vt, hyp, w3, src, dst, ok, thresh,
                                src_xy, img_w, img_h, cov_grid)
    U, _, Vt = torch.linalg.svd(fit[2])
    return rigid_result(U, Vt, fit, best_inl, n_ok, min_inliers, min_ratio)


def rigid_hypotheses(src: Tensor, dst: Tensor, ok: Tensor, n_hyp: int = 256,
                     seed: int = 7):
    """`ransac_rigid_3d` up to its hypotheses' cross-covariances: (the
    hypotheses' `kabsch_moments` (mp, mq, H (n_hyp, 3, 3)), their triples'
    weights w3 (n_hyp, 3), the valid count n_ok)."""
    n_ok = torch.sum(ok.to(torch.int64))
    # valid-first ordering; draws restricted to the first n_ok entries
    order = torch.argsort((~ok).to(torch.int8), stable=True)
    idx = order[_draw_on(seed, n_hyp, src.device)
                % torch.clamp(n_ok, min=1)]
    P = src[idx]                      # (n_hyp, 3, 3)
    Q = dst[idx]
    w3 = ok[idx].to(torch.float32)
    # degenerate triples (repeated draws / collinear) score low naturally
    return kabsch_moments(P, Q, w3), w3, n_ok


def rigid_refit(U: Tensor, Vt: Tensor, hyp, w3: Tensor, src: Tensor,
                dst: Tensor, ok: Tensor, thresh: float,
                src_xy: Tensor | None, img_w: float, img_h: float,
                cov_grid: int = 8):
    """From the hypotheses' SVD (U, Vt) to the refit's cross-covariance:
    each hypothesis' rotation, its inliers and score, the winner's
    inliers. Returns (the refit's `kabsch_moments`, batched over 1, the
    winner's inliers (N,) bool)."""
    R, t = kabsch_rotation(U, Vt, hyp[0], hyp[1])
    pred = torch.einsum("hij,nj->hni", R, src) + t[:, None, :]
    diff = pred - dst[None]
    err = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                     + diff[..., 2] * diff[..., 2])
    inl = (err < thresh) & ok[None, :]
    n_inl_h = torch.sum(inl, -1).to(torch.float32)
    if src_xy is not None:
        rank = coverage_rank(inl, src_xy, img_w, img_h, cov_grid) * 4096.0 \
            + n_inl_h
    else:
        rank = n_inl_h
    scores = torch.where(torch.sum(w3, -1) >= 3, rank,
                         torch.full_like(rank, -1.0))
    best = torch.argmax(scores)
    # a 1-element index, not a 0-d one: indexing with a 0-d tensor reads
    # it on the host and waits for the device
    best_inl = inl.index_select(0, best.reshape(1))[0] & ok
    # refit on the winners
    return (kabsch_moments(src[None], dst[None],
                           best_inl[None].to(torch.float32)), best_inl)


def rigid_result(U: Tensor, Vt: Tensor, fit, best_inl: Tensor, n_ok: Tensor,
                 min_inliers: int, min_ratio: float):
    """From the refit's SVD (U, Vt) to `ransac_rigid_3d`'s (R, t, valid,
    n_in)."""
    Rf, tf = kabsch_rotation(U, Vt, fit[0], fit[1])
    Rf, tf = orthonormalize(Rf[0]), tf[0]
    n_in = torch.sum(best_inl.to(torch.int32))
    valid = ((n_in > min_inliers)
             & (n_in.to(torch.float32)
                > min_ratio * torch.clamp(n_ok, min=1).to(torch.float32))
             & torch.all(torch.isfinite(Rf)) & torch.all(torch.isfinite(tf)))
    return Rf, tf, valid, n_in


class LoopClosureResult(NamedTuple):
    accepted: Tensor    # () bool
    pose: Pose          # corrected pose (the input pose when rejected)
    model: Supersurfels
    kf_poses_R: Tensor  # deformed keyframe poses
    kf_poses_t: Tensor


def take_row(a: Tensor, i: Tensor) -> Tensor:
    """a[i] for a () index tensor, without reading it on the host."""
    return a.index_select(0, i.reshape(1).to(torch.int64))[0]


def close_global_loop(store: KeyframeStore, best_id: Tensor,
                      model: Supersurfels, nb_supersurfels: Tensor,
                      frame: Supersurfels, kp: Keypoints, kp_p3d: Tensor,
                      kp_depth_ok: Tensor, target_maps: Tensor, pose: Pose,
                      stamp: Tensor, cam: CameraIntrinsics,
                      icp_cfg: ICPConfig, mesh=None, payload=None,
                      kf_gids: Tensor | None = None) -> LoopClosureResult:
    """The whole loop-closure branch against keyframe `best_id`.

    Sharded (`parallel/`): with `mesh`, `model` is this rank's block of
    the capacity-sharded model and `nb_supersurfels` its local live
    count; the graph's nodes are sampled on every rank and gathered
    (`deformation.build_graph_sharded`), matching, RANSAC, ICP and the
    graph solve run replicated, and the deformation is applied to this
    rank's block. With a sharded keyframe store, `store` holds this
    rank's rows, `payload` is the best keyframe's payload broadcast from
    its owner (`kf_sharded.get_payload_sharded`), and `kf_gids` the
    global id of each local row, which masks the pose-graph update."""
    dev = pose.t.device
    f32 = dict(dtype=torch.float32, device=dev)
    F = frame.capacity
    eye = torch.eye(3, **f32)
    if payload is None:
        def kf(field):
            return take_row(getattr(store, field), best_id)

        kf_pose = Pose(take_row(store.db.poses_R, best_id),
                       take_row(store.db.poses_t, best_id))
        kf_stamp = take_row(store.db.stamps, best_id)
    else:
        def kf(field):
            return getattr(payload, field)

        kf_pose = Pose(payload.pose_R, payload.pose_t)
        kf_stamp = payload.stamp

    with tracing.span("lc.relocalise"):
        # 1. keyframe -> current matching
        midx, _, mok = match_bruteforce(kf("kp_desc"), kf("kp_valid"),
                                        kp.desc, kp.valid & kp_depth_ok)
        midx = midx.to(torch.int64)
        inl = gms_filter(kf("kp_xy"), kp.xy[midx], mok,
                         float(cam.width), float(cam.height))

        # 2. 3D-3D RANSAC: keyframe-camera points -> current-camera points
        R_init, t_init, sparse_ok, _ = ransac_rigid_3d(kf("kp_p3d"),
                                                       kp_p3d[midx], inl)
        R_init = torch.where(sparse_ok, R_init, eye)
        t_init = torch.where(sparse_ok, t_init, torch.zeros(3, **f32))

    with tracing.span("lc.align"):
        # 3. dense ICP: keyframe surfels (keyframe camera frame) against
        # the current frame; the alignment has no covariance gate
        empty = Supersurfels.empty(F, dev)
        orient = empty.orientations.clone()
        orient[:, 2, :] = kf("sf_normal")
        kf_sf = empty._replace(
            positions=kf("sf_pos"),
            colors=kf("sf_color"),
            orientations=orient,
            confidences=torch.where(kf("sf_valid"),
                                    torch.ones(F, **f32),
                                    torch.full((F,), -1.0, **f32)))
        align_cfg = ICPConfig(
            nb_iters=icp_cfg.nb_iters, cov_thresh=1e9,
            max_color_dist=icp_cfg.max_color_dist, max_dist=icp_cfg.max_dist,
            min_normal_dot=icp_cfg.min_normal_dot, min_inliers=50.0,
            max_translation=0.5)
        # (a fill, not a copy from the host, which would wait for the
        # device)
        icp = symmetric_icp(kf_sf, torch.full((), F, dtype=torch.int32,
                                              device=dev),
                            target_maps, R_init, t_init, cam, align_cfg)

    # 4. compose: T_rel maps current-camera -> keyframe-camera
    R_i_inv = torch.where(sparse_ok, R_init.T, eye)
    t_i_inv = torch.where(sparse_ok, -(R_init.T @ t_init),
                          torch.zeros(3, **f32))
    R_rel = orthonormalize(R_i_inv @ icp.R_rel)
    t_rel = R_i_inv @ icp.t_rel + t_i_inv
    pose_ok = icp.valid | sparse_ok
    R_LC = orthonormalize(kf_pose.R @ R_rel)
    t_LC = kf_pose.R @ t_rel + kf_pose.t

    # 5. constraints: every (F/50)th frame surfel; the source under the old
    # pose, the target under the loop-corrected pose, plus a pinned copy
    sel = torch.arange(0, F, max(F // 50, 1), device=dev)[:50]
    n_sel = sel.shape[0]
    p_sel = frame.positions[sel]
    c_ok = frame.confidences[sel] > 0.0
    src = p_sel @ pose.R.T + pose.t
    tgt = p_sel @ R_LC.T + t_LC
    con_src = torch.cat([src, tgt])                 # pins: src == tgt
    con_tgt = torch.cat([tgt, tgt])
    con_valid = torch.cat([c_ok, c_ok]) & pose_ok
    con_stamp = torch.cat([
        stamp.to(torch.int32).expand(n_sel),
        kf_stamp.to(torch.int32).expand(n_sel)])

    with tracing.span("lc.deform"):
        # 6. deformation graph over the live model
        if mesh is None:
            graph = defo.build_graph(model.positions, model.stamps[:, 0],
                                     nb_supersurfels)
        else:
            graph = defo.build_graph_sharded(
                model.positions, model.stamps[:, 0], nb_supersurfels, mesh)
        con_bind = defo.bind_vertices(graph, con_src, con_stamp, con_valid)
        rot, trans, error, mean_cerr = defo.optimise(
            graph, con_bind, con_src, con_tgt, con_valid)
        accepted = (pose_ok & torch.isfinite(error) & (error < 0.12)
                    & (mean_cerr < 3e-4))

        # 7. apply to the model and the keyframe pose graph
        ids = torch.arange(model.capacity, dtype=torch.int32, device=dev)
        live = (ids < nb_supersurfels) & (model.confidences > 0.0)
        vbind = defo.bind_vertices(graph, model.positions,
                                   model.stamps[:, 0], live)
        deformed = defo.apply_to_model(model, graph.positions, rot, trans,
                                       vbind, live & accepted)

        # keyframe poses (applyGraphToPoses, look_back=10); the rows of a
        # sharded store are local, and kf_gids gives their global ids
        db = store.db
        if kf_gids is None:
            kf_gids = torch.arange(db.poses_t.shape[0], device=dev)
        kf_live = kf_gids < db.count
        kf_bind = defo.bind_vertices(graph, db.poses_t, db.stamps, kf_live,
                                     look_back=10)
        g = graph.positions[kf_bind.nodes]
        Rk = rot[kf_bind.nodes]
        tk = trans[kf_bind.nodes]
        rel = db.poses_t[:, None, :] - g
        new_t = torch.sum(
            kf_bind.weights[..., None]
            * (torch.einsum("vkij,vkj->vki", Rk, rel) + g + tk), dim=1)
        blend_R = torch.sum(kf_bind.weights[..., None, None] * Rk, dim=1)
        new_R = orthonormalize(blend_R @ db.poses_R)
        apply_kf = accepted & kf_live
    return LoopClosureResult(
        accepted=accepted,
        pose=Pose(torch.where(accepted, R_LC, pose.R),
                  torch.where(accepted, t_LC, pose.t)),
        model=deformed,
        kf_poses_R=torch.where(apply_kf[:, None, None], new_R, db.poses_R),
        kf_poses_t=torch.where(apply_kf[:, None], new_t, db.poses_t),
    )

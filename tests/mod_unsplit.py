"""MOD's `detect_motion` and the rigid RANSAC `ransac_rigid_3d` as they
were before they were cut into parts around the RANSAC's two SVDs, kept
to hold the parts' composition to them bit for bit
(`test_torch_motion.py`, `test_torch_flow.py`). Copied whole, with the
port's helpers they call; imports no JAX."""

from __future__ import annotations

import torch

from supersurfel_fusion_tpu_torch import tracing
from supersurfel_fusion_tpu_torch.config import (
    CameraIntrinsics,
    MODConfig,
    TPSConfig,
)
from supersurfel_fusion_tpu_torch.ops.features import Keypoints
from supersurfel_fusion_tpu_torch.ops.flow import (
    coverage_rank,
    dense_flow,
    estimate_similarity_ransac,
    se3_depth_residual,
    warp_similarity,
)
from supersurfel_fusion_tpu_torch.ops.loop_closure import _det3, _draw_on
from supersurfel_fusion_tpu_torch.ops.matching import (
    gms_filter,
    match_bruteforce,
)
from supersurfel_fusion_tpu_torch.ops.motion import (
    MODPrev,
    _cluster_sum,
    _gated_index,
    _gather25,
    _grow,
    _keypoint_pixels,
    _norm3,
    geometric_clusters,
    heat_update,
    person_flood_fill,
    superpixel_adjacency,
)
from supersurfel_fusion_tpu_torch.ops.tps import TPSResult, cell_reduce
from supersurfel_fusion_tpu_torch.types import Supersurfels
from supersurfel_fusion_tpu_torch.utils.color import rgb_to_lab
from supersurfel_fusion_tpu_torch.utils.geometry import orthonormalize

Tensor = torch.Tensor


def _kabsch_whole(P: Tensor, Q: Tensor, w: Tensor):
    """Weighted rigid fit Q ~ R P + t (batched over leading dims)."""
    ws = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    mp = torch.sum(P * w[..., None], -2) / ws
    mq = torch.sum(Q * w[..., None], -2) / ws
    Pc = (P - mp[..., None, :]) * w[..., None]
    Qc = Q - mq[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", Pc, Qc)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = _det3(V @ U.transpose(-1, -2))
    S = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (V * S[..., None, :]) @ U.transpose(-1, -2)      # V S U^T
    t = mq - torch.einsum("...ij,...j->...i", R, mp)
    return R, t


def ransac_rigid_3d_whole(src: Tensor, dst: Tensor, ok: Tensor,
                          n_hyp: int = 256, thresh: float = 0.05,
                          seed: int = 7, min_inliers: int = 30,
                          min_ratio: float = 0.3,
                          src_xy: Tensor | None = None,
                          img_w: float = 640.0, img_h: float = 480.0,
                          cov_grid: int = 8):
    """RANSAC rigid transform dst ~ R src + t from masked 3D pairs.

    Hypothesis triples are drawn from the valid subset (valid-first order,
    draws modulo the valid count). With `src_xy` (pixel positions of the
    src points), hypotheses are ranked by spatial coverage with the raw
    inlier count as tiebreak. Returns (R, t, valid, n_in)."""
    n_ok = torch.sum(ok.to(torch.int64))
    # valid-first ordering; draws restricted to the first n_ok entries
    order = torch.argsort((~ok).to(torch.int8), stable=True)
    idx = order[_draw_on(seed, n_hyp, src.device)
                % torch.clamp(n_ok, min=1)]
    P = src[idx]                      # (n_hyp, 3, 3)
    Q = dst[idx]
    w3 = ok[idx].to(torch.float32)
    # degenerate triples (repeated draws / collinear) score low naturally
    R, t = _kabsch_whole(P, Q, w3)
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
    Rf, tf = _kabsch_whole(src[None], dst[None],
                           best_inl[None].to(torch.float32))
    Rf, tf = orthonormalize(Rf[0]), tf[0]
    n_in = torch.sum(best_inl.to(torch.int32))
    valid = ((n_in > min_inliers)
             & (n_in.to(torch.float32)
                > min_ratio * torch.clamp(n_ok, min=1).to(torch.float32))
             & torch.all(torch.isfinite(Rf)) & torch.all(torch.isfinite(tf)))
    return Rf, tf, valid, n_in


def detect_motion_whole(
    rgb_gray: Tensor,
    depth: Tensor,
    prev: MODPrev,
    kp: Keypoints,
    frame: Supersurfels,
    tps: TPSResult,
    cam: CameraIntrinsics,
    tps_cfg: TPSConfig,
    cfg: MODConfig,
    detector=None,
):
    """Full MOD pass: geometric clustering + residual flow + the rigid
    depth-residual cue, combined with the person detector (a
    `models.person_detector.PersonDetector`) when `detector` is given and
    cfg.use_yolo is set.

    Returns (is_static_sp (N,) bool, static_kp (K,) bool, new_prev). On
    the first frame (prev.initialized false) only person, residual and
    heat marks apply."""
    H, W = rgb_gray.shape
    dev = rgb_gray.device
    cs = tps_cfg.cell_size
    gh, gw = H // cs, W // cs
    n_sp = gh * gw

    # ---- geometric clustering
    with tracing.span("mod.clusters"):
        adj = superpixel_adjacency(tps.labels, gh, gw, cs)
        pos_t = frame.positions.reshape(gh, gw, 3)
        nrm_t = frame.orientations[:, 2, :].reshape(gh, gw, 3)
        conf_t = frame.confidences.reshape(gh, gw)
        root, _ = geometric_clusters(adj, pos_t, nrm_t, conf_t, gh, gw, cfg)

    # ---- combined path: person boxes -> depth-guided flood fill first, so
    # person keypoints never enter the camera-motion estimation and person
    # superpixels never dilute cluster flow statistics
    with tracing.span("mod.person"):
        combined = cfg.use_yolo and detector is not None
        ui, vi = _keypoint_pixels(kp.xy, H, W)
        kp_sp = tps.labels[vi, ui].to(torch.int64)
        if combined:
            det = detector(rgb_gray, depth, max_det=cfg.max_person_boxes,
                           score_thresh=cfg.person_score_thresh)
            person = person_flood_fill(
                det.boxes, det.valid, adj, tps.stats.centroid, pos_t, conf_t,
                tps.labels, gh, gw, cs, depth_gate=cfg.person_depth_gate,
            ).reshape(-1)
        else:
            person = torch.zeros((n_sp,), dtype=torch.bool, device=dev)
        kp_nonperson = kp.valid & ~person[kp_sp]

    with tracing.span("mod.flow"):
        # current keypoint 3D from the filtered depth (for the rigid fit)
        zk = depth[vi, ui]
        kp_z_ok = (zk >= 0.2) & (zk < 5.0)
        kp_p3d = torch.stack(
            [zk * (kp.xy[:, 0] - cam.cx) / cam.fx,
             zk * (kp.xy[:, 1] - cam.cy) / cam.fy, zk], dim=-1)

        # ---- camera-motion-compensated residual flow
        midx, _, mok = match_bruteforce(prev.kp_desc, prev.kp_valid, kp.desc,
                                        kp_nonperson)
        midx = midx.to(torch.int64)
        mxy = kp.xy[midx]
        inl = gms_filter(prev.kp_xy, mxy, mok, float(W), float(H))
        a, b, tx, ty, H_ok = estimate_similarity_ransac(
            prev.kp_xy, mxy, inl, img_w=float(W), img_h=float(H))

        gray_est = warp_similarity(prev.gray, a, b, tx, ty, 0.0)
        flow = dense_flow(rgb_gray, gray_est)   # current -> warped previous

        # ---- per-superpixel mean residual flow (border 40, 2 < |uv| <= 50,
        # normalised by the full superpixel size, as the reference does)
        y = torch.arange(H, device=dev)[:, None]
        x = torch.arange(W, device=dev)[None, :]
        mag = torch.sqrt(flow[..., 0] * flow[..., 0]
                         + flow[..., 1] * flow[..., 1])
        take = ((x >= 40) & (x < W - 40) & (y >= 40) & (y < H - 40)
                & torch.isfinite(mag) & (mag > 2.0) & (mag <= 50.0))
        fl = torch.where(take[..., None], flow, torch.zeros_like(flow))
        sums = cell_reduce(fl, tps.labels, gh, gw, cs)            # (GH, GW, 2)
        sp_size = torch.clamp(tps.stats.size, min=1.0)
        uv_sp = sums / sp_size[..., None]
        uv_mag = torch.sqrt(uv_sp[..., 0] * uv_sp[..., 0]
                            + uv_sp[..., 1] * uv_sp[..., 1]).reshape(-1)

    # ---- cluster membership + singleton fill-in. Combined path: clusters
    # need > 2 members and person superpixels carry no label
    with tracing.span("mod.fill"):
        root_f = root.reshape(-1).to(torch.int64)
        csize = torch.zeros((n_sp,), dtype=torch.int32, device=dev).index_add_(
            0, root_f, torch.ones_like(root_f, dtype=torch.int32))
        min_csize = 2 if combined else 1
        in_cluster = csize[root_f] > min_csize
        minus1 = torch.full_like(root_f, -1)
        label = torch.where(in_cluster & ~person, root_f, minus1)

        # the neighbours of each superpixel, as (25, N) rows in offset order
        # (the centre row is all false: adjacency needs another label)
        adj24 = adj.permute(2, 0, 1).reshape(25, n_sp)

        # fill-in 1: adopt the unanimous neighbour label (the first neighbour
        # in offset order sets the reference label; all must agree)
        L = _gather25(label.reshape(gh, gw), -2, gh, gw).reshape(25, n_sp)
        any_n = adj24.any(0)
        first = torch.argmax(adj24.to(torch.int8), dim=0)
        ref_lab = torch.where(any_n, L.gather(0, first[None])[0], minus1)
        agree = torch.all(~adj24 | (L == ref_lab[None]), dim=0)
        fill1 = (label < 0) & ~person & any_n & agree & (ref_lab >= 0)
        label = torch.where(fill1, ref_lab, label)

        # fill-in 2: the closest neighbour in Lab colour (distance < 20; the
        # first of equally close ones)
        lab_col = rgb_to_lab(tps.stats.color)                     # (GH, GW, 3)
        L = _gather25(label.reshape(gh, gw), -1, gh, gw).reshape(25, n_sp)
        cj = _gather25(lab_col, float("nan"), gh, gw).reshape(25, n_sp, 3)
        d = _norm3(lab_col.reshape(1, n_sp, 3) - cj)
        cand = adj24 & (L >= 0) & torch.isfinite(d)
        dc = torch.where(cand, d, torch.full_like(d, float("inf")))
        k_best = torch.argmin(dc, dim=0)
        d_best = dc.gather(0, k_best[None])[0]
        best_l = torch.where(d_best < 20.0, L.gather(0, k_best[None])[0],
                             minus1)
        fill2 = (label < 0) & ~person & (best_l >= 0)
        label = torch.where(fill2, best_l, label)

    # ---- cluster mean flow + threshold (base 2.5 px simple, 4.0 combined)
    with tracing.span("mod.cues"):
        lab_c = torch.where(label >= 0, label, torch.full_like(label, n_sp))
        cl_flow = _cluster_sum(lab_c, uv_mag, n_sp)
        cl_cnt = _cluster_sum(lab_c, torch.ones_like(uv_mag), n_sp)
        cl_mean = cl_flow / torch.clamp(cl_cnt, min=1.0)

        base = cfg.flow_thresh_combined if combined else cfg.flow_thresh_simple
        flow_thresh = base + 0.5 * torch.sqrt(tx * tx + ty * ty)
        dyn_cluster = cl_mean > flow_thresh                       # (N+1,)

        # ---- cluster depth-residual cue: a full SE(3) inverse warp against
        # the previous filtered depth, with the rigid motion fitted by 3D-3D
        # RANSAC over the matched keypoints
        dscale = (cfg.depth_cue_scale_combined if combined
                  else cfg.depth_cue_scale_simple)
        mark_resid = torch.zeros((n_sp,), dtype=torch.bool, device=dev)
        if dscale > 0:
            pair_ok = (inl & kp_z_ok[midx] & prev.kp_valid
                       & (prev.kp_p3d[:, 2] >= 0.2)
                       & (prev.kp_p3d[:, 2] < 5.0))
            R_rig, t_rig, rigid_ok, _ = ransac_rigid_3d_whole(
                prev.kp_p3d, kp_p3d[midx], pair_ok, thresh=0.05,
                min_inliers=15, min_ratio=0.15,
                src_xy=prev.kp_xy, img_w=float(W), img_h=float(H))
            resid = se3_depth_residual(depth, prev.depth, R_rig, t_rig,
                                       cam.fx, cam.fy, cam.cx, cam.cy)
            resid_abs = torch.abs(resid)
            # positive part only: pixels newly covered by a mover
            resid_pos = torch.clamp(resid, min=0.0)
            r_valid = (resid_abs > 0.0).to(torch.float32)
            rsums = cell_reduce(
                torch.stack([resid_abs, resid_pos, r_valid], -1),
                tps.labels, gh, gw, cs)
            den = torch.clamp(rsums[..., 2], min=32.0)
            sp_zdiff = (rsums[..., 0] / den).reshape(-1)
            sp_pos_t = rsums[..., 1] / den
            zsp = torch.where(pos_t[..., 2] > 0, pos_t[..., 2],
                              torch.zeros_like(pos_t[..., 2])).reshape(-1)
            cl_zdiff = _cluster_sum(lab_c, sp_zdiff, n_sp)
            cl_z = _cluster_sum(lab_c, zsp, n_sp)
            cl_zdiff = cl_zdiff / torch.clamp(cl_cnt, min=1.0)
            cl_z = cl_z / torch.clamp(cl_cnt, min=1.0)
            # Kinect noise model threshold
            depth_thresh = dscale * (0.0012 + 0.0019 * (cl_z - 0.4) ** 2)
            dyn_cluster = dyn_cluster | (rigid_ok & (cl_zdiff > depth_thresh))

            # direct per-superpixel marking with hysteresis: unambiguous
            # newly-closer residual marks outright and grows over the
            # adjacency into weak-evidence neighbours
            if cfg.resid_direct:
                hot = ((sp_pos_t > cfg.resid_hot_thresh)
                       & rigid_ok).reshape(-1)
                weak = (sp_pos_t > cfg.resid_low_thresh).reshape(-1)
                nbr = _gated_index(adj24, gh, gw)
                mark_resid = _grow(hot, weak, nbr, cfg.resid_hyst_iters)

    with tracing.span("mod.decide"):
        dynamic = ((label >= 0) & dyn_cluster[lab_c]) | person | mark_resid

        # ---- temporal persistence: paused movers stop firing the cues above
        # but stay dynamic while the heat carried from their last detection
        # (warped by the camera-motion similarity, decayed) is above
        # heat_thresh. The heat is seeded only from the targeted cues (person
        # boxes and direct depth-residual marks), never from the clusters.
        if cfg.temporal_heat:
            heat_mark, new_heat = heat_update(
                prev.heat, (person | mark_resid).reshape(gh, gw), a, b, tx, ty,
                H_ok & prev.initialized, cs, cfg)
            heat_mark = heat_mark.reshape(-1) & prev.initialized
            dynamic = dynamic | heat_mark
        else:
            heat_mark = torch.zeros((n_sp,), dtype=torch.bool, device=dev)
            new_heat = prev.heat

        first_frame = ~prev.initialized | ~H_ok
        # person-, residual- and heat-driven marks apply even when the 2D
        # flow compensation failed (the rigid fit is gated separately by
        # rigid_ok; the heat falls back to an identity warp)
        is_static_sp = torch.where(first_frame,
                                   ~(person | mark_resid | heat_mark),
                                   ~dynamic)

        # ---- static keypoints (dynamic ones dropped from VO + prev context)
        static_kp = kp.valid & is_static_sp[kp_sp]

    new_prev = MODPrev(
        gray=rgb_gray,
        depth=depth,
        kp_xy=kp.xy,
        kp_p3d=kp_p3d,
        kp_desc=kp.desc,
        kp_valid=static_kp,
        initialized=torch.ones((), dtype=torch.bool, device=dev),
        heat=new_heat,
    )
    return is_static_sp, static_kp, new_prev

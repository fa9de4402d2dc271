"""Moving-object detection (MOD): geometric clustering, residual flow, the
rigid depth-residual cue and the person detector.

Port of `supersurfel_fusion_tpu/ops/motion.py` (a rewrite of the
reference's `MotionDetection::detectMotionSimple/Combined`):

* superpixel adjacency is a (GH, GW, 25) stencil over the 5x5 cell window
  (adjacent superpixels always live there), built from the cell-blocked
  reduction of ops/tps.py;
* connected components are min-label propagation over the
  convexity-gated adjacency for a fixed number of iterations;
* the camera-motion compensation chain (descriptor matches, GMS,
  similarity RANSAC, warp, dense flow) is ops/flow.py, and the depth cue
  fits the rigid motion with the pieces of
  ops/loop_closure.ransac_rigid_3d.

`detect_motion` runs as three parts (`graphs.part`) around the two SVDs
of that rigid RANSAC, which read their convergence flags on the host and
so run eagerly between them: under the frame step's stage runner on a
card each part is a CUDA graph, elsewhere it runs op by op.

The JAX version writes each propagation step as 24 shifted tables. Here a
step is one gather of all 24 neighbours from the flattened table plus a
sentinel slot, through a precomputed (25, GH*GW) index (the cell itself
and its 24 neighbours, gated ones pointing at the sentinel), so that the
geometric clustering, the residual hysteresis and the person flood fill
(all boxes at once) each cost a few launches per iteration. They are
integer min and boolean or, so the results are bit-identical to the
shifted form. With `temporal_heat` (default off) a per-cell heat map
carried in `MODPrev.heat` keeps recently marked cells dynamic
(`heat_update`); with it off the heat is carried through unchanged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from supersurfel_fusion_tpu_torch import graphs, tracing
from supersurfel_fusion_tpu_torch.config import (
    CameraIntrinsics,
    MODConfig,
    TPSConfig,
)
from supersurfel_fusion_tpu_torch.device import resolve_device
from supersurfel_fusion_tpu_torch.ops.features import Keypoints
from supersurfel_fusion_tpu_torch.ops.flow import (
    bilinear_sample,
    dense_flow,
    estimate_similarity_ransac,
    se3_depth_residual,
    warp_similarity,
)
from supersurfel_fusion_tpu_torch.ops.loop_closure import (
    rigid_hypotheses,
    rigid_refit,
    rigid_result,
)
from supersurfel_fusion_tpu_torch.ops.matching import (
    gms_filter,
    match_bruteforce,
)
from supersurfel_fusion_tpu_torch.ops.tps import TPSResult, cell_reduce
from supersurfel_fusion_tpu_torch.types import Supersurfels
from supersurfel_fusion_tpu_torch.utils.color import rgb_to_lab

Tensor = torch.Tensor

# 5x5 cell-offset table for superpixel adjacency (index 12 is the cell)
_OFFS25 = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
_CENTRE = 12
_BIG = 1 << 29


class MODPrev(NamedTuple):
    """Previous-frame context carried in the SLAM state."""

    gray: Tensor         # (H, W)
    depth: Tensor        # (H, W) bilateral-filtered depth
    kp_xy: Tensor        # (K, 2)
    kp_p3d: Tensor       # (K, 3) camera-frame keypoint positions
    kp_desc: Tensor      # (K, 8) int32 descriptor bit patterns
    kp_valid: Tensor     # (K,) bool
    initialized: Tensor  # () bool
    heat: Tensor         # (GH, GW) temporal heat; zero (temporal_heat off)


def init_prev(h: int, w: int, k: int, cell_size: int = 16,
              device: str | torch.device = "cuda") -> MODPrev:
    """The empty MOD context, on the card unless `device` asks for the CPU
    (`device.resolve_device`)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return MODPrev(
        gray=torch.zeros((h, w), **f32),
        depth=torch.zeros((h, w), **f32),
        kp_xy=torch.zeros((k, 2), **f32),
        kp_p3d=torch.zeros((k, 3), **f32),
        kp_desc=torch.zeros((k, 8), dtype=torch.int32, device=device),
        kp_valid=torch.zeros((k,), dtype=torch.bool, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        heat=torch.zeros((h // cell_size, w // cell_size), **f32),
    )


@functools.lru_cache(maxsize=None)
def _window_index(gh: int, gw: int, device: torch.device) -> Tensor:
    """(25, GH*GW) int64: flat index of cell (y+dy, x+dx) for each offset
    of `_OFFS25`, or the sentinel GH*GW where it falls off the grid. A
    table gathered through it reads as the JAX package's shift2d with the
    sentinel's value as fill."""
    y = torch.arange(gh, device=device)[:, None].expand(gh, gw)
    x = torch.arange(gw, device=device)[None, :].expand(gh, gw)
    rows = []
    for dy, dx in _OFFS25:
        ny, nx = y + dy, x + dx
        ok = (ny >= 0) & (ny < gh) & (nx >= 0) & (nx < gw)
        rows.append(torch.where(ok, ny * gw + nx,
                                torch.full_like(ny, gh * gw)).reshape(-1))
    return torch.stack(rows)


def _gather25(table: Tensor, fill, gh: int, gw: int) -> Tensor:
    """(GH, GW, ...) -> (25, GH, GW, ...): the table shifted by each
    offset, `fill` outside the grid."""
    rest = table.shape[2:]
    flat = table.reshape(gh * gw, *rest)
    ext = torch.cat([flat, torch.full((1, *rest), fill, dtype=table.dtype,
                                      device=table.device)])
    idx = _window_index(gh, gw, table.device)
    return ext[idx].reshape(25, gh, gw, *rest)


def _gated_index(mask25: Tensor, gh: int, gw: int) -> Tensor:
    """(25, N) gather index with the cell itself kept and each neighbour
    k kept only where mask25[k] (N-flat) holds; others read the
    sentinel."""
    idx = _window_index(gh, gw, mask25.device)
    keep = mask25.clone()
    keep[_CENTRE] = True
    return torch.where(keep, idx, torch.full_like(idx, gh * gw))


def _norm3(v: Tensor) -> Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def _dot3(a: Tensor, b: Tensor) -> Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross3(a: Tensor, b: Tensor) -> Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _onehot25(code: Tensor) -> Tensor:
    """(H, W) codes -> (H, W, 25) f32 one-hot; code 25 gives zeros."""
    ks = torch.arange(25, device=code.device, dtype=code.dtype)
    return (code[..., None] == ks).to(torch.float32)


def superpixel_adjacency(labels: Tensor, gh: int, gw: int, cs: int) -> Tensor:
    """(GH, GW, 25) bool: superpixel (y, x) adjacent to (y+dy, x+dx), i.e.
    some pixel has a 4-neighbour with the other label. The counts of both
    directions keyed by a pixel's own label are summed before one
    cell-blocked reduction (integer counts, so the sum is exact)."""
    gy = torch.div(labels, gw, rounding_mode="floor")
    gx = labels - gy * gw
    direct = None
    acc = torch.zeros((gh, gw, 25), dtype=torch.float32, device=labels.device)
    for dy, dx in ((0, 1), (1, 0)):
        nb = torch.full_like(labels, -1)
        H, W = labels.shape
        nb[:H - dy, :W - dx] = labels[dy:, dx:]
        ngy = torch.div(nb, gw, rounding_mode="floor")
        ngx = nb - ngy * gw
        pair_ok = (nb >= 0) & (nb != labels)
        # offset of the neighbour's label cell relative to the own one
        ddy = ngy - gy + 2
        ddx = ngx - gx + 2
        take = pair_ok & (ddy >= 0) & (ddy < 5) & (ddx >= 0) & (ddx < 5)
        none = torch.full_like(ddy, 25)
        code = torch.where(take, torch.clamp(ddy, 0, 4) * 5
                           + torch.clamp(ddx, 0, 4), none)
        onehot = _onehot25(code)
        direct = onehot if direct is None else direct + onehot
        # ... and the symmetric direction, keyed by the neighbour's label
        code_sym = torch.where(take, torch.clamp(4 - ddy, 0, 4) * 5
                               + torch.clamp(4 - ddx, 0, 4), none)
        acc = acc + cell_reduce(_onehot25(code_sym),
                                torch.where(pair_ok, nb, labels), gh, gw, cs)
    acc = acc + cell_reduce(direct, labels, gh, gw, cs)
    return acc > 0.0


def geometric_clusters(adj: Tensor, positions: Tensor, normals: Tensor,
                       conf: Tensor, gh: int, gw: int, cfg: MODConfig):
    """Connected components over convexity-gated adjacency.

    positions/normals/conf: (GH, GW, ...) per-superpixel tables (camera
    frame). Returns (root (GH, GW) int32 cluster id = min member index,
    gated_adj (GH, GW, 25) bool)."""
    eps = 1e-9
    pj = _gather25(positions, float("nan"), gh, gw)        # (25, GH, GW, 3)
    nj = _gather25(normals, 0.0, gh, gw)
    cj = _gather25(conf, -1.0, gh, gw)                     # (25, GH, GW)
    d = positions[None] - pj
    dn = _norm3(d)
    c_ij = d / torch.clamp(dn, min=eps)[..., None]
    ni = normals[None]
    dist = (_norm3(_cross3(ni, nj)) + torch.abs(_dot3(ni, c_ij))
            + torch.abs(_dot3(nj, c_ij))) / 3.0
    gated = (adj.permute(2, 0, 1) & (conf > 0.0)[None] & (cj > 0.0)
             & torch.isfinite(dist) & (dist < cfg.convexity_thresh))

    n = gh * gw
    nbr = _gated_index(gated.reshape(25, n), gh, gw)
    ext = torch.cat([torch.arange(n, dtype=torch.int32, device=adj.device),
                     torch.full((1,), _BIG, dtype=torch.int32,
                                device=adj.device)])
    for _ in range(cfg.cc_iters):
        ext[:n] = ext[nbr].amin(0)
    return ext[:n].reshape(gh, gw), gated.permute(1, 2, 0)


def _grow(seed: Tensor, eligible: Tensor, nbr: Tensor, n_iters: int
          ) -> Tensor:
    """Boolean propagation m <- m | (any adjacent m & eligible), n_iters
    times, over the last axis (N-flat); nbr is a `_gated_index`."""
    n = seed.shape[-1]
    ext = torch.cat([seed, torch.zeros_like(seed[..., :1])], dim=-1)
    for _ in range(n_iters):
        grown = ext[..., nbr].any(-2)
        ext[..., :n] = ext[..., :n] | (grown & eligible)
    return ext[..., :n]


def person_flood_fill(boxes: Tensor, boxes_valid: Tensor, adj: Tensor,
                      centroids: Tensor, positions: Tensor, conf: Tensor,
                      labels: Tensor, gh: int, gw: int, cs: int = 16,
                      depth_gate: float = 0.3, n_iters: int = 48) -> Tensor:
    """Mark superpixels inside person detections as dynamic: seed at the
    superpixel of the box centre, then propagate over the adjacency to
    superpixels whose centroid lies in the box and whose depth is within
    `depth_gate` of the seed's (or whose geometry is invalid). All boxes
    are filled at once, as a (B, GH*GW) mask.

    boxes: (B, 4) [x0, y0, x1, y1]; centroids (GH, GW, 2); positions
    (GH, GW, 3) camera frame; conf (GH, GW). Returns (GH, GW) bool."""
    n = gh * gw
    cx = centroids[..., 0].reshape(1, n)
    cy = centroids[..., 1].reshape(1, n)
    b = boxes[:, :, None]
    in_box = (cx >= b[:, 0]) & (cx < b[:, 2]) & (cy >= b[:, 1]) \
        & (cy < b[:, 3])                                   # (B, N)
    px = torch.clamp(((boxes[:, 0] + boxes[:, 2]) * 0.5 / cs).to(torch.int64),
                     0, gw - 1)
    py = torch.clamp(((boxes[:, 1] + boxes[:, 3]) * 0.5 / cs).to(torch.int64),
                     0, gh - 1)
    cell = py * gw + px
    seed = torch.zeros((boxes.shape[0], n), dtype=torch.bool,
                       device=boxes.device)
    seed.scatter_(1, cell[:, None], True)
    z = positions[..., 2].reshape(1, n)
    z_seed = z[0, cell][:, None]
    eligible = in_box & ((torch.abs(z - z_seed) < depth_gate)
                         | (conf.reshape(1, n) <= 0.0))
    nbr = _gated_index(adj.permute(2, 0, 1).reshape(25, n), gh, gw)
    filled = _grow(seed, eligible, nbr, n_iters)
    dynamic = (filled & in_box & boxes_valid[:, None]).any(0)
    return dynamic.reshape(gh, gw)


def _keypoint_pixels(xy: Tensor, H: int, W: int):
    ui = torch.clamp(torch.round(xy[:, 0]), 0, W - 1).to(torch.int64)
    vi = torch.clamp(torch.round(xy[:, 1]), 0, H - 1).to(torch.int64)
    return ui, vi


def _cluster_sum(lab_c: Tensor, values: Tensor, n: int) -> Tensor:
    out = torch.zeros((n + 1,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, lab_c, values)


def heat_update(prev_heat: Tensor, fresh: Tensor, a, b, tx, ty, warp_ok,
                cs: int, cfg: MODConfig):
    """Temporal-persistence update for the dynamic mask.

    prev_heat: (GH, GW) heat after the previous frame. fresh: (GH, GW) bool,
    this frame's real-evidence dynamic marks. (a, b, tx, ty) is the
    previous->current camera-motion similarity; the heat rides along by
    sampling prev_heat at the inverse-transformed current cell centre
    (the identity where warp_ok is false). Returns (heat_mark (GH, GW)
    bool: the cells to keep dynamic, new_heat (GH, GW)). Fresh evidence
    rewrites the heat to 1, so persistence is bounded at about
    log(heat_thresh)/log(heat_decay) frames after the last real
    detection; the heat never reinforces itself."""
    gh, gw = prev_heat.shape
    dev = prev_heat.device
    a, b, tx, ty = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                    for v in (a, b, tx, ty))
    cy = (torch.arange(gh, dtype=torch.float32, device=dev)[:, None]
          + 0.5).expand(gh, gw) * cs
    cx = (torch.arange(gw, dtype=torch.float32, device=dev)[None, :]
          + 0.5).expand(gh, gw) * cs
    det_s = torch.clamp(a * a + b * b, min=1e-12)
    px = (a * (cx - tx) + b * (cy - ty)) / det_s
    py = (-b * (cx - tx) + a * (cy - ty)) / det_s
    warp_ok = torch.as_tensor(warp_ok, device=dev)
    px = torch.where(warp_ok, px, cx)
    py = torch.where(warp_ok, py, cy)
    warped = bilinear_sample(prev_heat, px / cs - 0.5, py / cs - 0.5, 0.0)
    heat_mark = warped > cfg.heat_thresh
    new_heat = torch.maximum(fresh.to(torch.float32),
                             warped * cfg.heat_decay)
    return heat_mark, new_heat


def detect_motion(
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
    heat marks apply.

    The pass is three parts around the two SVDs of the depth cue's rigid
    RANSAC (`loop_closure.ransac_rigid_3d`, in its pieces): `mod.a` up to
    the hypotheses' cross-covariances, `mod.b` (`rigid_refit`) from their
    rotations to the refit's, `mod.c` from the refit's rotation to the
    decision. Each part goes through `graphs.part` (a CUDA graph under the
    stage runner, op by op elsewhere); the SVDs run eagerly between them,
    since they wait for the device. Without the depth cue it is `mod.a`
    and `mod.c`."""
    H, W = rgb_gray.shape
    combined = cfg.use_yolo and detector is not None
    cues = graphs.part("mod.a", _mod_a, rgb_gray, depth, prev, kp, frame,
                       tps.labels, tps.stats, cam, tps_cfg, cfg, combined,
                       detector)
    refit = None
    if cues.rigid is not None:
        dst, pair_ok, hyp, w3, _ = cues.rigid
        U, Vt = _svd(hyp[2])
        fit, best_inl = graphs.part(
            "mod.b", rigid_refit, U, Vt, hyp, w3, prev.kp_p3d, dst, pair_ok,
            0.05, prev.kp_xy, float(W), float(H))
        U, Vt = _svd(fit[2])
        refit = (U, Vt, fit, best_inl)
    return graphs.part("mod.c", _mod_c, rgb_gray, depth, prev, kp,
                       frame.positions, tps.labels, cam, tps_cfg, cfg,
                       combined, cues, refit)


def _svd(H: Tensor):
    """(U, Vt) of `torch.linalg.svd(H)`, an op run eagerly between MOD's
    parts: it reads its convergence flags on the host."""
    with tracing.eager_op("mod.svd"):
        U, _, Vt = torch.linalg.svd(H)
    return U, Vt


class _Cues(NamedTuple):
    """What `mod.a` hands on to the rest of `detect_motion`."""

    label: Tensor        # (N,) int64 cluster label after fill-in, -1 none
    lab_c: Tensor        # (N,) int64 label, N where none
    cl_cnt: Tensor       # (N + 1,) f32 superpixels per cluster
    dyn_cluster: Tensor  # (N + 1,) bool: the cluster flow cue
    person: Tensor       # (N,) bool
    adj24: Tensor        # (25, N) bool neighbours in offset order
    kp_sp: Tensor        # (K,) int64 superpixel of each keypoint
    kp_p3d: Tensor       # (K, 3) camera-frame keypoints
    similarity: tuple    # (a, b, tx, ty, valid): previous -> current image
    # the depth cue's rigid RANSAC: (dst (K, 3), pair_ok (K,), the
    # hypotheses' moments, w3, n_ok) (`rigid_hypotheses`); None without
    # the cue
    rigid: tuple | None


def _mod_a(rgb_gray, depth, prev, kp, frame, labels, stats, cam, tps_cfg,
           cfg, combined, detector) -> _Cues:
    """Part `mod.a`: clusters, persons, flow, fill-in, the cluster flow
    cue and the rigid RANSAC up to its hypotheses' cross-covariances."""
    H, W = rgb_gray.shape
    dev = rgb_gray.device
    cs = tps_cfg.cell_size
    gh, gw = H // cs, W // cs
    n_sp = gh * gw

    # ---- geometric clustering
    with tracing.span("mod.clusters"):
        adj = superpixel_adjacency(labels, gh, gw, cs)
        pos_t = frame.positions.reshape(gh, gw, 3)
        nrm_t = frame.orientations[:, 2, :].reshape(gh, gw, 3)
        conf_t = frame.confidences.reshape(gh, gw)
        root, _ = geometric_clusters(adj, pos_t, nrm_t, conf_t, gh, gw, cfg)

    # ---- combined path: person boxes -> depth-guided flood fill first, so
    # person keypoints never enter the camera-motion estimation and person
    # superpixels never dilute cluster flow statistics
    with tracing.span("mod.person"):
        ui, vi = _keypoint_pixels(kp.xy, H, W)
        kp_sp = labels[vi, ui].to(torch.int64)
        if combined:
            det = detector(rgb_gray, depth, max_det=cfg.max_person_boxes,
                           score_thresh=cfg.person_score_thresh)
            person = person_flood_fill(
                det.boxes, det.valid, adj, stats.centroid, pos_t, conf_t,
                labels, gh, gw, cs, depth_gate=cfg.person_depth_gate,
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
        sums = cell_reduce(fl, labels, gh, gw, cs)                # (GH, GW, 2)
        sp_size = torch.clamp(stats.size, min=1.0)
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
        lab_col = rgb_to_lab(stats.color)                         # (GH, GW, 3)
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
        # RANSAC over the matched keypoints (to its SVDs here)
        rigid = None
        if _depth_cue_scale(cfg, combined) > 0:
            pair_ok = (inl & kp_z_ok[midx] & prev.kp_valid
                       & (prev.kp_p3d[:, 2] >= 0.2)
                       & (prev.kp_p3d[:, 2] < 5.0))
            dst = kp_p3d[midx]
            rigid = (dst, pair_ok,
                     *rigid_hypotheses(prev.kp_p3d, dst, pair_ok))
    return _Cues(label, lab_c, cl_cnt, dyn_cluster, person, adj24, kp_sp,
                 kp_p3d, (a, b, tx, ty, H_ok), rigid)


def _depth_cue_scale(cfg: MODConfig, combined: bool) -> float:
    return (cfg.depth_cue_scale_combined if combined
            else cfg.depth_cue_scale_simple)


def _mod_c(rgb_gray, depth, prev, kp, positions, labels, cam, tps_cfg, cfg,
           combined, cues: _Cues, refit):
    """Part `mod.c`: from the refit's SVD (`refit`: U, Vt, the refit's
    moments, the winners; None without the depth cue) to the rigid
    motion, the SE(3) depth residual, its hysteresis and the decision.
    Returns `detect_motion`'s (is_static_sp, static_kp, new_prev)."""
    H, W = rgb_gray.shape
    dev = rgb_gray.device
    cs = tps_cfg.cell_size
    gh, gw = H // cs, W // cs
    n_sp = gh * gw
    label, lab_c, cl_cnt, dyn_cluster, person = cues[:5]
    a, b, tx, ty, H_ok = cues.similarity

    with tracing.span("mod.cues"):
        dscale = _depth_cue_scale(cfg, combined)
        mark_resid = torch.zeros((n_sp,), dtype=torch.bool, device=dev)
        if refit is not None:
            R_rig, t_rig, rigid_ok, _ = rigid_result(
                *refit, cues.rigid[4], min_inliers=15, min_ratio=0.15)
            resid = se3_depth_residual(depth, prev.depth, R_rig, t_rig,
                                       cam.fx, cam.fy, cam.cx, cam.cy)
            resid_abs = torch.abs(resid)
            # positive part only: pixels newly covered by a mover
            resid_pos = torch.clamp(resid, min=0.0)
            r_valid = (resid_abs > 0.0).to(torch.float32)
            rsums = cell_reduce(
                torch.stack([resid_abs, resid_pos, r_valid], -1),
                labels, gh, gw, cs)
            den = torch.clamp(rsums[..., 2], min=32.0)
            sp_zdiff = (rsums[..., 0] / den).reshape(-1)
            sp_pos_t = rsums[..., 1] / den
            pos_z = positions.reshape(gh, gw, 3)[..., 2]
            zsp = torch.where(pos_z > 0, pos_z,
                              torch.zeros_like(pos_z)).reshape(-1)
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
                nbr = _gated_index(cues.adj24, gh, gw)
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
        static_kp = kp.valid & is_static_sp[cues.kp_sp]

    new_prev = MODPrev(
        gray=rgb_gray,
        depth=depth,
        kp_xy=kp.xy,
        kp_p3d=cues.kp_p3d,
        kp_desc=kp.desc,
        kp_valid=static_kp,
        initialized=torch.ones((), dtype=torch.bool, device=dev),
        heat=new_heat,
    )
    return is_static_sp, static_kp, new_prev

"""Global model fusion and maintenance.

Port of `supersurfel_fusion_tpu/ops/fusion.py` (a rewrite of the
reference's model update pass: findBestMatches, updateSupersurfels,
insertSupersurfels, filterModel):

* min-by-distance match selection is one deterministic scatter-min with an
  encoded key (quantized distance high, model id low);
* insertion is a cumulative-sum compaction;
* the compaction is a stable 3-way partition by cumulative sums, so slot
  order (active < inactive < invalid) matches the JAX package exactly.

JAX's `mode="drop"` scatters silently drop out-of-range indices; torch
raises on them, so every such scatter here writes into one extra sentinel
row that is cut off afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from supersurfel_fusion_tpu_torch.config import CameraIntrinsics, FusionConfig
from supersurfel_fusion_tpu_torch.types import ModelState, Supersurfels
from supersurfel_fusion_tpu_torch.utils.color import lab_to_rgb, rgb_to_lab
from supersurfel_fusion_tpu_torch.utils.geometry import (
    eigh3x3,
    inv3x3_sym,
    mult_ABAt,
)

Tensor = torch.Tensor

_BIG = 2**30


def scatter_set_drop(dst: Tensor, idx: Tensor, src: Tensor) -> Tensor:
    """`dst.at[idx].set(src, mode="drop")`: rows of `src` go to `idx`;
    indices outside [0, len(dst)) are dropped. Where several rows hit one
    index the last one wins (the CPU order of the JAX package), resolved
    explicitly so that the result is deterministic on the GPU too."""
    n = dst.shape[0]
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, torch.full_like(idx, n)).to(torch.int64)
    order = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, tgt, order, reduce="amax")
    win = ok & (last[tgt] == order)
    tgt = torch.where(win, tgt, torch.full_like(tgt, n))
    ext = torch.cat([dst, dst[:1]], dim=0).clone()
    ext[tgt] = src.to(dst.dtype)
    return ext[:n]


class MatchResult(NamedTuple):
    matched: Tensor       # (F,) bool — frame superpixel hit by a projection
    model_match: Tensor   # (F,) int32 — best matching model id, or -1


def find_best_matches(model: Supersurfels, nb_visible: Tensor,
                      frame: Supersurfels, labels: Tensor,
                      R: Tensor, t: Tensor, cam: CameraIntrinsics,
                      cfg: FusionConfig) -> MatchResult:
    """Projective model->frame association with min-distance selection.
    (R, t) is the camera->world pose. `model` may be the visible prefix."""
    dev = labels.device
    C = model.capacity
    F = frame.capacity
    H, W = labels.shape

    ids = torch.arange(C, dtype=torch.int32, device=dev)
    live = (ids < torch.clamp(nb_visible, max=C)) & (model.confidences > 0.0)

    Rv = R.T
    tv = -(Rv @ t)
    pm = model.positions @ Rv.T + tv
    z = pm[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = torch.round(pm[:, 0] * cam.fx / safe_z + cam.cx)
    v = torch.round(pm[:, 1] * cam.fy / safe_z + cam.cy)
    u = torch.clamp(u, -1.0, float(W)).to(torch.int64)
    v = torch.clamp(v, -1.0, float(H)).to(torch.int64)
    proj_ok = (live & (z > cfg.range_min) & (z < cfg.range_max)
               & (u >= 0) & (u < W) & (v >= 0) & (v < H))
    fid = labels[torch.clamp(v, 0, H - 1), torch.clamp(u, 0, W - 1)].to(
        torch.int64)
    fid_matched = torch.where(proj_ok, fid, torch.full_like(fid, F))

    hit = torch.zeros((F + 1,), dtype=torch.int32, device=dev)
    hit = hit.scatter_reduce(0, fid_matched,
                             torch.ones_like(fid_matched, dtype=torch.int32),
                             reduce="amax")
    matched = hit[:F] > 0

    fpos = (frame.positions @ R.T + t)[fid]
    fnormal = (frame.orientations[:, 2, :] @ R.T)[fid]
    flab = rgb_to_lab(frame.colors)[fid]
    fconf = frame.confidences[fid]

    mlab = rgb_to_lab(model.colors)
    mnormal = model.orientations[:, 2, :]

    dist = torch.linalg.norm(model.positions - fpos, dim=-1)
    lab_dist = torch.linalg.norm(mlab - flab, dim=-1)
    ndot = torch.abs(torch.sum(mnormal * fnormal, dim=-1))

    gate = (proj_ok & (fconf > 0.0)
            & (lab_dist < cfg.match_max_color_dist)
            & (ndot > cfg.match_min_normal_dot)
            & (dist < cfg.match_max_dist))
    dq = torch.clamp(torch.round(dist / cfg.match_max_dist * 4096.0),
                     0, 4095).to(torch.int32)
    key = torch.where(gate, (dq << 17) | ids, torch.full_like(ids, _BIG))
    fid_gated = torch.where(gate, fid, torch.full_like(fid, F))
    best = torch.full((F + 1,), _BIG, dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, fid_gated, key, reduce="amin")[:F]
    model_match = torch.where(best < _BIG, best & ((1 << 17) - 1),
                              torch.full_like(best, -1))
    return MatchResult(matched=matched, model_match=model_match)


def _fuse(frame: Supersurfels, model: Supersurfels, match: MatchResult,
          R: Tensor, t: Tensor, stamp: Tensor) -> Supersurfels:
    """Confidence-weighted inverse-covariance fusion of matched pairs."""
    F = frame.capacity
    C = model.capacity
    mid = match.model_match.to(torch.int64)
    do = (mid >= 0) & match.matched
    mid_c = torch.clamp(mid, 0, C - 1)

    m_pos = model.positions[mid_c]
    m_shape = model.shapes[mid_c]
    m_conf = model.confidences[mid_c]
    m_lab = rgb_to_lab(model.colors[mid_c])
    m_stamps = model.stamps[mid_c]

    f_pos = frame.positions @ R.T + t
    f_shape = mult_ABAt(R[None], frame.shapes)
    f_lab = rgb_to_lab(frame.colors)
    f_conf = frame.confidences

    ratio = 1.0 / torch.clamp(m_conf + f_conf, min=1e-12)
    w = (ratio * f_conf)[:, None, None]

    f_inv, f_ok = inv3x3_sym(f_shape)
    m_inv, m_ok = inv3x3_sym(m_shape)
    fused_inv = w * f_inv + (1.0 - w) * m_inv
    fused_shape_ic, ic_ok = inv3x3_sym(fused_inv)
    use_ic = f_ok & m_ok & ic_ok

    pos_ic = torch.einsum(
        "nij,nj->ni",
        fused_shape_ic,
        torch.einsum("nij,nj->ni", w * f_inv, f_pos)
        + torch.einsum("nij,nj->ni", (1.0 - w) * m_inv, m_pos),
    )
    shape_lin = ratio[:, None, None] * (
        f_conf[:, None, None] * f_shape + m_conf[:, None, None] * m_shape)
    pos_lin = ratio[:, None] * (f_conf[:, None] * f_pos
                                + m_conf[:, None] * m_pos)

    fused_shape = torch.where(use_ic[:, None, None], fused_shape_ic,
                              shape_lin)
    fused_pos = torch.where(use_ic[:, None], pos_ic, pos_lin)
    fused_lab = ratio[:, None] * (f_conf[:, None] * f_lab
                                  + m_conf[:, None] * m_lab)
    fused_color = lab_to_rgb(fused_lab)
    fused_conf = m_conf + f_conf

    vecs, vals = eigh3x3(fused_shape)
    new_stamps = torch.stack(
        [m_stamps[:, 0], torch.as_tensor(stamp, dtype=torch.int32,
                                         device=mid.device).expand(F)],
        dim=-1)

    tgt = torch.where(do, mid_c, torch.full_like(mid_c, C))

    def scatter(dst, src):
        return scatter_set_drop(dst, tgt, src)

    return Supersurfels(
        positions=scatter(model.positions, fused_pos),
        colors=scatter(model.colors, fused_color),
        stamps=scatter(model.stamps, new_stamps),
        orientations=scatter(model.orientations, vecs),
        shapes=scatter(model.shapes, fused_shape),
        dims=scatter(model.dims, vals[:, :2]),
        confidences=scatter(model.confidences, fused_conf),
    )


def _insert(frame: Supersurfels, model: Supersurfels, match: MatchResult,
            nb_supersurfels: Tensor, R: Tensor, t: Tensor, stamp: Tensor,
            allow: Tensor | None = None):
    """Append unmatched valid frame surfels via prefix-sum compaction.
    `allow` (() bool), when false, inserts nothing and drops nothing."""
    F = frame.capacity
    C = model.capacity
    insert = (frame.confidences > 0.0) & ~match.matched
    if allow is not None:
        insert = insert & allow
    slot_off = torch.cumsum(insert.to(torch.int32), 0) - 1
    slot = nb_supersurfels + slot_off
    ok = insert & (slot < C)
    tgt = torch.where(ok, slot, torch.full_like(slot, C)).to(torch.int64)

    f_pos = frame.positions @ R.T + t
    f_shape = mult_ABAt(R[None], frame.shapes)
    f_rot = frame.orientations @ R.T
    new_stamps = torch.as_tensor(stamp, dtype=torch.int32,
                                 device=tgt.device).expand(F, 2)

    def scatter(dst, src):
        return scatter_set_drop(dst, tgt, src)

    new_model = Supersurfels(
        positions=scatter(model.positions, f_pos),
        colors=scatter(model.colors, frame.colors),
        stamps=scatter(model.stamps, new_stamps),
        orientations=scatter(model.orientations, f_rot),
        shapes=scatter(model.shapes, f_shape),
        dims=scatter(model.dims, frame.dims),
        confidences=scatter(model.confidences, frame.confidences),
    )
    n_inserted = torch.sum(ok.to(torch.int32))
    n_dropped = torch.sum(insert.to(torch.int32)) - n_inserted
    return new_model, (nb_supersurfels + n_inserted).to(torch.int32), \
        n_dropped.to(torch.int32)


def filter_and_compact(model: Supersurfels, nb_supersurfels: Tensor,
                       depth: Tensor, R: Tensor, t: Tensor,
                       cam: CameraIntrinsics, cfg: FusionConfig,
                       conf_thresh: float, stamp: Tensor):
    """Stale/free-space removal + stable compaction. Returns
    (model, nb_supersurfels, nb_visible)."""
    dev = depth.device
    C = model.capacity
    H, W = depth.shape
    ids = torch.arange(C, dtype=torch.int32, device=dev)
    in_range = ids < nb_supersurfels

    time_diff = stamp - model.stamps[:, 1]
    stale = ((time_diff > cfg.delta_t) & (model.confidences < conf_thresh)
             & (stamp > cfg.delta_t))
    dead = stale | (model.confidences <= 0.0)

    Rv = R.T
    tv = -(Rv @ t)
    p = model.positions @ Rv.T + tv
    z = p[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = p[:, 0] * cam.fx / safe_z + cam.cx
    v = p[:, 1] * cam.fy / safe_z + cam.cy
    z_ok = (z > cfg.range_min) & (z < cfg.range_max)
    img_ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    # float->int truncates toward zero like astype(int32); clamp first so
    # far-off projections cannot overflow the cast
    ui = torch.clamp(torch.clamp(u, -1.0, float(W)).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.clamp(v, -1.0, float(H)).to(torch.int64), 0, H - 1)
    zobs = depth[vi, ui]
    free_space = (z_ok & img_ok & torch.isfinite(zobs)
                  & (z < cfg.free_space_ratio * zobs))

    invalid = dead | (~dead & free_space)
    visible = ~invalid & z_ok & img_ok
    state = torch.where(invalid, 2, torch.where(visible, 0, 1))
    state = torch.where(in_range, state, 3)

    conf = torch.where((invalid & in_range) | ~in_range,
                       torch.full_like(model.confidences, -1.0),
                       model.confidences)
    model = model._replace(confidences=conf)

    k0 = state == 0
    k1 = state == 1
    n0 = torch.sum(k0.to(torch.int32))
    n1 = torch.sum(k1.to(torch.int32))
    pos = torch.where(
        k0, torch.cumsum(k0.to(torch.int32), 0) - 1,
        torch.where(
            k1, n0 + torch.cumsum(k1.to(torch.int32), 0) - 1,
            n0 + n1 + torch.cumsum((~k0 & ~k1).to(torch.int32), 0) - 1,
        ),
    ).to(torch.int64)

    def permute(a):
        out = torch.empty_like(a)
        out[pos] = a
        return out

    model = Supersurfels(*(permute(a) for a in model))
    return model, (n0 + n1).to(torch.int32), n0.to(torch.int32)


class FusionStats(NamedTuple):
    """Per-frame fusion telemetry (all () int32)."""

    n_fused: Tensor
    n_inserted: Tensor
    n_removed: Tensor
    n_dropped: Tensor


def _bootstrap(model: Supersurfels, frame: Supersurfels, R: Tensor,
               t: Tensor):
    F = frame.capacity
    dev = R.device
    boot = Supersurfels.empty(model.capacity, dev)
    first = Supersurfels(
        positions=frame.positions @ R.T + t,
        colors=frame.colors,
        stamps=frame.stamps,
        orientations=frame.orientations @ R.T,
        shapes=mult_ABAt(R[None], frame.shapes),
        dims=frame.dims,
        confidences=frame.confidences,
    )
    boot = Supersurfels(*(torch.cat([a, b[F:]], dim=0)
                          for a, b in zip(first, boot)))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    nF = torch.full((), F, dtype=torch.int32, device=dev)
    return ModelState(boot, nF, nF.clone()), FusionStats(zero, nF, zero, zero)


def where_tree(ok: Tensor, new, old):
    """`new` where the () bool `ok` holds, else `old`: the same nesting of
    NamedTuples and tuples of tensors, selected leaf by leaf on the
    device."""
    if isinstance(new, Tensor):
        return torch.where(ok, new, old)
    parts = [where_tree(ok, a, b) for a, b in zip(new, old)]
    return type(new)(*parts) if hasattr(new, "_fields") else type(new)(parts)


def update_model(state: ModelState, frame: Supersurfels, labels: Tensor,
                 plane_depth: Tensor, R: Tensor, t: Tensor,
                 cam: CameraIntrinsics, cfg: FusionConfig,
                 conf_thresh: float, stamp: Tensor,
                 allow_insert: Tensor | None = None):
    """Full per-frame model maintenance, bootstrap included.
    Returns (ModelState, FusionStats).

    The JAX package picks bootstrap or update with `lax.cond`; here both are
    computed and the result selected on the device, so the frame step needs
    no host sync. `allow_insert` (() bool tensor), when false, skips the
    insertion of new surfels while fusion, visibility and filtering stay
    live (`fusion.insert_requires_icp`); the JAX package's `lax.cond` is a
    mask here, with the same result. None always inserts."""
    model, nb, nbv = state.surfels, state.nb_supersurfels, state.nb_visible
    boot_state, boot_stats = _bootstrap(model, frame, R, t)

    vcap = min(cfg.visible_cap, model.capacity)
    match = find_best_matches(model.prefix(vcap), nbv, frame, labels, R, t,
                              cam, cfg)
    fused = _fuse(frame, model, match, R, t, stamp)
    inserted, nb_new, n_dropped = _insert(frame, fused, match, nb, R, t,
                                          stamp, allow_insert)
    compacted, nb_live, nb_vis = filter_and_compact(
        inserted, nb_new, plane_depth, R, t, cam, cfg, conf_thresh, stamp)
    stats = FusionStats(
        n_fused=torch.sum(((match.model_match >= 0) & match.matched).to(
            torch.int32)),
        n_inserted=(nb_new - nb).to(torch.int32),
        n_removed=(nb_new - nb_live).to(torch.int32),
        n_dropped=n_dropped,
    )
    return where_tree(nb == 0, (boot_state, boot_stats),
                      (ModelState(compacted, nb_live, nb_vis), stats))

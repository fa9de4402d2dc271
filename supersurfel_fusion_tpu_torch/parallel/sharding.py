"""Distributed map: the global supersurfel model block-sharded over ranks.

Port of `supersurfel_fusion_tpu/parallel/sharding.py`. Each rank owns
`capacity / D` slots of the model with a local live count; the frame's
surfels, label image and plane depth are replicated. The frame's model
update on every rank:

1. project this rank's block into the frame and encode a match key per
   frame superpixel, (quantized distance << 20) | global id, in int32
   (so the model holds at most 2^20 surfels);
2. one collective takes the minimum key of each superpixel over the
   ranks, and the maximum of its `matched` flag (as the minimum of its
   negation, in the same int32 buffer);
3. each rank fuses the matched pairs whose winner it owns;
4. unmatched frame surfels are inserted on rank `stamp mod D` alone
   (round robin: bounded imbalance, no coordination);
5. stale and free-space filtering and the stable compaction run on each
   rank's block; the totals are sums of the local counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from supersurfel_fusion_tpu_torch.config import CameraIntrinsics, FusionConfig
from supersurfel_fusion_tpu_torch.ops import fusion as fusion_ops
from supersurfel_fusion_tpu_torch.parallel.mesh import Mesh, pmin, psum
from supersurfel_fusion_tpu_torch.types import Supersurfels
from supersurfel_fusion_tpu_torch.utils.color import rgb_to_lab

Tensor = torch.Tensor

_BIG = 2**30
GID_BITS = 20


class DistributedModel(NamedTuple):
    """This rank's block of the model and its local counts."""

    surfels: Supersurfels        # (capacity / D) rows
    nb_local: Tensor             # () int32 live slots (a prefix)
    nb_visible_local: Tensor     # () int32 visible slots (a prefix)

    @property
    def capacity(self) -> int:
        """The capacity of this rank's block."""
        return self.surfels.capacity


def check_capacity(capacity: int, mesh: Mesh) -> int:
    """The block size of a model of `capacity` slots over the mesh."""
    if capacity % mesh.axis_size:
        raise ValueError(f"nb_supersurfels_max={capacity} does not divide "
                         f"over {mesh.axis_size} ranks")
    if capacity > 1 << GID_BITS:
        raise ValueError(f"the match key holds {GID_BITS}-bit surfel ids: "
                         f"capacity {capacity} > 2^{GID_BITS}")
    return capacity // mesh.axis_size


def make_distributed_model(capacity: int, mesh: Mesh) -> DistributedModel:
    """An empty model of `capacity` global slots; this rank's block."""
    cl = check_capacity(capacity, mesh)
    i32 = dict(dtype=torch.int32, device=mesh.device)
    return DistributedModel(
        surfels=Supersurfels.empty(cl, mesh.device),
        nb_local=torch.zeros((), **i32),
        nb_visible_local=torch.zeros((), **i32))


def local_model_update(model: Supersurfels, nb_loc: Tensor, nb_vis: Tensor,
                       frame: Supersurfels, labels: Tensor,
                       plane_depth: Tensor, R: Tensor, t: Tensor,
                       stamp: Tensor, cam: CameraIntrinsics,
                       cfg: FusionConfig, conf_thresh: float, mesh: Mesh):
    """Steps 1-5 of the module docstring on this rank's block `model`
    with its local counts. Returns (model, nb_live, nb_visible), local."""
    dev = labels.device
    me, d = mesh.axis_index, mesh.axis_size
    Cl = model.capacity
    F = frame.capacity
    H, W = labels.shape

    # 1. local match keys
    ids = torch.arange(Cl, dtype=torch.int32, device=dev)
    live = (ids < nb_vis) & (model.confidences > 0.0)
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
    fid_m = torch.where(proj_ok, fid, torch.full_like(fid, F))
    matched_loc = torch.zeros((F + 1,), dtype=torch.int32, device=dev)
    matched_loc = matched_loc.scatter_reduce(
        0, fid_m, torch.ones_like(fid_m, dtype=torch.int32),
        reduce="amax")[:F]

    fpos = (frame.positions @ R.T + t)[fid]
    fnormal = (frame.orientations[:, 2, :] @ R.T)[fid]
    flab = rgb_to_lab(frame.colors)[fid]
    fconf = frame.confidences[fid]
    mlab = rgb_to_lab(model.colors)
    mnormal = model.orientations[:, 2, :]
    dist = torch.linalg.norm(model.positions - fpos, dim=-1)
    gate = (proj_ok & (fconf > 0.0)
            & (torch.linalg.norm(mlab - flab, dim=-1)
               < cfg.match_max_color_dist)
            & (torch.abs(torch.sum(mnormal * fnormal, -1))
               > cfg.match_min_normal_dot)
            & (dist < cfg.match_max_dist))
    gid = me * Cl + ids
    dq = torch.clamp(torch.round(dist / cfg.match_max_dist * 2048.0),
                     0, 2047).to(torch.int32)
    key = torch.where(gate, (dq << GID_BITS) | gid, torch.full_like(gid, _BIG))
    keys_loc = torch.full((F + 1,), _BIG, dtype=torch.int32, device=dev)
    keys_loc = keys_loc.scatter_reduce(
        0, torch.where(gate, fid, torch.full_like(fid, F)), key,
        reduce="amin")[:F]

    # 2. the global combine: min of the keys and max of `matched` (as the
    # min of its negation) in one collective
    both = pmin(torch.cat([keys_loc, -matched_loc]), mesh)
    keys = both[:F]
    matched = both[F:] < 0
    best_gid = torch.where(keys < _BIG, keys & ((1 << GID_BITS) - 1),
                           torch.full_like(keys, -1))

    # 3. fuse the pairs this rank owns
    owned = (best_gid >= me * Cl) & (best_gid < (me + 1) * Cl)
    mid_local = torch.where(owned, best_gid - me * Cl,
                            torch.full_like(best_gid, -1))
    match = fusion_ops.MatchResult(matched=matched, model_match=mid_local)
    model = fusion_ops._fuse(frame, model, match, R, t, stamp)

    # 4. round-robin insertion: rank (stamp mod D) takes this frame's
    do_insert = (stamp % d) == me
    ins_model, nb_after, _ = fusion_ops._insert(frame, model, match, nb_loc,
                                                R, t, stamp)
    model = Supersurfels(*(
        torch.where(do_insert.reshape((1,) * a.ndim), a, b)
        for a, b in zip(ins_model, model)))
    nb_loc = torch.where(do_insert, nb_after, nb_loc)

    # 5. local filter + stable compaction
    return fusion_ops.filter_and_compact(model, nb_loc, plane_depth, R, t,
                                         cam, cfg, conf_thresh, stamp)


def make_sharded_update(mesh: Mesh, cam: CameraIntrinsics,
                        cfg: FusionConfig, conf_thresh: float):
    """The distributed model-update step: step(dm, frame, labels,
    plane_depth, R, t, stamp) -> dm."""

    def step(dm: DistributedModel, frame: Supersurfels, labels: Tensor,
             plane_depth: Tensor, R: Tensor, t: Tensor,
             stamp: Tensor) -> DistributedModel:
        model, nb_live, nb_vis = local_model_update(
            dm.surfels, dm.nb_local, dm.nb_visible_local, frame, labels,
            plane_depth, R, t, stamp, cam, cfg, conf_thresh, mesh)
        return DistributedModel(model, nb_live, nb_vis)

    return step


def totals(dm: DistributedModel, mesh: Mesh) -> tuple[int, int]:
    """(live surfels, visible surfels) over all ranks, read on the host."""
    s = psum(torch.stack([dm.nb_local, dm.nb_visible_local]), mesh)
    return int(s[0]), int(s[1])

"""The keyframe store (fern codes, pose graph and loop-closure payloads)
sharded over the ranks.

Port of `supersurfel_fusion_tpu/parallel/kf_sharded.py`. The layout is
round robin: global keyframe k lives on rank k mod D at local row k div D,
so the store stays balanced at every fill level and the global insertion
order, which the fern rule "best keyframe = the first of the least
dissimilar" and the stamp gate rely on, is index arithmetic. The global
keyframe count is replicated.

Collectives: one int32 minimum per frame for the query (the code compare
is local to each rank); one int32 sum for the best keyframe's stamp,
which the loop-closure gate reads; and on a loop-closure frame the best
keyframe's payload, broadcast as a sum in which the ranks that do not own
it contribute zeros (one float32 and one int32 sum; booleans travel as
int32, descriptors as int32 bit patterns, so the sum is exact).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from supersurfel_fusion_tpu_torch.ops.ferns import FernDB, masked_put
from supersurfel_fusion_tpu_torch.ops.loop_closure import KeyframeStore
from supersurfel_fusion_tpu_torch.parallel.mesh import (
    Mesh,
    pmin,
    psum,
    psum_packed,
)

Tensor = torch.Tensor


def local_rows(max_kf: int, d: int) -> int:
    """Rows of the store on each of `d` ranks."""
    if max_kf % d:
        raise ValueError(f"max_keyframes={max_kf} does not divide over {d} "
                         "ranks (round-robin keyframe sharding)")
    return max_kf // d


def global_ids(rows: int, mesh: Mesh) -> Tensor:
    """(rows,) int32: the global keyframe id of each of this rank's rows."""
    return (torch.arange(rows, dtype=torch.int32, device=mesh.device)
            * mesh.axis_size + mesh.axis_index)


def _owner_row(best_id: Tensor, rows: int, mesh: Mesh):
    owner = (best_id % mesh.axis_size) == mesh.axis_index
    row = torch.clamp(best_id // mesh.axis_size, 0, rows - 1).to(torch.int64)
    return owner, row


def query_sharded(codes_local: Tensor, count: Tensor, frame_codes: Tensor,
                  threshold: float, mesh: Mesh):
    """The fern query over the sharded store. `codes_local` holds this
    rank's rows, `count` the replicated global keyframe count. Returns
    (best_id (global), best_dissim, is_new), equal to `ferns.query` on the
    whole store."""
    n = frame_codes.shape[0]
    rows = codes_local.shape[0]
    same = torch.sum((codes_local == frame_codes[None, :]).to(torch.int32),
                     dim=1)
    dissim = (n - same).to(torch.float32) / float(n)
    gid = global_ids(rows, mesh)
    dissim = torch.where(gid < count, dissim, torch.ones_like(dissim))
    # the dissimilarity is k / n exactly: n + 1 levels above the id
    dq = torch.round(dissim * n).to(torch.int32)
    best_key = pmin(torch.amin(dq * (1 << 20) + gid).reshape(1), mesh)[0]
    best_id = best_key & ((1 << 20) - 1)
    best = (best_key >> 20).to(torch.float32) / float(n)
    return best_id, best, best > threshold


def add_keyframe_sharded(store_local: KeyframeStore, count: Tensor,
                         frame_codes: Tensor, R: Tensor, t: Tensor,
                         stamp: Tensor, kp_xy: Tensor, kp_p3d: Tensor,
                         kp_desc: Tensor, kp_valid: Tensor, sf_pos: Tensor,
                         sf_normal: Tensor, sf_color: Tensor,
                         sf_valid: Tensor, mesh: Mesh,
                         when: Tensor | None = None):
    """Append keyframe `count` on its owner rank (count mod D); the other
    ranks only count it. A masked no-op when the store is full or `when`
    (a () bool tensor) is False. Returns (store_local, new count)."""
    rows = store_local.db.codes.shape[0]
    ok = count < rows * mesh.axis_size
    if when is not None:
        ok = ok & when
    owner, row = _owner_row(count, rows, mesh)
    take = ok & owner
    stamp = torch.as_tensor(stamp, dtype=torch.int32, device=mesh.device)

    def put(dst, src):
        return masked_put(dst, src, take, row)

    new_count = count + ok.to(torch.int32)
    db = store_local.db
    return KeyframeStore(
        db=FernDB(codes=put(db.codes, frame_codes),
                  poses_R=put(db.poses_R, R), poses_t=put(db.poses_t, t),
                  stamps=put(db.stamps, stamp), count=new_count),
        kp_xy=put(store_local.kp_xy, kp_xy),
        kp_p3d=put(store_local.kp_p3d, kp_p3d),
        kp_desc=put(store_local.kp_desc, kp_desc),
        kp_valid=put(store_local.kp_valid, kp_valid),
        sf_pos=put(store_local.sf_pos, sf_pos),
        sf_normal=put(store_local.sf_normal, sf_normal),
        sf_color=put(store_local.sf_color, sf_color),
        sf_valid=put(store_local.sf_valid, sf_valid),
    ), new_count


def get_stamp_sharded(stamps_local: Tensor, best_id: Tensor,
                      mesh: Mesh) -> Tensor:
    """Keyframe `best_id`'s stamp on every rank (one int32 sum): the
    loop-closure gate reads it every frame."""
    owner, row = _owner_row(best_id, stamps_local.shape[0], mesh)
    v = stamps_local.index_select(0, row.reshape(1))
    return psum(torch.where(owner, v, torch.zeros_like(v)), mesh)[0]


class KeyframePayload(NamedTuple):
    """One keyframe's loop-closure payload, on every rank."""

    kp_xy: Tensor
    kp_p3d: Tensor
    kp_desc: Tensor
    kp_valid: Tensor
    sf_pos: Tensor
    sf_normal: Tensor
    sf_color: Tensor
    sf_valid: Tensor
    pose_R: Tensor
    pose_t: Tensor
    stamp: Tensor


def get_payload_sharded(store_local: KeyframeStore, best_id: Tensor,
                        mesh: Mesh) -> KeyframePayload:
    """Broadcast keyframe `best_id`'s payload from its owner rank: the
    owner contributes the rows, every other rank zeros, and a sum
    replicates them (one float32 and one int32 collective)."""
    rows = store_local.db.codes.shape[0]
    owner, row = _owner_row(best_id, rows, mesh)
    src = dict(kp_xy=store_local.kp_xy, kp_p3d=store_local.kp_p3d,
               kp_desc=store_local.kp_desc, kp_valid=store_local.kp_valid,
               sf_pos=store_local.sf_pos, sf_normal=store_local.sf_normal,
               sf_color=store_local.sf_color, sf_valid=store_local.sf_valid,
               pose_R=store_local.db.poses_R, pose_t=store_local.db.poses_t,
               stamp=store_local.db.stamps)
    mine = {}
    for k, a in src.items():
        v = a.index_select(0, row.reshape(1))[0]
        if v.dtype == torch.bool:
            v = v.to(torch.int32)
        mine[k] = torch.where(owner, v, torch.zeros_like(v))
    out = {}
    for dtype in (torch.float32, torch.int32):
        keys = [k for k, v in mine.items() if v.dtype == dtype]
        out.update(zip(keys, psum_packed([mine[k] for k in keys], mesh)))
    for k in ("kp_valid", "sf_valid"):
        out[k] = out[k] > 0
    return KeyframePayload(**out)

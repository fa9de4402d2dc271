"""Rigid 3D-3D RANSAC.

Part of the port of `supersurfel_fusion_tpu/ops/loop_closure.py`: the
weighted Kabsch fit and `ransac_rigid_3d`, which the MOD's depth-residual
cue uses to fit the camera's rigid motion from matched keypoints. The rest
of that module (fern keyframe store, global loop closure) comes with the
loop-closure slice.

The SVD is `torch.linalg.svd`. R = V S U^T does not change when a
singular pair changes sign, so nondegenerate hypotheses agree with the
JAX package; degenerate triples (repeated draws) may not, and score low.
"""

from __future__ import annotations

import functools

import torch

from supersurfel_fusion_tpu_torch.ops.flow import coverage_rank
from supersurfel_fusion_tpu_torch.ops.random_tables import rigid_draw
from supersurfel_fusion_tpu_torch.utils.geometry import orthonormalize

Tensor = torch.Tensor


def _det3(M: Tensor) -> Tensor:
    """Determinant of (..., 3, 3) matrices, by cofactors of the first row."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _kabsch(P: Tensor, Q: Tensor, w: Tensor):
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


@functools.lru_cache(maxsize=None)
def _draw_on(device: torch.device) -> Tensor:
    return torch.as_tensor(rigid_draw(), device=device).to(torch.int64)


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
    inlier count as tiebreak. Returns (R, t, valid, n_in)."""
    if n_hyp != 256 or seed != 7:
        raise ValueError("only the committed draw (n_hyp=256, seed=7) is "
                         "available")
    n_ok = torch.sum(ok.to(torch.int64))
    # valid-first ordering; draws restricted to the first n_ok entries
    order = torch.argsort((~ok).to(torch.int8), stable=True)
    idx = order[_draw_on(src.device) % torch.clamp(n_ok, min=1)]
    P = src[idx]                      # (n_hyp, 3, 3)
    Q = dst[idx]
    w3 = ok[idx].to(torch.float32)
    # degenerate triples (repeated draws / collinear) score low naturally
    R, t = _kabsch(P, Q, w3)
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
    Rf, tf = _kabsch(src[None], dst[None], best_inl[None].to(torch.float32))
    Rf, tf = orthonormalize(Rf[0]), tf[0]
    n_in = torch.sum(best_inl.to(torch.int32))
    valid = ((n_in > min_inliers)
             & (n_in.to(torch.float32)
                > min_ratio * torch.clamp(n_ok, min=1).to(torch.float32))
             & torch.all(torch.isfinite(Rf)) & torch.all(torch.isfinite(tf)))
    return Rf, tf, valid, n_in

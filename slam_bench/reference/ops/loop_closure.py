# Frozen copy of supersurfel_fusion_tpu_torch/ops/loop_closure.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test. Only the rigid RANSAC that
# MOD's depth-residual cue runs (`ops/motion.py`) is kept; the cells run
# with ferns and loop closure off, so the rest of the file is left out.
"""Rigid 3D-3D RANSAC (from the port's loop-closure module).

`ransac_rigid_3d` fits the camera's rigid motion from matched keypoints
for MOD's depth-residual cue. Everything is fixed-shape and reads nothing
on the host.

The SVD is `torch.linalg.svd`. R = V S U^T does not change when a
singular pair changes sign, so nondegenerate hypotheses agree with the
JAX package; degenerate triples (repeated draws) may not, and score low.
"""

from __future__ import annotations

import functools

import torch

from slam_bench.reference.ops.flow import coverage_rank
from slam_bench.reference.utils import prng
from slam_bench.reference.utils.geometry import orthonormalize

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

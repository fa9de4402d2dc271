# Frozen copy of supersurfel_fusion_tpu_torch/utils/geometry.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Batched 3D geometry primitives: rotations, SE(3), symmetric 3x3
eigendecomposition and small linear solves.

Port of `supersurfel_fusion_tpu/utils/geometry.py`: branchless, fully batched
tensor functions. All matrices are row-major `(..., 3, 3)`.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    """Safe L2 normalization along the last axis."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def outer3(v: Tensor) -> Tensor:
    """v v^T for (..., 3) vectors -> (..., 3, 3)."""
    return v[..., :, None] * v[..., None, :]


def mult_ABAt(A: Tensor, B: Tensor) -> Tensor:
    """A @ B @ A^T."""
    return torch.einsum("...ij,...jk,...lk->...il", A, B, A)


def skew(v: Tensor) -> Tensor:
    """Cross-product matrix [v]_x for (..., 3) vectors."""
    zero = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_to_mat(axis: Tensor, angle: Tensor) -> Tensor:
    """Rodrigues rotation from a *unit* axis and angle (broadcasting)."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)


def quat_to_mat(q: Tensor) -> Tensor:
    """Unit quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def mat_to_quat(R: Tensor) -> Tensor:
    """Rotation matrix -> unit quaternion (x, y, z, w), branchless: all four
    Shepperd candidates, the best-conditioned one selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def piv(q2):
        return torch.sqrt(torch.clamp(q2, min=1e-12)) * 2.0

    s = piv(qw2)
    cw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                      0.25 * s], dim=-1)
    s = piv(qx2)
    cx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s,
                      (m21 - m12) / s], dim=-1)
    s = piv(qy2)
    cy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s,
                      (m02 - m20) / s], dim=-1)
    s = piv(qz2)
    cz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s,
                      (m10 - m01) / s], dim=-1)

    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return normalize(q)


def orthonormalize(R: Tensor) -> Tensor:
    """Re-orthonormalize a near-rotation through its quaternion."""
    return quat_to_mat(mat_to_quat(R))


def _trace(P: Tensor) -> Tensor:
    return P.diagonal(dim1=-2, dim2=-1).sum(-1)


def _dominant_eigvec(P: Tensor, n_iters: int) -> Tensor:
    """Dominant eigenvector of a symmetric PSD 3x3 by trace-normalized
    repeated squaring; the column of largest norm of the limit projector."""
    Pi = P / torch.clamp(_trace(P)[..., None, None], min=1e-30)
    for _ in range(n_iters):
        Pi = Pi @ Pi
        Pi = Pi / torch.clamp(_trace(Pi)[..., None, None], min=1e-30)
    norms = torch.sum(Pi * Pi, dim=-2)                    # (..., 3)
    best = torch.argmax(norms, dim=-1)                    # (...)
    idx = best[..., None, None].expand(*best.shape, 3, 1)
    col = torch.gather(Pi, -1, idx)[..., 0]
    return normalize(col)


def eigh3x3(A: Tensor, n_iters: int = 10):
    """Eigendecomposition of symmetric 3x3 covariances. Returns
    `(eigvecs, eigvals)`: eigvecs ROWS ordered (major, minor, normal)."""
    tr = _trace(A)[..., None, None]
    tr = torch.where(torch.abs(tr) > 1e-30, tr, torch.full_like(tr, 1e-30))
    An = A / tr
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)

    e0 = _dominant_eigvec(An, n_iters)
    e2 = _dominant_eigvec(eye - An, n_iters)
    e1 = normalize(torch.linalg.cross(e2, e0, dim=-1))
    e0 = normalize(torch.linalg.cross(e1, e2, dim=-1))

    vecs = torch.stack([e0, e1, e2], dim=-2)
    vals = torch.einsum("...ri,...ij,...rj->...r", vecs, A, vecs)
    return vecs, vals


def solve3x3(A: Tensor, b: Tensor, eps: float = 1e-20):
    """Batched 3x3 solve via adjugate; returns (x, ok_mask)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02

    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10

    adjT = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    ok = torch.abs(det) > eps
    safe_det = torch.where(ok, det, torch.ones_like(det))
    x = torch.einsum("...ij,...j->...i", adjT, b) / safe_det[..., None]
    return torch.where(ok[..., None], x, torch.zeros_like(x)), ok


def inv3x3_sym(A: Tensor, eps: float = 1e-20):
    """Batched symmetric 3x3 inverse; returns (A_inv, ok_mask)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    det = a00 * c00 + a01 * c01 + a02 * c02
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c01, c11, c12], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    ok = torch.abs(det) > eps
    safe_det = torch.where(ok, det, torch.ones_like(det))
    inv = adj / safe_det[..., None, None]
    return torch.where(ok[..., None, None], inv, eye), ok

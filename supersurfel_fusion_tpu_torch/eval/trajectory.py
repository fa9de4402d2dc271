"""Trajectory evaluation: ATE (Horn alignment) and RPE, TUM method.

A numpy-only copy of `supersurfel_fusion_tpu/eval/trajectory.py` (the port
cannot import that package: its `__init__` imports JAX). Host-side float64
offline evaluation, used by the benchmark runner; not part of the compute
path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) -> 3x3 rotation, float64."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def mat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (qx, qy, qz, qw)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s, 0.25 * s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def associate_timestamps(ts_a: Sequence[float], ts_b: Sequence[float],
                         max_difference: float = 0.02) -> List[Tuple[float, float]]:
    potential = sorted(
        (abs(a - b), a, b)
        for a in ts_a
        for b in ts_b
        if abs(a - b) < max_difference
    )
    used_a, used_b, matches = set(), set(), []
    for _, a, b in potential:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            matches.append((a, b))
    matches.sort()
    return matches


def horn_align(model: np.ndarray, data: np.ndarray):
    """Least-squares rigid alignment model -> data (Horn, closed form SVD).

    model, data: (3, N). Returns (R, t) with data ≈ R @ model + t.
    """
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    W = (data - mu_d) @ (model - mu_m).T
    U, _, Vt = np.linalg.svd(W)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    t = mu_d - R @ mu_m
    return R, t


@dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    max: float
    n_pairs: int


def ate(estimated: Dict[float, np.ndarray], groundtruth: Dict[float, np.ndarray],
        max_difference: float = 0.02) -> ATEResult:
    """Absolute trajectory error after Horn alignment (TUM evaluate_ate)."""
    matches = associate_timestamps(list(estimated), list(groundtruth), max_difference)
    if len(matches) < 2:
        raise ValueError(f"only {len(matches)} timestamp matches")
    est = np.stack([estimated[a][:3] for a, _ in matches], axis=1)
    gt = np.stack([groundtruth[b][:3] for _, b in matches], axis=1)
    R, t = horn_align(est, gt)
    err = np.linalg.norm(R @ est + t - gt, axis=0)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(np.mean(err)),
        median=float(np.median(err)),
        max=float(np.max(err)),
        n_pairs=len(matches),
    )


@dataclass
class RPEResult:
    trans_rmse: float
    rot_rmse_deg: float
    n_pairs: int


def _pose44(p: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_mat_np(p[3:7])
    T[:3, 3] = p[:3]
    return T


def rpe(estimated: Dict[float, np.ndarray], groundtruth: Dict[float, np.ndarray],
        delta: int = 1, max_difference: float = 0.02) -> RPEResult:
    """Relative pose error over a fixed frame delta (TUM evaluate_rpe)."""
    matches = associate_timestamps(list(estimated), list(groundtruth), max_difference)
    if len(matches) < delta + 1:
        raise ValueError("not enough matches for RPE")
    Te = [_pose44(estimated[a]) for a, _ in matches]
    Tg = [_pose44(groundtruth[b]) for _, b in matches]
    terr, rerr = [], []
    for i in range(len(matches) - delta):
        de = np.linalg.inv(Te[i]) @ Te[i + delta]
        dg = np.linalg.inv(Tg[i]) @ Tg[i + delta]
        E = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(E[:3, 3]))
        c = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerr.append(np.degrees(np.arccos(c)))
    return RPEResult(
        trans_rmse=float(np.sqrt(np.mean(np.square(terr)))),
        rot_rmse_deg=float(np.sqrt(np.mean(np.square(rerr)))),
        n_pairs=len(terr),
    )

"""A small ray-cast RGB-D scene under a known camera trajectory (numpy only).

A test and smoke fixture, not a user feature. Three textured planes (a floor,
a back wall and a left wall) carry a blocky procedural texture fixed in world
coordinates, so that features, superpixels, VO and ICP see the same geometry
from frame to frame. Frames are rendered as uint8 RGB and uint16 depth
(TUM encoding, 5000 counts per metre) for a pinhole camera.
"""

from __future__ import annotations

import numpy as np

from supersurfel_fusion_tpu_torch.config import CameraIntrinsics

# planes n . p = c in world coordinates (camera 0 at the origin looking +z,
# y down), each with two in-plane axes for its texture and a base colour
_PLANES = (
    # floor
    (np.array([0.0, 1.0, 0.0]), 0.9, np.array([1.0, 0.0, 0.0]),
     np.array([0.0, 0.0, 1.0]), np.array([200.0, 170.0, 120.0])),
    # back wall
    (np.array([0.0, 0.0, 1.0]), 3.2, np.array([1.0, 0.0, 0.0]),
     np.array([0.0, 1.0, 0.0]), np.array([120.0, 180.0, 220.0])),
    # left wall
    (np.array([1.0, 0.0, 0.0]), -1.6, np.array([0.0, 0.0, 1.0]),
     np.array([0.0, 1.0, 0.0]), np.array([210.0, 120.0, 140.0])),
)


def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic value in [0, 1) per integer lattice cell."""
    h = (ix.astype(np.int64) * 73856093) ^ (iy.astype(np.int64) * 19349663) \
        ^ (seed * 83492791)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).astype(np.float64) / 65536.0


def _texture(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    """Blocky two-scale value noise in [0, 1] over in-plane coords (m)."""
    coarse = _hash01(np.floor(a / 0.12), np.floor(b / 0.12), seed)
    fine = _hash01(np.floor(a / 0.04), np.floor(b / 0.04), seed + 7)
    return 0.6 * coarse + 0.4 * fine


def axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def trajectory(n: int) -> list:
    """n camera->world poses (R, t) in float64, starting at the identity:
    a slow hand-held sway of a few centimetres and a degree or two, about
    the per-frame motion of TUM fr1/xyz."""
    poses = []
    for k in range(n):
        s = k / 30.0
        t = np.array([0.08 * np.sin(2.1 * s), 0.04 * np.sin(1.3 * s),
                      0.06 * (1.0 - np.cos(1.7 * s))])
        R = axis_angle([0.3, 1.0, 0.1], 0.03 * np.sin(1.9 * s))
        poses.append((R, t))
    return poses


def render(cam: CameraIntrinsics, R: np.ndarray, t: np.ndarray):
    """Ray-cast the scene from camera->world pose (R, t).
    Returns (rgb (H, W, 3) uint8, depth (H, W) uint16, 5000 per metre)."""
    H, W = cam.height, cam.width
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                     np.ones_like(u)], -1)          # camera frame, z = 1
    d_w = rays @ np.asarray(R).T
    o = np.asarray(t, np.float64)
    depth = np.full((H, W), np.inf)
    rgb = np.zeros((H, W, 3))
    for i, (n, c, ea, eb, base) in enumerate(_PLANES):
        denom = d_w @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (c - o @ n) / denom
        s = np.where((np.abs(denom) > 1e-9) & (s > 0), s, np.inf)
        take = s < depth
        p = o + d_w * np.where(np.isfinite(s), s, 0.0)[..., None]
        tex = _texture(p @ ea, p @ eb, seed=i)
        col = base * (0.35 + 0.65 * tex[..., None])
        depth = np.where(take, s, depth)
        rgb = np.where(take[..., None], col, rgb)
    ok = np.isfinite(depth) & (depth < 6.0)
    depth_u16 = np.where(ok, np.round(depth * 5000.0), 0).astype(np.uint16)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8), depth_u16


def frames(cam: CameraIntrinsics, n: int):
    """The first n frames: a list of (rgb, depth, (R, t)) tuples."""
    return [(*render(cam, R, t), (R, t)) for R, t in trajectory(n)]

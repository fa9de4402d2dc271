# The scene is a torch copy of supersurfel_fusion_tpu_torch/synthetic.py at
# commit 37bce59 (the room of three textured planes, the box mover, the
# hand-held sway and the TUM encoding), rendered in float64 on the device
# in batches. The sway's numbers, the box's motion and the seeds come from
# the traffic file; the generator itself is one for every mix.
"""The benchmark's traffic: a seeded RGB-D stream of the synthetic room.

A traffic mix (`traffic/<mix>.json`) gives the camera's sway (amplitudes
and frequencies of `synthetic.trajectory`), the number K of distinct poses,
and optionally a box that slides on a triangle wave in front of the camera.
`render_stream` renders the K frames on the device and returns them as host
arrays in TUM encoding: uint8 RGB and uint16 depth at 5000 counts per metre.
`frame_index` plays them forward and backward, so the motion is continuous
for as long as a run asks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# planes n . p = c in world coordinates (camera 0 at the origin looking +z,
# y down), each with two in-plane axes for its texture and a base colour
PLANES = (
    # floor
    ((0.0, 1.0, 0.0), 0.9, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
     (200.0, 170.0, 120.0)),
    # back wall
    ((0.0, 0.0, 1.0), 3.2, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
     (120.0, 180.0, 220.0)),
    # left wall
    ((1.0, 0.0, 0.0), -1.6, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0),
     (210.0, 120.0, 140.0)),
)
BOX_BASE = (90.0, 200.0, 110.0)
DEPTH_COUNTS_PER_M = 5000.0
MAX_DEPTH_M = 6.0


def _hash01(ix: torch.Tensor, iy: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic value in [0, 1) per integer lattice cell (int64 wraps
    as numpy's does)."""
    h = (ix * 73856093) ^ (iy * 19349663) ^ (seed * 83492791)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float64) / 65536.0


def _texture(a: torch.Tensor, b: torch.Tensor, seed: int) -> torch.Tensor:
    """Blocky two-scale value noise in [0, 1] over in-plane coords (m)."""
    coarse = _hash01(torch.floor(a / 0.12).to(torch.int64),
                     torch.floor(b / 0.12).to(torch.int64), seed)
    fine = _hash01(torch.floor(a / 0.04).to(torch.int64),
                   torch.floor(b / 0.04).to(torch.int64), seed + 7)
    return 0.6 * coarse + 0.4 * fine


def axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def sway_poses(mix: dict, n: int, phase: int = 0) -> list:
    """n camera->world poses (R, t) in float64 along the mix's sway,
    starting `phase` frames into it (`synthetic.trajectory` for the
    default numbers and phase 0)."""
    sw = mix["sway"]
    fps = float(sw["fps"])
    ta, tf = sw["t_amp"], sw["t_freq"]
    poses = []
    for k in range(n):
        s = (k + phase) / fps
        t = np.array([ta[0] * np.sin(tf[0] * s), ta[1] * np.sin(tf[1] * s),
                      ta[2] * (1.0 - np.cos(tf[2] * s))])
        R = axis_angle(sw["rot_axis"],
                       sw["rot_amp"] * np.sin(sw["rot_freq"] * s))
        poses.append((R, t))
    return poses


def box_bounds(box: dict, k: int):
    """World-frame (lo, hi) corners of the mover at rendered frame k: its
    centre slides along x by `step` metres per frame on a triangle wave of
    +-`amplitude` about `x_centre`, standing on the floor at depth `z`."""
    size = np.asarray(box["size"], np.float64)
    amp, step = float(box["amplitude"]), float(box["step"])
    period = 4.0 * amp / step                 # frames
    u = (k / period) % 1.0
    tri = 4.0 * u if u < 0.25 else (2.0 - 4.0 * u if u < 0.75
                                    else 4.0 * u - 4.0)
    centre = np.array([box["x_centre"] + amp * tri,
                       box["floor_y"] - size[1] / 2, box["z"]])
    return centre - size / 2, centre + size / 2


def _cast(cam, R: torch.Tensor, t: torch.Tensor, lo, hi, texture_seed: int):
    """Ray-cast B poses at once. R (B, 3, 3), t (B, 3) float64 on the
    device; lo, hi (B, 3) box corners or None. Returns depth (B, H, W)
    float64 (inf where nothing is hit) and rgb (B, H, W, 3) float64."""
    dev = R.device
    f64 = dict(dtype=torch.float64, device=dev)
    H, W = cam["height"], cam["width"]
    v, u = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                          indexing="ij")
    rays = torch.stack([(u - cam["cx"]) / cam["fx"],
                        (v - cam["cy"]) / cam["fy"], torch.ones_like(u)], -1)
    # d_w = rays @ R^T, written out so that it rounds as the sum in order
    d_w = (rays[None, :, :, None, 0] * R[:, None, None, :, 0]
           + rays[None, :, :, None, 1] * R[:, None, None, :, 1]
           + rays[None, :, :, None, 2] * R[:, None, None, :, 2])
    o = t[:, None, None, :]
    B = R.shape[0]
    depth = torch.full((B, H, W), math.inf, **f64)
    rgb = torch.zeros((B, H, W, 3), **f64)

    def dot(x, e):
        return x[..., 0] * e[0] + x[..., 1] * e[1] + x[..., 2] * e[2]

    for i, (n, c, ea, eb, base) in enumerate(PLANES):
        denom = dot(d_w, n)
        s = (c - dot(o, n)) / denom
        s = torch.where((denom.abs() > 1e-9) & (s > 0), s,
                        torch.full_like(s, math.inf))
        take = s < depth
        p = o + d_w * torch.where(torch.isfinite(s), s,
                                  torch.zeros_like(s))[..., None]
        tex = _texture(dot(p, ea), dot(p, eb), texture_seed + i)
        col = torch.tensor(base, **f64) * (0.35 + 0.65 * tex[..., None])
        depth = torch.where(take, s, depth)
        rgb = torch.where(take[..., None], col, rgb)
    if lo is not None:
        lo_, hi_ = lo[:, None, None, :], hi[:, None, None, :]
        t1 = (lo_ - o) / d_w
        t2 = (hi_ - o) / d_w
        ninf = torch.full_like(t1, -math.inf)
        near = torch.where(torch.isnan(t1), ninf, torch.minimum(t1, t2))
        far = torch.where(torch.isnan(t1), -ninf, torch.maximum(t1, t2))
        s_in, face = near.max(-1)
        s_out = far.min(-1).values
        # numpy's argmax takes the first of equal values, as torch's max does
        hit = (s_in <= s_out) & (s_in > 0) & (s_in < depth)
        p = o + d_w * torch.where(hit, s_in,
                                  torch.zeros_like(s_in))[..., None] - lo_
        a = torch.where(face == 0, p[..., 2], p[..., 0])
        b = torch.where(face == 1, p[..., 2], p[..., 1])
        tex = _texture(a, b, texture_seed + 3)
        col = torch.tensor(BOX_BASE, **f64) * (0.35 + 0.65 * tex[..., None])
        depth = torch.where(hit, s_in, depth)
        rgb = torch.where(hit[..., None], col, rgb)
    return depth, rgb


def _encode(depth: torch.Tensor, rgb: torch.Tensor):
    ok = torch.isfinite(depth) & (depth < MAX_DEPTH_M)
    d = torch.where(ok, torch.round(depth * DEPTH_COUNTS_PER_M),
                    torch.zeros_like(depth)).to(torch.int32)
    c = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
    return c, d


def render_stream(cam: dict, mix: dict, seed: int, device,
                  batch: int = 16):
    """The mix's K frames from `seed`, rendered on `device`. Returns (rgb
    (K, H, W, 3) uint8, depth (K, H, W) uint16) host arrays and the K
    camera->world poses. The seed picks the textures and the sway's
    phase; every seed renders the same number of frames of the same
    size."""
    K = int(mix["poses"])
    rs = np.random.default_rng(int(seed))
    phase = int(rs.integers(0, int(mix["sway"]["phase_frames"])))
    texture_seed = int(rs.integers(0, 1 << 20))
    poses = sway_poses(mix, K, phase)
    box = mix.get("box")
    H, W = cam["height"], cam["width"]
    rgb = np.empty((K, H, W, 3), np.uint8)
    depth = np.empty((K, H, W), np.uint16)
    for k0 in range(0, K, batch):
        ks = range(k0, min(K, k0 + batch))
        R = torch.tensor(np.stack([poses[k][0] for k in ks]),
                         dtype=torch.float64, device=device)
        t = torch.tensor(np.stack([poses[k][1] for k in ks]),
                         dtype=torch.float64, device=device)
        lo = hi = None
        if box:
            b = [box_bounds(box, k) for k in ks]
            lo = torch.tensor(np.stack([x[0] for x in b]),
                              dtype=torch.float64, device=device)
            hi = torch.tensor(np.stack([x[1] for x in b]),
                              dtype=torch.float64, device=device)
        c, d = _encode(*_cast(cam, R, t, lo, hi, texture_seed))
        rgb[k0:k0 + len(ks)] = c.cpu().numpy()
        depth[k0:k0 + len(ks)] = d.cpu().numpy().astype(np.uint16)
    return rgb, depth, poses


def frame_index(i: int, K: int) -> int:
    """The rendered frame played as the stream's i-th frame: 0..K-1, then
    back K-2..1, and so on."""
    period = 2 * (K - 1)
    j = i % period
    return j if j < K else period - j

"""A small ray-cast RGB-D scene under a known camera trajectory (numpy only).

A test and smoke fixture, not a user feature. Three textured planes (a floor,
a back wall and a left wall) carry a blocky procedural texture fixed in world
coordinates, so that features, superpixels, VO and ICP see the same geometry
from frame to frame. Frames are rendered as uint8 RGB and uint16 depth
(TUM encoding, 5000 counts per metre) for a pinhole camera.

`dynamic_frames` adds a mover for the moving-object detection: a textured
box (0.5 m wide, 1.2 m tall, 0.3 m deep) standing on the floor about 2.2 m
from the camera and sliding sideways by 2 cm per frame (0.6 m/s at 30 Hz).
Its texture is fixed to the box, so its keypoints match across frames with
a motion other than the camera's: at the fr3 camera that is about 5 px of
residual flow, and the pixels it newly covers have about 1 m of positive
depth residual against the back wall. `mover_scores` grades a MOD result
against the rendered mover mask.
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


def _cast_planes(cam: CameraIntrinsics, R: np.ndarray, t: np.ndarray):
    """Ray-cast the three planes. Returns (depth (H, W) float64, inf where
    no plane is hit, rgb (H, W, 3) float64, rays d_w, origin o), with the
    rays' camera z equal to 1, so a ray parameter is a depth."""
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
    return depth, rgb, d_w, o


def _encode(depth: np.ndarray, rgb: np.ndarray):
    ok = np.isfinite(depth) & (depth < 6.0)
    depth_u16 = np.where(ok, np.round(depth * 5000.0), 0).astype(np.uint16)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8), depth_u16


def render(cam: CameraIntrinsics, R: np.ndarray, t: np.ndarray):
    """Ray-cast the scene from camera->world pose (R, t).
    Returns (rgb (H, W, 3) uint8, depth (H, W) uint16, 5000 per metre)."""
    depth, rgb, _, _ = _cast_planes(cam, R, t)
    return _encode(depth, rgb)


# the mover: an axis-aligned box on the floor (y = 0.9 m, y down), its
# centre sliding along +x from BOX_X0 by BOX_STEP metres per frame
BOX_SIZE = np.array([0.5, 1.2, 0.3])
BOX_X0 = -0.35
BOX_Z = 2.2
BOX_STEP = 0.02
# frames out (and back) of the revisit clip
REVISIT_OUT = 16
_BOX_BASE = np.array([90.0, 200.0, 110.0])


def box_bounds(k: int, step: float = BOX_STEP):
    """World-frame (lo, hi) corners of the mover at frame k."""
    centre = np.array([BOX_X0 + step * k, 0.9 - BOX_SIZE[1] / 2, BOX_Z])
    return centre - BOX_SIZE / 2, centre + BOX_SIZE / 2


def render_dynamic(cam: CameraIntrinsics, R: np.ndarray, t: np.ndarray,
                   lo: np.ndarray, hi: np.ndarray):
    """The scene plus the box [lo, hi] (world frame). Returns (rgb uint8,
    depth uint16, mover (H, W) bool: the pixels where the box is seen)."""
    depth, rgb, d_w, o = _cast_planes(cam, R, t)
    # slab test of each ray against the box
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d_w
        t2 = (hi - o) / d_w
    near = np.where(np.isnan(t1), -np.inf, np.minimum(t1, t2))
    far = np.where(np.isnan(t1), np.inf, np.maximum(t1, t2))
    s_in = near.max(-1)
    s_out = far.min(-1)
    face = near.argmax(-1)                  # axis of the entry face
    hit = (s_in <= s_out) & (s_in > 0) & (s_in < depth)
    p = o + d_w * np.where(hit, s_in, 0.0)[..., None] - lo
    # in-face texture coordinates: the two axes other than the face's
    a = np.choose(face, [p[..., 2], p[..., 0], p[..., 0]])
    b = np.choose(face, [p[..., 1], p[..., 2], p[..., 1]])
    tex = _texture(a, b, seed=3)
    col = _BOX_BASE * (0.35 + 0.65 * tex[..., None])
    depth = np.where(hit, s_in, depth)
    rgb = np.where(hit[..., None], col, rgb)
    return (*_encode(depth, rgb), hit)


def frames(cam: CameraIntrinsics, n: int):
    """The first n frames: a list of (rgb, depth, (R, t)) tuples."""
    return [(*render(cam, R, t), (R, t)) for R, t in trajectory(n)]


def dynamic_frames(cam: CameraIntrinsics, n: int, step: float = BOX_STEP):
    """The first n frames of the clip with the moving box, along the same
    camera trajectory: a list of (rgb, depth, (R, t), mover) tuples. A
    narrow test camera can ask for a larger `step` (metres per frame) to
    keep the mover's motion in pixels near the fr3 camera's 5 px."""
    out = []
    for k, (R, t) in enumerate(trajectory(n)):
        rgb, depth, mover = render_dynamic(cam, R, t, *box_bounds(k, step))
        out.append((rgb, depth, (R, t), mover))
    return out


def revisit_trajectory(n_out: int = REVISIT_OUT) -> list:
    """2 n_out + 1 camera->world poses (R, t) in float64: from the identity
    the camera tilts 23 degrees down to the floor, turns 17 degrees right
    and slides 0.2 m right, on a cosine ramp over n_out frames (at most
    2.8 degrees and 2 cm per frame), then retraces the same poses back to
    the start: frame 2 n_out - k repeats frame k. The floor's colour and
    depth differ from the back wall's, so the far poses give the fern
    detector new keyframes, and the way back revisits the first one."""
    out = []
    for k in range(n_out + 1):
        s = 0.5 * (1.0 - np.cos(np.pi * k / n_out))
        R = axis_angle([0.0, 1.0, 0.0], 0.3 * s) \
            @ axis_angle([1.0, 0.0, 0.0], -0.4 * s)
        out.append((R, np.array([0.2 * s, 0.0, 0.0])))
    return out + out[-2::-1]


def revisit_frames(cam: CameraIntrinsics, n_out: int = REVISIT_OUT):
    """The revisit clip for loop closure: the static scene along
    `revisit_trajectory(n_out)`, a list of (rgb, depth, (R, t)) tuples."""
    return [(*render(cam, R, t), (R, t)) for R, t in revisit_trajectory(n_out)]


def write_tum_sequence(root, clip, fps: float = 30.0, t0: float = 1000.0):
    """Write frames of a clip ((rgb, depth, (R, t)), ...) as a TUM RGB-D
    sequence directory: rgb/ and depth/ PNGs (8-bit RGB; 16-bit depth, 5000
    counts per metre) through PIL, rgb.txt, depth.txt, groundtruth.txt and
    associations_with_gt.txt (what `io/tum.py` reads first). Returns the
    frames' timestamps."""
    import os

    from PIL import Image

    from supersurfel_fusion_tpu_torch.eval.trajectory import mat_to_quat_np

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    stamps, rgb_l, dep_l, gt_l, assoc = [], [], [], [], []
    for k, (rgb, depth, (R, t)) in enumerate(clip):
        ts = t0 + k / fps
        rgb_f, dep_f = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        Image.fromarray(rgb).save(os.path.join(root, rgb_f))
        Image.fromarray(depth).save(os.path.join(root, dep_f))
        pose = " ".join(f"{v:.9f}" for v in np.concatenate(
            [t, mat_to_quat_np(np.asarray(R))]))
        stamps.append(float(f"{ts:.6f}"))
        rgb_l.append(f"{ts:.6f} {rgb_f}")
        dep_l.append(f"{ts:.6f} {dep_f}")
        gt_l.append(f"{ts:.6f} {pose}")
        assoc.append(f"{ts:.6f} {rgb_f} {ts:.6f} {dep_f} {ts:.6f} {pose}")
    for name, lines in (("rgb.txt", rgb_l), ("depth.txt", dep_l),
                        ("groundtruth.txt", gt_l),
                        ("associations_with_gt.txt", assoc)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return stamps


def mover_scores(labels: np.ndarray, static_sp: np.ndarray,
                 mover: np.ndarray) -> dict:
    """Grade one frame's MOD result against the rendered mover mask.

    labels: (H, W) superpixel index image; static_sp: (N,) bool; mover:
    (H, W) bool. A superpixel is on the mover when more than half of its
    pixels are, and static when none is. Returns the counts of mover
    superpixels, of those marked dynamic, of static superpixels and of
    those marked dynamic."""
    n = static_sp.shape[0]
    lab = labels.reshape(-1).astype(np.int64)
    size = np.bincount(lab, minlength=n)
    on = np.bincount(lab, weights=mover.reshape(-1), minlength=n)
    on_mover = on > 0.5 * np.maximum(size, 1)
    static = (on == 0) & (size > 0)
    dyn = ~static_sp.astype(bool)
    return {"mover_sp": int(on_mover.sum()),
            "mover_dynamic": int((on_mover & dyn).sum()),
            "static_sp": int(static.sum()),
            "static_dynamic": int((static & dyn).sum())}


def translation_errors(traj_rows, poses=None) -> np.ndarray:
    """Per-frame distance (m) between the positions of a run's TUM rows
    (tx ty tz qx qy qz qw), one per frame from frame 0, and the clip's
    known trajectory: `poses` ((R, t) pairs), by default `trajectory`'s."""
    traj = np.asarray(traj_rows, dtype=np.float64)
    if poses is None:
        poses = trajectory(len(traj))
    gt = np.array([t for _, t in poses[:len(traj)]])
    return np.linalg.norm(traj[:, :3] - gt, axis=1)


def mover_summary(scores: list) -> dict:
    """Pool per-frame `mover_scores`: mover recall (mover superpixels
    marked dynamic) and the false-dynamic share of static superpixels."""
    tot = {k: sum(s[k] for s in scores) for k in scores[0]}
    return {"mover_recall": tot["mover_dynamic"] / max(tot["mover_sp"], 1),
            "false_dynamic": tot["static_dynamic"] / max(tot["static_sp"], 1),
            **tot}

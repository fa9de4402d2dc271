"""Observability renders: the image surfaces the reference node publishes.

Host-side numpy equivalents of the reference's visualization topics
(`node/supersurfel_fusion_node.cpp:304-716`):

* `superpixel_image`   — boundary overlay (the `/superpixels` topic,
  TPS_RGBD::computePreviewImage, `core/src/TPS_RGBD.cu:527-541`)
* `slanted_plane_image`— colormapped slanted-plane depth (`/slanted_plane`)
* `mod_mask_image`     — white=static / black=moving person mask
  (`computeStaticDynamicImage`, `motion_detection_kernels.cu:109-133`)
* `model_image`        — confident model surfels splatted into the current
  view (the marker-array render, reduced to an image)

A numpy-only copy of `supersurfel_fusion_tpu/viz/render.py`. All functions
take numpy arrays (download FrameOutput fields with `.cpu().numpy()`) and
return uint8 images ready for PIL.
"""

from __future__ import annotations

import numpy as np


def superpixel_image(rgb: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """RGB with red superpixel boundaries."""
    out = np.asarray(rgb, dtype=np.uint8).copy()
    b = np.zeros(labels.shape, dtype=bool)
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    out[b] = (255, 40, 40)
    return out


def slanted_plane_image(plane_depth: np.ndarray, d_max: float = 5.0) -> np.ndarray:
    """Colormapped (turbo-ish gray->red) slanted-plane depth."""
    d = np.nan_to_num(np.asarray(plane_depth), nan=0.0, posinf=0.0)
    t = np.clip(d / d_max, 0.0, 1.0)
    invalid = d <= 0
    r = (255 * t).astype(np.uint8)
    g = (255 * (1.0 - np.abs(t - 0.5) * 2)).astype(np.uint8)
    bch = (255 * (1.0 - t)).astype(np.uint8)
    img = np.stack([r, g, bch], axis=-1)
    img[invalid] = 0
    return img


def mod_mask_image(labels: np.ndarray, static_sp: np.ndarray) -> np.ndarray:
    """White = static, black = moving (computeStaticDynamicImage layout)."""
    stat = np.asarray(static_sp, dtype=bool)[np.asarray(labels)]
    return (stat * 255).astype(np.uint8)


def model_image(positions: np.ndarray, colors: np.ndarray, dims: np.ndarray,
                confidences: np.ndarray, nb: int, R: np.ndarray,
                t: np.ndarray, fx: float, fy: float, cx: float, cy: float,
                width: int, height: int, conf_thresh: float = 0.0) -> np.ndarray:
    """Splat confident surfels into the current camera view (z-buffered
    discs with radius from the major ellipse axis)."""
    img = np.zeros((height, width, 3), np.uint8)
    zbuf = np.full((height, width), np.inf, np.float32)
    n = int(nb)
    conf = confidences[:n]
    keep = conf > conf_thresh
    p = positions[:n][keep]
    c = np.clip(colors[:n][keep], 0, 255).astype(np.uint8)
    r_world = np.sqrt(np.maximum(dims[:n][keep, 0], 1e-12))

    Rv = R.T
    tv = -Rv @ t
    pc = p @ Rv.T + tv
    z = pc[:, 2]
    ok = z > 0.05
    pc, c, r_world, z = pc[ok], c[ok], r_world[ok], z[ok]
    u = (pc[:, 0] * fx / z + cx).astype(np.int32)
    v = (pc[:, 1] * fy / z + cy).astype(np.int32)
    r_px = np.clip((r_world * fx / z).astype(np.int32), 1, 12)

    order = np.argsort(-z)  # far to near; near overwrites
    for i in order:
        ui, vi, ri = u[i], v[i], r_px[i]
        if ui < -12 or ui >= width + 12 or vi < -12 or vi >= height + 12:
            continue
        y0, y1 = max(vi - ri, 0), min(vi + ri + 1, height)
        x0, x1 = max(ui - ri, 0), min(ui + ri + 1, width)
        if y0 >= y1 or x0 >= x1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        disc = (yy - vi) ** 2 + (xx - ui) ** 2 <= ri * ri
        closer = disc & (z[i] < zbuf[y0:y1, x0:x1])
        img[y0:y1, x0:x1][closer] = c[i]
        zbuf[y0:y1, x0:x1][closer] = z[i]
    return img


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)

# Copy of supersurfel_fusion_tpu_torch/ops/ferns.py at commit 193edc4, with its
# imports renamed: part of the loop-closure cell's plain reference, which
# imports nothing of the program under test.
"""Randomized-fern place recognition (loop-closure detection).

Port of `supersurfel_fusion_tpu/ops/ferns.py`: 500 random ferns, each a
(pixel, r, g, b, depth) threshold tuple over a downsampled RGB-D frame,
produce a 4-bit code; a frame's dissimilarity to a keyframe is the share of
differing codes. The keyframe codes are a dense (MAX_KF, n_ferns) uint8
matrix, so scoring is one compare and reduce on the device.

Every update is a masked device update: nothing here reads a count or a
flag on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from slam_bench.reference.config import FernsConfig
from slam_bench.reference.device import resolve_device
from slam_bench.reference.ops.features import resize_bilinear

Tensor = torch.Tensor


def fern_table_np(cfg: FernsConfig, width: int, height: int,
                  max_depth: float = 5.0, seed: int = 1234):
    """Static fern parameters at the downsampled resolution, drawn from
    numpy's generator as the JAX package draws them: (pos (n, 2) int32
    [x, y], rgb thresholds (n, 3) f32, depth thresholds (n,) f32)."""
    rng = np.random.default_rng(seed)
    w = width >> cfg.pyramid_level
    h = height >> cfg.pyramid_level
    pos = np.stack(
        [rng.integers(0, w, cfg.nb_ferns), rng.integers(0, h, cfg.nb_ferns)],
        axis=-1,
    ).astype(np.int32)
    rgb = rng.integers(0, 256, (cfg.nb_ferns, 3)).astype(np.float32)
    depth = (rng.random(cfg.nb_ferns) * max_depth).astype(np.float32)
    return pos, rgb, depth


@functools.lru_cache(maxsize=None)
def _table_on(cfg: FernsConfig, width: int, height: int, max_depth: float,
              device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in fern_table_np(cfg, width, height, max_depth))


def make_fern_table(cfg: FernsConfig, width: int, height: int,
                    max_depth: float = 5.0,
                    device: str | torch.device = "cuda"):
    """`fern_table_np` as tensors on `device` (made once per device; the
    card unless `device` asks for the CPU, `device.resolve_device`)."""
    return _table_on(cfg, width, height, float(max_depth),
                     resolve_device(device))


class FernDB(NamedTuple):
    """Keyframe code store and pose graph (the fern side of `Ferns`)."""

    codes: Tensor       # (MAX_KF, n_ferns) uint8
    poses_R: Tensor     # (MAX_KF, 3, 3)
    poses_t: Tensor     # (MAX_KF, 3)
    stamps: Tensor      # (MAX_KF,) int32
    count: Tensor       # () int32

    @staticmethod
    def empty(max_kf: int, n_ferns: int,
              device: str | torch.device) -> "FernDB":
        f32 = dict(dtype=torch.float32, device=device)
        return FernDB(
            codes=torch.zeros((max_kf, n_ferns), dtype=torch.uint8,
                              device=device),
            poses_R=torch.eye(3, **f32).repeat(max_kf, 1, 1),
            poses_t=torch.zeros((max_kf, 3), **f32),
            stamps=torch.zeros((max_kf,), dtype=torch.int32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )


def compute_codes(rgb: Tensor, depth: Tensor, fern_pos: Tensor,
                  fern_rgb: Tensor, fern_depth: Tensor, level: int) -> Tensor:
    """Frame -> (n_ferns,) uint8 codes. rgb (H, W, 3) 0..255, depth (H, W).

    The RGB image shrinks by `jax.image.resize(..., "bilinear")`'s
    antialiased weights, channel by channel (rows, then columns), which
    gives JAX's values bit for bit; depth is sampled at every 2^level-th
    pixel."""
    H, W, _ = rgb.shape
    h, w = H >> level, W >> level
    s = 1 << level
    small_depth = depth[::s, ::s][:h, :w]
    px = fern_pos[:, 0].to(torch.int64)
    py = fern_pos[:, 1].to(torch.int64)
    c = torch.stack([resize_bilinear(rgb[..., ch], h, w)[py, px]
                     for ch in range(3)], -1)               # (n, 3) gather
    d = small_depth[py, px]
    return ((c[:, 0] > fern_rgb[:, 0]).to(torch.uint8)
            | ((c[:, 1] > fern_rgb[:, 1]).to(torch.uint8) << 1)
            | ((c[:, 2] > fern_rgb[:, 2]).to(torch.uint8) << 2)
            | ((d > fern_depth).to(torch.uint8) << 3))


def query(db: FernDB, codes: Tensor, threshold: float):
    """Score the frame against all keyframes.

    Returns (best_id, best_dissim, is_new): the first keyframe of least
    dissimilarity, that dissimilarity, and whether it exceeds `threshold`
    (an empty store gives 1.0, so the first frame is new)."""
    n = codes.shape[0]
    max_kf = db.codes.shape[0]
    same = torch.sum((db.codes == codes[None, :]).to(torch.int32), dim=1)
    dissim = (n - same).to(torch.float32) / float(n)
    kf_valid = torch.arange(max_kf, device=codes.device) < db.count
    dissim = torch.where(kf_valid, dissim, torch.ones_like(dissim))
    best_id = torch.argmin(dissim).to(torch.int32)   # first of the minima
    best = torch.amin(dissim)
    return best_id, best, best > threshold


def masked_put(dst: Tensor, row: Tensor, ok: Tensor, k: Tensor) -> Tensor:
    """`dst` with row k set to `row` where `ok`, else unchanged (out of
    place; k a () int64 tensor already clipped into range)."""
    old = dst.index_select(0, k.reshape(1))[0]
    new = torch.where(ok, row.to(dst.dtype), old)
    return dst.index_copy(0, k.reshape(1), new[None])


def store_slot(db: FernDB, when: Tensor | None = None):
    """(ok, k): whether the next keyframe is stored (the store has room,
    and `when` if given) and the clipped row it goes to."""
    cap = db.codes.shape[0]
    ok = db.count < cap
    if when is not None:
        ok = ok & when
    k = torch.clamp(db.count, max=cap - 1).to(torch.int64)
    return ok, k


def add_keyframe(db: FernDB, codes: Tensor, R: Tensor, t: Tensor,
                 stamp: Tensor, when: Tensor | None = None) -> FernDB:
    """Append a keyframe: a masked no-op when the store is full or `when`
    (a () bool tensor) is False."""
    ok, k = store_slot(db, when)
    stamp = torch.as_tensor(stamp, dtype=torch.int32, device=codes.device)
    return FernDB(
        codes=masked_put(db.codes, codes, ok, k),
        poses_R=masked_put(db.poses_R, R, ok, k),
        poses_t=masked_put(db.poses_t, t, ok, k),
        stamps=masked_put(db.stamps, stamp, ok, k),
        count=db.count + ok.to(torch.int32),
    )

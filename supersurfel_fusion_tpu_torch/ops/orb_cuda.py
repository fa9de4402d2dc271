"""ORB keypoint detection over all pyramid levels on one hand-written CUDA
kernel (`csrc/orb.cu`).

The kernel replaces no Pallas kernel (the JAX package's detector is plain
jnp): it does in one launch a frame what `ops/features.py`'s plain
functions `fast_scores`, `harris_response`, `_level_keys` and `_cell_picks`
do level by level, bit for bit: FAST at both thresholds, the FAST score,
Harris, the 3x3 NMS, the border mask, both keys and the per-cell pick. Its
caller is `features.detect_cells`, which runs the plain functions for CPU
tensors and this binding for CUDA tensors; there is no fallback from one to
the other.

The library is compiled with nvcc for sm_90a at first use into `_build/`,
keyed by the hash of the source and the flags (`tps_cuda.build_library`),
bound with ctypes, and launched on the current stream without a sync; the
outputs are allocated here with `torch.empty`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

from supersurfel_fusion_tpu_torch.ops import tps_cuda

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "orb.cu"
MAX_CELL = 32       # a block holds one detection cell and its halo
MAX_LEVELS = 16
# per-pixel maps, in plane order: corner_hi, corner_lo, score, harris,
# key_hi, key_lo
N_MAPS = 6

# Launches since the last reset (plain-version calls on CPU tensors do not
# count).
launch_counts = {"orb_detect": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def build_library():
    """(path, compiler log) of the kernel's library, built if missing."""
    return tps_cuda.build_library(SOURCE)


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.orb_detect_launch.argtypes = [i, p, p, p, i, i, i, f, f, i, p, p,
                                          p, p, p]
        lib.orb_detect_launch.restype = i
        _lib = lib
    return _lib


def cell_counts(shapes: Sequence[Tuple[int, int]], cell: int) -> List[int]:
    """Detection cells of each level: the level's padded cell grid."""
    return [-(-H // cell) * -(-W // cell) for H, W in shapes]


def detect(levels: Sequence[Tensor], cell: int, border: int, harris: bool,
           th_hi: float, th_lo: float, maps: bool = False):
    """One launch over all levels (contiguous f32 CUDA images on one
    device). Returns (picks, maps): picks per level (best_in_cell int64,
    best_val f32, rank f32), one entry per detection cell of the level,
    row-major; maps None unless `maps`, else per level an (N_MAPS, H, W)
    f32 view of one buffer."""
    if not 1 <= cell <= MAX_CELL:
        raise ValueError(f"detect_cell {cell}: the ORB kernel takes cells of "
                         f"1 to {MAX_CELL} px")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels: the ORB kernel takes 1 to "
                         f"{MAX_LEVELS}")
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"the ORB kernel takes CUDA tensors, got {dev}")
    for lvl, img in enumerate(levels):
        if img.device != dev or img.dtype != torch.float32 or img.dim() != 2 \
                or not img.is_contiguous():
            raise ValueError(
                f"level {lvl}: expected a contiguous 2-D float32 image on "
                f"{dev}, got {img.dtype} {tuple(img.shape)} on {img.device} "
                f"(contiguous={img.is_contiguous()})")
    shapes = [tuple(img.shape) for img in levels]
    counts = cell_counts(shapes, cell)
    n_cells = sum(counts)
    lib = _library()
    best_idx = torch.empty((n_cells,), dtype=torch.int64, device=dev)
    best_val = torch.empty((n_cells,), dtype=torch.float32, device=dev)
    rank = torch.empty((n_cells,), dtype=torch.float32, device=dev)
    sizes = [N_MAPS * H * W for H, W in shapes]
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=dev) \
        if maps else None
    n = len(levels)
    err = lib.orb_detect_launch(
        n, (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
        (ctypes.c_int * n)(*[H for H, _ in shapes]),
        (ctypes.c_int * n)(*[W for _, W in shapes]), cell, border,
        int(harris), th_hi, th_lo, n_cells, best_idx.data_ptr(),
        best_val.data_ptr(), rank.data_ptr(),
        buf.data_ptr() if maps else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_detect launch failed: cudaError {err}")
    launch_counts["orb_detect"] += 1
    picks = list(zip(best_idx.split(counts), best_val.split(counts),
                     rank.split(counts)))
    level_maps = [m.view(N_MAPS, H, W) for m, (H, W)
                  in zip(buf.split(sizes), shapes)] if maps else None
    return picks, level_maps

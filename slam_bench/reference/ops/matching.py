# Frozen copy of supersurfel_fusion_tpu_torch/ops/matching.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Binary descriptor matching + GMS (Grid-based Motion Statistics) filter.

Port of `supersurfel_fusion_tpu/ops/matching.py`. Hamming distances are XOR
plus a SWAR bit count (torch has no popcount op), over the full (N, M)
matrix; GMS votes matches into 20x20 cell-pair counts and applies the
published 3x3-neighbourhood rule (VerifyCellPairs, gms_matcher.cpp:102-150).
All counts are integers, so the filter is exact.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

_G = 20
_THRESH_FACTOR = 6.0


def popcount32(x: Tensor) -> Tensor:
    """Bit count of each 32-bit word (int32 bit patterns), SWAR in int64 so
    no step can overflow."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F).to(torch.int32)


def hamming_distance_matrix(da: Tensor, db: Tensor) -> Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances."""
    x = popcount32(da[:, None, :] ^ db[None, :, :])
    return torch.sum(x, dim=-1, dtype=torch.int32)


def match_bruteforce(da: Tensor, valid_a: Tensor, db: Tensor,
                     valid_b: Tensor):
    """Best match in b for each a (NORM_HAMMING, no cross check); ties go to
    the lower index. Returns (idx (N,), dist (N,), ok (N,))."""
    d = hamming_distance_matrix(da, db)
    d = torch.where(valid_b[None, :], d, torch.full_like(d, 512))
    idx = torch.argmin(d, dim=1)
    dist = torch.gather(d, 1, idx[:, None])[:, 0]
    ok = valid_a & (dist < 512)
    return idx.to(torch.int32), dist, ok


def _scaled_offset(x: Tensor, step: float, off: float) -> Tensor:
    """x / step + off as the compiled JAX package evaluates it: XLA folds the
    division by a constant into a multiply by its f32 reciprocal and fuses
    the add (fma, emulated exactly in f64). Keypoints sit on integer pixels,
    many of them exactly on GMS cell borders, where the two forms floor to
    different cells."""
    r = float(np.float32(1.0) / np.float32(step))
    return (x.to(torch.float64) * r + off).to(torch.float32)


def _cell_of(xy: Tensor, w: float, h: float, off_x: float, off_y: float):
    """20x20 grid cell index with a half-cell offset option; -1 outside."""
    cw, ch = w / _G, h / _G
    cx = torch.floor(_scaled_offset(xy[:, 0], cw, off_x))
    cy = torch.floor(_scaled_offset(xy[:, 1], ch, off_y))
    ok = (cx >= 0) & (cx < _G) & (cy >= 0) & (cy < _G)
    cell = (torch.clamp(cy, 0, _G - 1) * _G + torch.clamp(cx, 0, _G - 1))
    return torch.where(ok, cell.to(torch.int64),
                       torch.full_like(cell, -1, dtype=torch.int64))


def gms_filter(xy_a: Tensor, xy_b: Tensor, match_ok: Tensor,
               width: float, height: float) -> Tensor:
    """Inlier mask over matches a[i] <-> b[i] (already aligned)."""
    dev = xy_a.device
    N = xy_a.shape[0]
    NC = _G * _G
    inlier = torch.zeros((N,), dtype=torch.bool, device=dev)
    cb = _cell_of(xy_b, width, height, 0.0, 0.0)
    ar = torch.arange(NC, device=dev)
    ay, ax = ar // _G, ar % _G

    for off in ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5)):
        ca = _cell_of(xy_a, width, height, off[0], off[1])
        ok = match_ok & (ca >= 0) & (cb >= 0)
        pair = torch.where(ok, ca * NC + cb, torch.full_like(ca, NC * NC))
        # integer counts: exact and order-free (no host sync, unlike bincount)
        C = torch.zeros(NC * NC + 1, dtype=torch.int32, device=dev)
        C = C.index_add_(0, pair, torch.ones_like(pair, dtype=torch.int32))
        C = C[:NC * NC].reshape(NC, NC).to(torch.float32)
        npts = C.sum(dim=1)

        best_b = torch.argmax(C, dim=1)
        has_any = npts > 0

        C4 = C.reshape(_G, _G, _G, _G)
        score = torch.zeros((NC,), dtype=torch.float32, device=dev)
        thresh = torch.zeros((NC,), dtype=torch.float32, device=dev)
        numpair = torch.zeros((NC,), dtype=torch.float32, device=dev)
        by, bx = best_b // _G, best_b % _G
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nay, nax = ay + dy, ax + dx
                nby, nbx = by + dy, bx + dx
                ok9 = ((nay >= 0) & (nay < _G) & (nax >= 0) & (nax < _G)
                       & (nby >= 0) & (nby < _G) & (nbx >= 0) & (nbx < _G))
                nayc = torch.clamp(nay, 0, _G - 1)
                naxc = torch.clamp(nax, 0, _G - 1)
                nbyc = torch.clamp(nby, 0, _G - 1)
                nbxc = torch.clamp(nbx, 0, _G - 1)
                val = C4[nayc, naxc, nbyc, nbxc]
                zero = torch.zeros_like(val)
                score = score + torch.where(ok9, val, zero)
                thresh = thresh + torch.where(
                    ok9, npts[nayc * _G + naxc], zero)
                numpair = numpair + ok9.to(torch.float32)

        cell_pass = has_any & (
            score >= _THRESH_FACTOR * torch.sqrt(
                thresh / torch.clamp(numpair, min=1.0)))

        ca_c = torch.clamp(ca, 0, NC - 1)
        m_in = ok & cell_pass[ca_c] & (cb == best_b[ca_c])
        inlier = inlier | m_in

    return inlier & match_ok

"""The blocking of the two TPS CUDA kernels (`csrc/tps.cu`), emulated with
the plain versions on the CPU.

`tps_iteration` runs the four checkerboard phases of an iteration on a
tile plus a halo held in shared memory (temporal blocking); `tps_merge`
sums per (cell, relative code) over a tile of superpixels plus a ring of one
cell and combines the 9 partials of each superpixel in a fixed order. The
emulations below cut the frame the same way, with tiles that do not divide
it, and are held against `iteration_reference`, `merge_reference` and the
JAX package's `cell_reduce`. The kernels themselves are held against the
plain versions on a card (`tests/test_torch_tps_cuda.py`, `chip_smoke.py`).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.ops import tps as jtps
from supersurfel_fusion_tpu.ops.depth import depth_to_disp
from supersurfel_fusion_tpu_torch.config import TPSConfig
from supersurfel_fusion_tpu_torch.ops import tps as ttps
from supersurfel_fusion_tpu_torch.ops import tps_cuda

from test_torch_depth_tps import scene

# One intra-op thread: the suite runs in several worker processes at once,
# and each process's OpenMP threads spinning against the others' made the
# torch tests about 20 times slower on an 8-core machine.
torch.set_num_threads(1)

CS = 16
# an output tile that divides neither frame; even height and a width that
# is a multiple of 4, as the kernel's tiles keep the checkerboard parity
TILE = (28, 36)
FRAMES = [(64, 128), (96, 160)]


def _kernel_constant(name: str) -> int:
    src = tps_cuda.SOURCE.read_text()
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def _frame(H, W):
    rgb, depth = scene(H, W)
    disp = torch.from_numpy(np.array(depth_to_disp(jnp.asarray(depth))))
    rgb_chw = torch.from_numpy(rgb).permute(2, 0, 1).contiguous()
    return rgb_chw, disp, torch.isfinite(disp).float()


def _blocky_labels(H, W, seed, blk=2):
    """Labels drawn at random from each pixel's 3x3 cell window, constant on
    blk x blk blocks: many boundary pixels that change in every phase."""
    rng = np.random.default_rng(seed)
    gh, gw = H // CS, W // CS
    y, x = np.mgrid[0:H, 0:W]
    d = [np.kron(rng.integers(-1, 2, (H // blk, W // blk)),
                 np.ones((blk, blk), np.int64)) for _ in range(2)]
    gy = np.clip(y // CS + d[0], 0, gh - 1)
    gx = np.clip(x // CS + d[1], 0, gw - 1)
    return torch.from_numpy((gy * gw + gx).astype(np.int32))


def _states(H, W):
    """(labels, table) pairs: a segmentation one RGB iteration in, and the
    blocky random labelling with its own stats."""
    rgb_chw, disp, inl = _frame(H, W)
    cfg = TPSConfig()
    table0 = torch.zeros((9, H // CS, W // CS))
    labels, _, table = tps_cuda.run_iterations_reference(
        rgb_chw, disp, ttps.grid_labels(H, W, CS, "cpu"), inl, table0, 1,
        False, cfg)
    noisy = _blocky_labels(H, W, seed=H + W)
    return [(labels, table),
            (noisy, tps_cuda.merge_reference(rgb_chw, disp, noisy, inl,
                                             table0, False, CS))]


def _blocked_iteration(rgb_chw, disp, labels, inliers, table, use_disp, cfg,
                       halo):
    """Each tile sees its labels plus a `halo`-px ring and nothing else
    (-1, as off-image pixels read); 4 phases on that view; the tiles'
    interiors are stitched."""
    H, W = labels.shape
    th, tw = TILE
    out_l, out_i = torch.empty_like(labels), torch.empty_like(inliers)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            ys, xs = max(0, y0 - halo), max(0, x0 - halo)
            seen = torch.full_like(labels, -1)
            seen[ys:y0 + th + halo, xs:x0 + tw + halo] = \
                labels[ys:y0 + th + halo, xs:x0 + tw + halo]
            lab, inl = tps_cuda.iteration_reference(
                rgb_chw, disp, seen, inliers, table, use_disp, cfg)
            out_l[y0:y0 + th, x0:x0 + tw] = lab[y0:y0 + th, x0:x0 + tw]
            out_i[y0:y0 + th, x0:x0 + tw] = inl[y0:y0 + th, x0:x0 + tw]
    return out_l, out_i


def _phase_of(y, x):
    for k, (off_x, off_y) in enumerate(ttps._PHASES):
        col = (x % 4 in (0, 3)) if off_x == 0 else (x % 4 in (1, 2))
        if y % 2 == off_y and col:
            return k
    raise AssertionError("every pixel belongs to one phase")


@functools.lru_cache(maxsize=None)
def _depends_on(y, x, k):
    """Pixels whose pre-iteration label the phase-k decision at (y, x)
    reads: its own, its 8-ring's, and through each ring pixel decided in an
    earlier phase, what that decision read."""
    out = {(y, x)}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            r = (y + dy, x + dx)
            out.add(r)
            if r != (y, x) and _phase_of(*r) < k:
                out |= _depends_on(*r, _phase_of(*r))
    return frozenset(out)


def test_iteration_reach_fits_the_kernel_halo():
    """An iteration's labels depend on the pre-iteration labels within 3 px
    (each pixel is decided in one phase only, and the phases' masks chain
    outward by at most 3 px); the kernel's halo covers that."""
    reach = max(max(abs(py - y), abs(px - x))
                for y in range(2) for x in range(4)
                for py, px in _depends_on(y, x, _phase_of(y, x)))
    assert reach == 3
    assert _kernel_constant("kHalo") >= reach


@pytest.mark.parametrize("use_disp", [False, True])
@pytest.mark.parametrize("H,W", FRAMES)
def test_blocked_iteration_equals_reference(H, W, use_disp):
    """Temporal blocking with the kernel's halo (and with the 3 px the
    reach needs) gives the whole-image iteration exactly."""
    rgb_chw, disp, inl = _frame(H, W)
    cfg = TPSConfig()
    for labels, table in _states(H, W):
        if use_disp:
            table = tps_cuda.merge_reference(rgb_chw, disp, labels, inl,
                                             table, True, CS)
        ref_l, ref_i = tps_cuda.iteration_reference(
            rgb_chw, disp, labels, inl, table, use_disp, cfg)
        assert (ref_l != labels).sum() > 0
        for halo in (_kernel_constant("kHalo"), 3):
            lab, inliers = _blocked_iteration(rgb_chw, disp, labels, inl,
                                              table, use_disp, cfg, halo)
            assert torch.equal(lab, ref_l), halo
            assert torch.equal(inliers, ref_i), halo


@pytest.mark.parametrize("H,W", FRAMES)
def test_two_px_halo_does_not_suffice(H, W):
    rgb_chw, disp, inl = _frame(H, W)
    cfg = TPSConfig()
    labels, table = _states(H, W)[1]
    ref_l, _ = tps_cuda.iteration_reference(rgb_chw, disp, labels, inl,
                                            table, False, cfg)
    lab, _ = _blocked_iteration(rgb_chw, disp, labels, inl, table, False,
                                cfg, 2)
    assert (lab != ref_l).sum() > 0


# ---------------------------------------------------------------------------
# tps_merge
# ---------------------------------------------------------------------------


def _merge_features(rgb_chw, disp, labels, inliers, gw):
    """The kernel's 15 per-pixel sums: n, x, y, r, g, b and the 9 plane
    moments in label-cell-centred coordinates."""
    H, W = labels.shape
    y, x = ttps._iota(H, W, "cpu", torch.float32)
    xl = x - ((labels % gw).float() * CS + (CS - 1) * 0.5)
    yl = y - ((labels // gw).float() * CS + (CS - 1) * 0.5)
    w = (inliers > 0.5).float()
    d = torch.where(torch.isfinite(disp), disp, torch.zeros_like(disp))
    return torch.stack(
        [torch.ones_like(x), x, y, rgb_chw[0], rgb_chw[1], rgb_chw[2],
         w, w * xl, w * yl, w * xl * xl, w * yl * yl, w * xl * yl,
         w * d, w * xl * d, w * yl * d], dim=-1)


def _blocked_sums(feats, labels, gh, gw):
    """Per (cell, code) partials over each block's owned superpixels plus a
    ring of one cell, only for labels the block owns; each superpixel adds
    its 9 partials in code order."""
    ty, tx = _kernel_constant("kMergeTY"), _kernel_constant("kMergeTX")
    code = ttps._rel_code(labels, gh, gw, CS)
    out = torch.full((gh, gw, feats.shape[-1]), float("nan"))
    for by in range(0, gh, ty):
        for bx in range(0, gw, tx):
            part = {}
            for py in range(by - 1, by + ty + 1):
                for px in range(bx - 1, bx + tx + 1):
                    if not (0 <= py < gh and 0 <= px < gw):
                        continue
                    cell = (slice(py * CS, (py + 1) * CS),
                            slice(px * CS, (px + 1) * CS))
                    for k, (dy, dx) in enumerate(ttps._OFFS):
                        ly, lx = py + dy, px + dx
                        if by <= ly < by + ty and bx <= lx < bx + tx:
                            m = (code[cell] == k)[..., None]
                            part[py, px, k] = torch.where(
                                m, feats[cell], 0.0).sum(dim=(0, 1))
            for gy in range(by, min(by + ty, gh)):
                for gx in range(bx, min(bx + tx, gw)):
                    s = torch.zeros(feats.shape[-1])
                    for k, (dy, dx) in enumerate(ttps._OFFS):
                        s = s + part.get((gy - dy, gx - dx, k), 0.0)
                    out[gy, gx] = s
    return out


def _table_from_sums(s, table, use_disp, gh, gw):
    """The kernel's epilogue: means, and Cramer's rule for the plane."""
    out = table.clone()
    n = s[..., 0]
    safe_n = torch.clamp(n, min=1e-6)
    for c in range(5):
        out[c] = s[..., c + 1] / safe_n
    out[5] = n
    if use_disp:
        a00, a01, a02 = s[..., 9], s[..., 11], s[..., 7]
        a11, a12, a22 = s[..., 10], s[..., 8], s[..., 6]
        b0, b1, b2 = s[..., 13], s[..., 14], s[..., 12]
        c00 = a11 * a22 - a12 * a12
        c01 = a12 * a02 - a01 * a22
        c02 = a01 * a12 - a11 * a02
        det = a00 * c00 + a01 * c01 + a02 * c02
        c11 = a00 * a22 - a02 * a02
        c12 = a01 * a02 - a00 * a12
        c22 = a00 * a11 - a01 * a01
        ok = det.abs() > 1e-12
        sdet = torch.where(ok, det, torch.ones_like(det))
        ta = (c00 * b0 + c01 * b1 + c02 * b2) / sdet
        tb = (c01 * b0 + c11 * b1 + c12 * b2) / sdet
        tcl = (c02 * b0 + c12 * b1 + c22 * b2) / sdet
        gy, gx = ttps._iota(gh, gw, "cpu", torch.float32)
        tc = tcl - ta * (gx * CS + (CS - 1) * 0.5) \
            - tb * (gy * CS + (CS - 1) * 0.5)
        out[6] = torch.where(ok, ta, 0.0)
        out[7] = torch.where(ok, tb, 0.0)
        out[8] = torch.where(ok, tc, -1e30)
    return out


@pytest.mark.parametrize("use_disp", [False, True])
@pytest.mark.parametrize("H,W", FRAMES)
def test_blocked_merge_matches_reference_and_jax(H, W, use_disp):
    rgb_chw, disp, inl = _frame(H, W)
    gh, gw = H // CS, W // CS
    for labels, table in _states(H, W):
        feats = _merge_features(rgb_chw, disp, labels, inl, gw)
        sums = _blocked_sums(feats, labels, gh, gw)
        # the same sums as the JAX package's one-hot cell reduction
        sj = np.asarray(jtps.cell_reduce(jnp.asarray(feats.numpy()),
                                         jnp.asarray(labels.numpy()), gh,
                                         gw, CS))
        np.testing.assert_allclose(sums.numpy(), sj, rtol=1e-5, atol=1e-3)
        assert float(sums[..., 0].sum()) == H * W

        mk = _table_from_sums(sums, table, use_disp, gh, gw)
        mp = tps_cuda.merge_reference(rgb_chw, disp, labels, inl, table,
                                      use_disp, CS)
        # f32 sums of <= 2304 pixels in another order
        torch.testing.assert_close(mk[:6], mp[:6], rtol=1e-5, atol=1e-3)
        if not use_disp:
            assert torch.equal(mk[6:], table[6:])
            continue
        sk = tps_cuda.stats_from_table(mk)
        sp = tps_cuda.stats_from_table(mp)
        cx, cy = sp.centroid[..., 0], sp.centroid[..., 1]
        dk = ttps.eval_plane(sk.theta, cx, cy)
        dp = ttps.eval_plane(sp.theta, cx, cy)
        assert torch.equal(torch.isfinite(dk), torch.isfinite(dp))
        ok = torch.isfinite(dp)
        assert ok.float().mean() > 0.5
        close = ((dk[ok] - dp[ok]).abs() <= 1e-4).float().mean().item()
        assert close >= 0.99

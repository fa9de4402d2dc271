"""PyTorch port vs the JAX package: depth preprocessing and the plain TPS
segmentation (`ops/tps.py`), on seeded numpy inputs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.config import TPSConfig as JTPSConfig
from supersurfel_fusion_tpu.ops import depth as jdepth
from supersurfel_fusion_tpu.ops import tps as jtps
from supersurfel_fusion_tpu_torch.config import TPSConfig
from supersurfel_fusion_tpu_torch.ops import depth as tdepth
from supersurfel_fusion_tpu_torch.ops import tps as ttps

# One intra-op thread: the suite runs in several worker processes at once,
# and each process's OpenMP threads spinning against the others' made the
# torch tests about 20 times slower on an 8-core machine.
torch.set_num_threads(1)


def scene(H=64, W=128, seed=0):
    """The two-region scene of tests/test_tps_pallas.py with a depth hole."""
    rng = np.random.default_rng(seed)
    rgb = np.zeros((H, W, 3), np.float32)
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    m = (xx + 0.7 * yy) > 70
    rgb[...] = [180, 60, 60]
    rgb[m] = [60, 180, 60]
    rgb += rng.normal(0, 3, rgb.shape).astype(np.float32)
    depth = np.where(m, 2.0, 1.0).astype(np.float32)
    depth += (0.01 * np.sin(xx / 9.0)).astype(np.float32)
    depth[5:9, 11:17] = 0.0
    return rgb, depth


def _t(a):
    return torch.from_numpy(np.array(a))


def test_bilateral_and_disp_match_jax():
    _, depth = scene()
    depth = depth + np.random.default_rng(1).normal(
        0, 0.005, depth.shape).astype(np.float32) * (depth > 0)
    fj = jax.jit(jdepth.bilateral_filter, static_argnums=(1, 2, 3))(
        jnp.asarray(depth), 0.03, 4.5, 6)
    ft = tdepth.bilateral_filter(_t(depth), 0.03, 4.5, 6)
    # same stencil in the same order: equal to f32 rounding
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6,
                               atol=1e-7)
    dj = np.asarray(jdepth.depth_to_disp(fj))
    dt = tdepth.depth_to_disp(ft).numpy()
    assert np.array_equal(np.isinf(dj), np.isinf(dt))
    fin = np.isfinite(dj)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=1e-6)


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, 0), (-2, 3), (5, -1),
                                   (0, -7), (70, 0)])
def test_shift2d_matches_jax(dy, dx):
    rng = np.random.default_rng(2)
    img = rng.normal(size=(16, 20, 3)).astype(np.float32)
    a = np.asarray(jdepth.shift2d(jnp.asarray(img), dy, dx, fill=-5.0))
    b = tdepth.shift2d(_t(img), dy, dx, fill=-5.0).numpy()
    assert np.array_equal(a, b)


def test_ransac_table_equals_jax_draw():
    key = jax.random.PRNGKey(1234)
    for cs, n in ((16, 16), (8, 16), (16, 4), (12, 32)):
        offs = jax.random.uniform(key, (n, 3, 2), minval=-cs / 2.0,
                                  maxval=cs / 2.0, dtype=jnp.float32)
        assert np.array_equal(np.asarray(offs), ttps.ransac_offsets(cs, n))


def _labels_and_stats(H, W, cs, seed):
    """A perturbed grid labelling (labels stay in the 3x3 cell window)."""
    rng = np.random.default_rng(seed)
    gw = W // cs
    yy, xx = np.mgrid[0:H, 0:W]
    gy = np.clip(yy // cs + rng.integers(-1, 2, (H, W)) * (rng.random(
        (H, W)) < 0.2), 0, H // cs - 1)
    gx = np.clip(xx // cs + rng.integers(-1, 2, (H, W)) * (rng.random(
        (H, W)) < 0.2), 0, gw - 1)
    return (gy * gw + gx).astype(np.int32)


def test_cell_reduce_and_fit_planes_match_jax():
    H, W, cs = 64, 128, 16
    gh, gw = H // cs, W // cs
    labels = _labels_and_stats(H, W, cs, 3)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(H, W, 5)).astype(np.float32)
    a = np.asarray(jtps.cell_reduce(jnp.asarray(feats), jnp.asarray(labels),
                                    gh, gw, cs))
    b = ttps.cell_reduce(_t(feats), _t(labels), gh, gw, cs).numpy()
    # sums of up to 2304 terms in another order
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)

    _, depth = scene()
    disp = np.asarray(jdepth.depth_to_disp(jnp.asarray(depth)))
    inl = np.isfinite(disp) & (rng.random((H, W)) < 0.9)
    tj = np.asarray(jtps.fit_planes(jnp.asarray(disp), jnp.asarray(labels),
                                    jnp.asarray(inl), gh, gw, cs))
    tt = ttps.fit_planes(_t(disp), _t(labels), _t(inl), gh, gw, cs).numpy()
    assert np.array_equal(np.isnan(tj), np.isnan(tt))
    fin = np.isfinite(tj)
    np.testing.assert_allclose(tt[fin], tj[fin], rtol=1e-3, atol=1e-6)


def test_stencils_match_jax():
    labels = _labels_and_stats(64, 128, 16, 4)
    assert np.array_equal(
        np.asarray(jtps.boundary_count(jnp.asarray(labels))),
        ttps.boundary_count(_t(labels)).numpy())
    assert np.array_equal(
        np.asarray(jtps.unchangeable(jnp.asarray(labels))),
        ttps.unchangeable(_t(labels)).numpy())


def _segments(nb_iters=4):
    rgb, depth = scene()
    disp = np.asarray(jdepth.depth_to_disp(jnp.asarray(depth)))
    rj = jtps.segment(jnp.asarray(rgb), jnp.asarray(disp),
                      JTPSConfig(nb_iters=nb_iters))
    rt = ttps.segment(_t(rgb), _t(disp), TPSConfig(nb_iters=nb_iters))
    return rgb, disp, rj, rt


def test_segment_matches_jax():
    H, W = 64, 128
    _, _, rj, rt = _segments()
    lj, lt = np.asarray(rj.labels), rt.labels.numpy()
    assert (lj == lt).mean() >= 0.99
    assert float(rt.stats.size.sum()) == H * W
    np.testing.assert_allclose(rt.inliers.float().mean().item(),
                               np.asarray(rj.inliers).mean(), atol=0.01)
    thj, tht = np.asarray(rj.stats.theta), rt.stats.theta.numpy()
    both = np.isfinite(thj[..., 2]) & np.isfinite(tht[..., 2])
    assert both.mean() > 0.9
    assert np.median(np.abs(thj[both] - tht[both])) < 1e-4


def test_smooth_and_render_match_jax():
    H, W, cs = 64, 128, 16
    cfg = TPSConfig()
    _, _, rj, _ = _segments(nb_iters=2)
    st = ttps.SuperpixelStats(*(_t(a) for a in rj.stats))
    thj = np.asarray(jtps.smooth_planes(rj.stats, JTPSConfig()))
    tht = ttps.smooth_planes(st, cfg).numpy()
    fin = np.isfinite(thj)
    assert np.array_equal(fin, np.isfinite(tht))
    np.testing.assert_allclose(tht[fin], thj[fin], rtol=1e-4, atol=1e-6)
    dj = np.asarray(jtps.render_plane_depth(jnp.asarray(thj), rj.labels,
                                            H // cs, W // cs, cs))
    dt = ttps.render_plane_depth(_t(thj), _t(rj.labels), H // cs, W // cs,
                                 cs).numpy()
    np.testing.assert_array_equal(dt, dj)


def test_ransac_plane_init_matches_jax():
    H, W, cs = 64, 128, 16
    cfgj, cfgt = JTPSConfig(), TPSConfig()
    _, disp, rj, _ = _segments(nb_iters=2)
    st = ttps.SuperpixelStats(*(_t(a) for a in rj.stats))
    thj, inj = jtps.ransac_plane_init(jnp.asarray(disp), rj.labels, rj.stats,
                                      cfgj, H // cs, W // cs)
    tht, int_ = ttps.ransac_plane_init(_t(disp), _t(rj.labels), st, cfgt,
                                       H // cs, W // cs)
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj), rtol=1e-5,
                               atol=1e-6)
    assert (int_.numpy() == np.asarray(inj)).mean() > 0.999

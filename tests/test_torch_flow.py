"""PyTorch port vs the JAX package: the MOD's flow module (similarity
RANSAC, warps, the SE(3) depth residual, pyramidal LK flow), the rigid 3D
RANSAC of the depth-residual cue, and their `jax.random` draws (made by the
port's `utils/prng.py`), on seeded numpy inputs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.ops import flow as jflow
from supersurfel_fusion_tpu.ops import loop_closure as jlc
from supersurfel_fusion_tpu_torch.ops import flow as tflow
from supersurfel_fusion_tpu_torch.ops import loop_closure as tlc

# One intra-op thread: the suite runs in several worker processes at once,
# and each process's OpenMP threads spinning against the others' made the
# torch tests about 20 times slower on an 8-core machine.
torch.set_num_threads(1)

K_CAP = 300   # the test's keypoint capacity


def _t(a):
    return torch.from_numpy(np.array(a))


def smooth_image(H, W, seed, dx=0.0, dy=0.0):
    """A smooth random texture, optionally sampled shifted by (dx, dy)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xx, yy = xx + dx, yy + dy
    img = np.full((H, W), 120.0)
    for _ in range(6):
        fx, fy = rng.uniform(0.03, 0.15, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        img += rng.uniform(10, 30) * np.sin(fx * xx + ph[0]) \
            * np.cos(fy * yy + ph[1])
    return img.astype(np.float32)


@pytest.mark.parametrize("span", [1, 7, K_CAP, 2**30])
def test_similarity_draw_matches_jax_randint(span):
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(1234), (256, 2),
                                        0, span))
    pairs = tflow._pairs_on(1234, 256, span, torch.device("cpu"))
    np.testing.assert_array_equal(pairs.numpy(), ref)


def test_rigid_draw_matches_jax_randint():
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (256, 3), 0,
                                        1 << 30))
    draw = tlc._draw_on(7, 256, torch.device("cpu"))
    np.testing.assert_array_equal(draw.numpy(), ref)


def _correspondences(seed, n=K_CAP, outliers=0.3, n_valid=220):
    rng = np.random.default_rng(seed)
    src = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    ang, s = 0.03, 1.01
    M = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    dst = src @ M.T + np.array([4.0, -3.0]) + rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) < outliers
    dst[bad] += rng.uniform(-60, 60, (int(bad.sum()), 2))
    ok = np.zeros(n, bool)
    ok[rng.permutation(n)[:n_valid]] = True
    return src, dst.astype(np.float32), ok


@pytest.mark.parametrize("seed,n_valid", [(0, 220), (1, 40), (2, 4)])
def test_similarity_ransac_matches_jax(seed, n_valid):
    src, dst, ok = _correspondences(seed, n_valid=n_valid)
    rj = jax.jit(jflow.estimate_similarity_ransac)(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ok))
    rt = tflow.estimate_similarity_ransac(_t(src), _t(dst), _t(ok))
    assert bool(rt[4]) == bool(rj[4])
    # the refit solves uncentred normal equations in f32 (sums of x^2 + y^2
    # over the image, condition ~1e6): the order of the f32 sums alone
    # moves the translation by up to ~8e-4 px between the two packages
    # (JAX's own error against an f64 solve reaches 3.6e-4 px), so the
    # translation is held to 1e-3 px and the linear part to 1e-4
    for k, tol in enumerate((1e-4, 1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   atol=tol)
    if n_valid >= 40:
        assert bool(rt[4])


def test_warp_and_bilinear_sample_match_jax():
    img = smooth_image(96, 128, 5)
    p = (np.float32(1.02), np.float32(0.04), np.float32(3.5),
         np.float32(-2.25))
    wj = jflow.warp_similarity(jnp.asarray(img), *[jnp.float32(v) for v in p])
    wt = tflow.warp_similarity(_t(img), *[torch.tensor(v) for v in p])
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    rng = np.random.default_rng(6)
    xs = rng.uniform(-3, 130, (40, 50)).astype(np.float32)
    ys = rng.uniform(-3, 99, (40, 50)).astype(np.float32)
    xs[0, :5] = [0.0, 127.0, np.nan, 126.999, -0.0]
    sj = jflow.bilinear_sample(jnp.asarray(img), jnp.asarray(xs),
                               jnp.asarray(ys), -1.0)
    st = tflow.bilinear_sample(_t(img), _t(xs), _t(ys), -1.0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    # a stack samples each image at the shared coordinates
    st3 = tflow.bilinear_sample(_t(np.stack([img, 2 * img])), _t(xs),
                                _t(ys), -1.0)
    np.testing.assert_array_equal(st3[0].numpy(), st.numpy())


def test_se3_depth_residual_matches_jax():
    H, W = 96, 128
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:H, 0:W]
    d_prev = (2.0 + 0.5 * np.sin(xx / 20.0) + 0.3 * (yy > 60)).astype(
        np.float32)
    d_cur = d_prev + rng.normal(0, 0.01, (H, W)).astype(np.float32)
    d_cur[30:50, 40:70] = 1.2          # a mover in front
    d_cur[rng.random((H, W)) < 0.05] = 0.0
    ang = 0.02
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.array([0.03, -0.01, 0.02], np.float32)
    args = (100.0, 100.0, 63.5, 47.5)
    rj = jax.jit(jflow.se3_depth_residual, static_argnums=(4, 5, 6, 7))(
        jnp.asarray(d_cur), jnp.asarray(d_prev), jnp.asarray(R),
        jnp.asarray(t), *args)
    rt = tflow.se3_depth_residual(_t(d_cur), _t(d_prev), _t(R), _t(t), *args)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    assert (np.asarray(rj) > 0.5).sum() > 100


@pytest.mark.parametrize("H,W,shift", [(128, 160, (2.3, -1.4)),
                                       (120, 152, (-5.5, 3.0))])
def test_dense_flow_matches_jax(H, W, shift):
    I0 = smooth_image(H, W, 9)
    I1 = smooth_image(H, W, 9, dx=-shift[0], dy=-shift[1])
    fj = np.asarray(jax.jit(jflow.dense_flow)(jnp.asarray(I0),
                                              jnp.asarray(I1)))
    ft = tflow.dense_flow(_t(I0), _t(I1)).numpy()
    assert ft.shape == (H, W, 2)
    # LK solves a 2x2 system per pixel; where the structure tensor is near
    # singular, f32 rounding moves the flow by up to a few 1e-3 px. The
    # JAX package's own f32 flow is that far from an f64 evaluation of the
    # same steps, so the port is held to 1e-4 px on 99% of pixels, 5e-3 px
    # on all, and to be as close to the f64 evaluation as JAX is
    d = np.abs(ft - fj)
    assert np.quantile(d, 0.99) <= 1e-4, np.quantile(d, 0.99)
    assert d.max() <= 5e-3, d.max()
    f64 = tflow.dense_flow(_t(I0).double(), _t(I1).double()).numpy()
    err_jax = np.abs(fj - f64).max()
    assert np.abs(ft - f64).max() <= 2 * err_jax + 1e-4
    # the flow finds the shift in the interior
    inner = fj[16:-16, 16:-16]
    assert np.abs(np.median(inner[..., 0]) - shift[0]) < 0.3


def test_flow_upsample_weights_match_jax_resize():
    rng = np.random.default_rng(10)
    f = rng.normal(0, 2, (15, 19, 2)).astype(np.float32)
    rj = np.asarray(jax.image.resize(jnp.asarray(f), (30, 38, 2),
                                     "bilinear"))
    rt = tflow._resize_flow(_t(f), 30, 38).numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-5)


def test_box_filter_matches_jax():
    rng = np.random.default_rng(11)
    imgs = rng.normal(0, 10, (5, 24, 30)).astype(np.float32)
    bt = tflow._box(_t(imgs), 4).numpy()
    for c in range(5):
        bj = np.asarray(jflow._box(jnp.asarray(imgs[c]), 4))
        np.testing.assert_array_equal(bt[c], bj)


def _rigid_pairs(seed, n=K_CAP, n_valid=150, outliers=0.3):
    rng = np.random.default_rng(seed)
    src = rng.uniform([-1.5, -1.0, 1.0], [1.5, 1.0, 4.0], (n, 3))
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    dst = src @ R.T + np.array([0.05, 0.02, -0.03]) \
        + rng.normal(0, 0.005, (n, 3))
    bad = rng.random(n) < outliers
    dst[bad] += rng.uniform(-0.5, 0.5, (int(bad.sum()), 3))
    ok = np.zeros(n, bool)
    ok[rng.permutation(n)[:n_valid]] = True
    xy = rng.uniform([0, 0], [640, 480], (n, 2))
    f32 = np.float32
    return src.astype(f32), dst.astype(f32), ok, xy.astype(f32)


@pytest.mark.parametrize("seed,n_valid,use_xy",
                         [(0, 150, True), (1, 60, False), (2, 2, True)])
def test_ransac_rigid_3d_matches_jax(seed, n_valid, use_xy):
    src, dst, ok, xy = _rigid_pairs(seed, n_valid=n_valid)
    kw = dict(thresh=0.05, min_inliers=15, min_ratio=0.15)

    def jfn(s, d, o, x):
        return jlc.ransac_rigid_3d(s, d, o, src_xy=x if use_xy else None,
                                   **kw)

    rj = jax.jit(jfn)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ok),
                      jnp.asarray(xy))
    rt = tlc.ransac_rigid_3d(_t(src), _t(dst), _t(ok),
                             src_xy=_t(xy) if use_xy else None, **kw)
    assert bool(rt[2]) == bool(rj[2])
    assert int(rt[3]) == int(rj[3])
    if n_valid >= 60:
        assert bool(rt[2])
        np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]),
                                   atol=1e-5)


def test_kabsch_matches_jax():
    rng = np.random.default_rng(12)
    P = rng.normal(0, 1, (16, 3, 3)).astype(np.float32)
    Q = (P @ np.diag([1, -1, -1]).astype(np.float32)
         + rng.normal(0, 0.01, (16, 3, 3)).astype(np.float32))
    w = np.ones((16, 3), np.float32)
    Rj, tj = jlc._kabsch(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w))
    Rt, tt = tlc._kabsch(_t(P), _t(Q), _t(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    det = np.linalg.det(Rt.numpy())
    np.testing.assert_allclose(det, 1.0, atol=1e-4)


@pytest.mark.parametrize("seed,n_valid,use_xy",
                         [(0, 150, True), (1, 60, False), (2, 2, True),
                          (3, 150, False)])
def test_ransac_rigid_3d_pieces_equal_the_whole(seed, n_valid, use_xy):
    """`ransac_rigid_3d`, composed of `rigid_hypotheses`, `rigid_refit`
    and `rigid_result` around its two SVDs, gives (R, t, valid, n_in) bit
    for bit as the whole function before the cut (`mod_unsplit.py`), with
    and without `src_xy`, at MOD's and loop closure's settings."""
    from mod_unsplit import ransac_rigid_3d_whole

    src, dst, ok, xy = _rigid_pairs(seed, n_valid=n_valid)
    for kw in (dict(thresh=0.05, min_inliers=15, min_ratio=0.15), {}):
        args = (_t(src), _t(dst), _t(ok))
        kw = dict(kw, src_xy=_t(xy) if use_xy else None)
        got = tlc.ransac_rigid_3d(*args, **kw)
        want = ransac_rigid_3d_whole(*args, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert bool(got[2]) == (n_valid >= 60)

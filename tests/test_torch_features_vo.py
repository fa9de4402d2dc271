"""PyTorch port vs the JAX package: ORB features, Hamming matching, GMS and
the sparse VO pieces, on seeded numpy inputs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu.ops import features as jfeat
from supersurfel_fusion_tpu.ops import matching as jmatch
from supersurfel_fusion_tpu.ops import vo as jvo
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch.ops import features as tfeat
from supersurfel_fusion_tpu_torch.ops import matching as tmatch
from supersurfel_fusion_tpu_torch.ops import vo as tvo

CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def textured(H=96, W=128, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0) \
        + rng.uniform(0, 40, (H, W))
    return img.astype(np.float32)


def test_resize_matches_jax_image_resize():
    img = textured()
    for h, w in [(80, 107), (67, 89)]:
        a = np.asarray(jax.image.resize(jnp.asarray(img), (h, w),
                                        method="bilinear"))
        b = tfeat.resize_bilinear(_t(img), h, w).numpy()
        # identical f32 weights; the two contractions round differently in
        # the last bits (a few ulp of the 0..255 range)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,harris", [(3, True), (4, True), (5, False)])
def test_detect_and_describe_bit_exact(seed, harris):
    img = textured(seed=seed)
    kw = dict(nb_features=128, nb_levels=2, harris_rank=harris)
    kj = jfeat.detect_and_describe(jnp.asarray(img), jcfg.VOConfig(**kw))
    kt = tfeat.detect_and_describe(_t(img), tcfg.VOConfig(**kw))
    assert kt.capacity == kj.capacity
    assert int(kt.valid.sum()) > 5
    np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))
    np.testing.assert_array_equal(kt.desc.numpy(),
                                  np.asarray(kj.desc).view(np.int32))
    np.testing.assert_allclose(kt.angle.numpy(), np.asarray(kj.angle),
                               atol=1e-5)


def test_fast_and_harris_match_jax():
    img = textured(seed=6)
    hj, lj, sj = jfeat.fast_scores(jnp.asarray(img), 15.0, 5.0)
    ht, lt, st = tfeat.fast_scores(_t(img), 15.0, 5.0)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tfeat.harris_response(_t(img)).numpy(),
        np.asarray(jfeat.harris_response(jnp.asarray(img))))


def _descs(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def test_hamming_and_bruteforce_exact():
    rng = np.random.default_rng(7)
    da, db = _descs(rng, 60), _descs(rng, 90)
    db[10] = da[3]          # an exact match
    db[11] = da[3]          # a tie: the lower index wins
    db[20] = da[4] ^ np.uint32(1)
    va = rng.random(60) < 0.9
    vb = rng.random(90) < 0.8
    vb[10] = vb[11] = True
    np.testing.assert_array_equal(
        tmatch.hamming_distance_matrix(_t(da), _t(db)).numpy(),
        np.asarray(jmatch.hamming_distance_matrix(jnp.asarray(da),
                                                  jnp.asarray(db))))
    ij, dj, okj = jmatch.match_bruteforce(jnp.asarray(da), jnp.asarray(va),
                                          jnp.asarray(db), jnp.asarray(vb))
    it, dt, okt = tmatch.match_bruteforce(_t(da), _t(va), _t(db), _t(vb))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert int(it[3]) == 10


def test_gms_filter_exact():
    rng = np.random.default_rng(8)
    n = 400
    xy_a = rng.uniform(0, [640, 480], (n, 2)).astype(np.float32)
    xy_b = (xy_a + rng.normal(0, 2, (n, 2))).astype(np.float32)
    out = rng.random(n) < 0.3
    xy_b[out] = rng.uniform(0, [640, 480], (out.sum(), 2))
    ok = rng.random(n) < 0.95
    # integer pixels, many on cell borders, as keypoints are; compared with
    # the compiled JAX function, as the JAX pipeline runs it
    xy_a = np.round(xy_a)
    xy_b[:100] = np.round(xy_b[:100])
    gms = jax.jit(jmatch.gms_filter, static_argnums=(3, 4))
    a = np.asarray(gms(jnp.asarray(xy_a), jnp.asarray(xy_b), jnp.asarray(ok),
                       640.0, 480.0))
    b = tmatch.gms_filter(_t(xy_a), _t(xy_b), _t(ok), 640.0, 480.0).numpy()
    np.testing.assert_array_equal(b, a)
    assert 0 < b.sum() < ok.sum()


def _scene(rng, n):
    return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                     rng.uniform(1.0, 4.0, n)], -1).astype(np.float32)


def _project(p, R, t):
    pc = (p - t) @ R
    return np.stack([pc[:, 0] * CAM["fx"] / pc[:, 2] + CAM["cx"],
                     pc[:, 1] * CAM["fy"] / pc[:, 2] + CAM["cy"]], -1)


def test_pnp_solve_matches_jax():
    """The scene of tests/test_vo.py, with 30% gross outliers."""
    rng = np.random.default_rng(9)
    p3d = _scene(rng, 150)
    c, s = np.cos(0.05), np.sin(0.05)
    R_gt = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t_gt = np.array([0.05, -0.03, 0.08], np.float32)
    uv = _project(p3d, R_gt, t_gt) + rng.normal(0, 0.3, (150, 2))
    uv[:45] += rng.uniform(40, 200, (45, 2))
    uv = uv.astype(np.float32)
    ok = np.ones(150, bool)
    Rj, tj, vj, ij = jvo.pnp_solve(jnp.eye(3), jnp.zeros(3), jnp.asarray(p3d),
                                   jnp.asarray(uv), jnp.asarray(ok),
                                   jcfg.CameraIntrinsics(**CAM),
                                   jcfg.VOConfig())
    Rt, tt, vt, it = tvo.pnp_solve(torch.eye(3), torch.zeros(3), _t(p3d),
                                   _t(uv), _t(ok),
                                   tcfg.CameraIntrinsics(**CAM),
                                   tcfg.VOConfig())
    assert bool(vt) and bool(vj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # 10 Gauss-Newton steps with sums in another order
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


def _keypoints(rng, k, jax_side):
    # clustered, so that GMS finds enough support among the matches
    xy = rng.uniform(100, 170, (k, 2)).astype(np.float32)
    desc = _descs(rng, k)
    valid = rng.random(k) < 0.9
    if jax_side:
        return jfeat.Keypoints(
            xy=jnp.asarray(xy), level=jnp.zeros(k, jnp.int32),
            angle=jnp.zeros(k), score=jnp.ones(k), valid=jnp.asarray(valid),
            desc=jnp.asarray(desc))
    return tfeat.Keypoints(
        xy=_t(xy), level=torch.zeros(k, dtype=torch.int32),
        angle=torch.zeros(k), score=torch.ones(k), valid=_t(valid),
        desc=_t(desc))


def _lmap_equal(lt, lj):
    np.testing.assert_allclose(lt.positions.numpy(), np.asarray(lj.positions),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(lt.desc.numpy(),
                                  np.asarray(lj.desc).view(np.int32))
    np.testing.assert_array_equal(lt.counters.numpy(),
                                  np.asarray(lj.counters))
    np.testing.assert_array_equal(lt.valid.numpy(), np.asarray(lj.valid))


def test_local_map_matches_jax():
    """reset -> find_matches -> update_local_map, twice, with eviction and
    insertion into freed slots; the whole map SoA is held."""
    rng = np.random.default_rng(10)
    jcam, tcam = jcfg.CameraIntrinsics(**CAM), tcfg.CameraIntrinsics(**CAM)
    jc = jcfg.VOConfig(untracked_threshold=2, local_map_capacity=48)
    tc = tcfg.VOConfig(untracked_threshold=2, local_map_capacity=48)
    depth = rng.uniform(0.5, 4.5, (480, 640)).astype(np.float32)
    kj = _keypoints(np.random.default_rng(11), 40, True)
    kt = _keypoints(np.random.default_rng(11), 40, False)
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    lj = jvo.reset_local_map(kj, jnp.asarray(depth), jnp.asarray(R),
                             jnp.asarray(t), jcam, 48)
    lt = tvo.reset_local_map(kt, _t(depth), _t(R), _t(t), tcam, 48)
    _lmap_equal(lt, lj)
    for step in range(3):
        # the next frame re-observes half the keypoints with noisy pixels
        krng = np.random.default_rng(20 + step)
        k2j = _keypoints(krng, 40, True)
        k2t = _keypoints(np.random.default_rng(20 + step), 40, False)
        keep = np.arange(40) < 20
        xy = np.where(keep[:, None], np.asarray(kj.xy)
                      + krng.normal(0, 0.5, (40, 2)), np.asarray(k2j.xy))
        xy = xy.astype(np.float32)
        desc = np.where(keep[:, None], np.asarray(kj.desc),
                        np.asarray(k2j.desc))
        k2j = k2j._replace(xy=jnp.asarray(xy), desc=jnp.asarray(desc))
        k2t = k2t._replace(xy=_t(xy), desc=_t(desc))
        mj, lj = jvo.find_matches(lj, k2j, jnp.asarray(R), jnp.asarray(t),
                                  jcam, jc)
        mt, lt = tvo.find_matches(lt, k2t, _t(R), _t(t), tcam, tc)
        np.testing.assert_array_equal(mt.map_idx.numpy(),
                                      np.asarray(mj.map_idx))
        assert int(mt.n) == int(mj.n)
        assert int(mt.n) > 0
        _lmap_equal(lt, lj)
        lj = jvo.update_local_map(lj, k2j, jnp.asarray(depth), mj,
                                  jnp.asarray(R), jnp.asarray(t), jcam, jc)
        lt = tvo.update_local_map(lt, k2t, _t(depth), mt, _t(R), _t(t),
                                  tcam, tc)
        _lmap_equal(lt, lj)

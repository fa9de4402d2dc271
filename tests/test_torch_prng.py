"""PyTorch port vs the JAX package: `jax.random`'s draws made by the port
(`supersurfel_fusion_tpu_torch/utils/prng.py`) and the modules that draw
with them, on the CPU: the keys, the bits, `uniform` and `randint` exact;
`normal` within NORMAL_ULP; the person detector's initial weights; the TPS
segmentation at other `nb_samples` than the default; both RANSACs at
other seeds and hypothesis counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.config import TPSConfig as JTPSConfig
from supersurfel_fusion_tpu.models import person_detector as jpd
from supersurfel_fusion_tpu.ops import depth as jdepth
from supersurfel_fusion_tpu.ops import flow as jflow
from supersurfel_fusion_tpu.ops import loop_closure as jlc
from supersurfel_fusion_tpu.ops import tps as jtps
from supersurfel_fusion_tpu_torch.config import TPSConfig
from supersurfel_fusion_tpu_torch.models import person_detector as tpd
from supersurfel_fusion_tpu_torch.ops import flow as tflow
from supersurfel_fusion_tpu_torch.ops import loop_closure as tlc
from supersurfel_fusion_tpu_torch.ops import tps as ttps
from supersurfel_fusion_tpu_torch.utils import prng

from test_torch_depth_tps import scene
from test_torch_flow import _correspondences, _rigid_pairs

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 1234, 2**31 - 1]
SHAPES = [(1,), (7,), (16, 3, 2), (256, 2), (256, 3), (3, 3, 96, 1),
          (3, 3, 2, 16)]
# XLA's f32 log1p is its own polynomial, within 2 ulp of numpy's; the
# erfinv polynomial carries that to at most 3 ulp of the normal draw (about
# 99% of draws are equal), and the person detector's f32 scale adds one
# rounding. The bound is stated for both.
NORMAL_ULP = 5


def _ulp(a, b):
    """Largest distance in f32 units in the last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(key))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num),
                                      np.asarray(jax.random.split(key, num)))
    sub = jax.random.split(key)[1]
    np.testing.assert_array_equal(prng.split(np.asarray(sub), 4),
                                  np.asarray(jax.random.split(sub, 4)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_draws_equal_jax(shape):
    """Bits, uniform (power-of-two and other ranges: XLA fuses the scale
    and the shift) and randint (spans of 1, small, the keypoint capacity,
    2**30, a negative minimum, an empty range, the whole int32 range)
    exactly; normal within NORMAL_ULP, over every seed."""
    for seed in SEEDS:
        key, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(prng.random_bits(pk, shape),
                                      np.asarray(jax.random.bits(key, shape)))
        for lo, hi in ((0.0, 1.0), (-8.0, 8.0), (-6.0, 6.0), (-3.7, 5.1)):
            ref = jax.random.uniform(key, shape, minval=lo, maxval=hi)
            got = prng.uniform(pk, shape, lo, hi)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, np.asarray(ref))
        for lo, hi in ((0, 1), (0, 7), (0, 300), (0, 1 << 30), (-5, 3),
                       (3, 3), (-2**31, 2**31 - 1)):
            ref = jax.random.randint(key, shape, lo, hi)
            got = prng.randint(pk, shape, lo, hi)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(ref))
        ref = np.asarray(jax.random.normal(key, shape))
        got = prng.normal(pk, shape)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert _ulp(got, ref) <= NORMAL_ULP, seed


@pytest.mark.parametrize("key", [None, 3], ids=["default", "key3"])
def test_init_params_equal_jax(key):
    jp = jpd.init_params(None if key is None else jax.random.PRNGKey(key))
    tp = tpd.init_params(None if key is None else prng.PRNGKey(key))
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].shape == jp[k].shape and tp[k].dtype == np.float32, k
        assert _ulp(tp[k], jp[k]) <= NORMAL_ULP, k


@pytest.mark.parametrize("nb_samples", [8, 32])
def test_segment_other_nb_samples_matches_jax(nb_samples):
    """`tps.segment` on the 64x128 scene with another RANSAC table size,
    held as tests/test_torch_depth_tps.py holds the default's."""
    H, W = 64, 128
    rgb, depth = scene()
    disp = np.asarray(jdepth.depth_to_disp(jnp.asarray(depth)))
    rj = jtps.segment(jnp.asarray(rgb), jnp.asarray(disp),
                      JTPSConfig(nb_samples=nb_samples))
    rt = ttps.segment(_t(rgb), _t(disp), TPSConfig(nb_samples=nb_samples))
    lj, lt = np.asarray(rj.labels), rt.labels.numpy()
    assert (lj == lt).mean() >= 0.99
    assert float(rt.stats.size.sum()) == H * W
    np.testing.assert_allclose(rt.inliers.float().mean().item(),
                               np.asarray(rj.inliers).mean(), atol=0.01)
    thj, tht = np.asarray(rj.stats.theta), rt.stats.theta.numpy()
    both = np.isfinite(thj[..., 2]) & np.isfinite(tht[..., 2])
    assert both.mean() > 0.9
    assert np.median(np.abs(thj[both] - tht[both])) < 1e-4


@pytest.mark.parametrize("which", ["similarity", "rigid"])
def test_ransac_other_seed_and_n_hyp_matches_jax(which):
    """Both RANSACs with a seed and a hypothesis count other than the
    defaults, against the JAX functions (the defaults' tolerances,
    tests/test_torch_flow.py)."""
    if which == "similarity":
        src, dst, ok = _correspondences(4, n_valid=200)
        kw = dict(n_hyp=64, seed=99)
        rj = jax.jit(lambda s, d, o: jflow.estimate_similarity_ransac(
            s, d, o, **kw))(jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(ok))
        rt = tflow.estimate_similarity_ransac(_t(src), _t(dst), _t(ok), **kw)
        assert bool(rt[4]) and bool(rj[4])
        for k, tol in enumerate((1e-4, 1e-4, 1e-3, 1e-3)):
            np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                       atol=tol)
        return
    src, dst, ok, xy = _rigid_pairs(5, n_valid=120)
    kw = dict(thresh=0.05, min_inliers=15, min_ratio=0.15, n_hyp=100,
              seed=2024)
    rj = jax.jit(lambda s, d, o, x: jlc.ransac_rigid_3d(
        s, d, o, src_xy=x, **kw))(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(ok), jnp.asarray(xy))
    rt = tlc.ransac_rigid_3d(_t(src), _t(dst), _t(ok), src_xy=_t(xy), **kw)
    assert bool(rt[2]) and bool(rj[2])
    assert int(rt[3]) == int(rj[3])
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), atol=1e-5)
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), atol=1e-5)

"""PyTorch port vs the JAX package: configuration, geometry and colour.

The same numpy inputs (seeded) go through both packages on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu.utils import color as jcolor
from supersurfel_fusion_tpu.utils import geometry as jgeo
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch.utils import color as tcolor
from supersurfel_fusion_tpu_torch.utils import geometry as tgeo

# One intra-op thread: the suite runs in several worker processes at once,
# and each process's OpenMP threads spinning against the others' made the
# torch tests about 20 times slower on an 8-core machine.
torch.set_num_threads(1)

_CLASSES = ["CameraIntrinsics", "TPSConfig", "ICPConfig", "FusionConfig",
            "GenerationConfig", "VOConfig", "MODConfig", "FernsConfig",
            "PipelineConfig"]


@pytest.mark.parametrize("name", _CLASSES)
def test_config_fields_and_defaults_equal(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
    assert jf == tf
    assert tc.__dataclass_params__.frozen
    # defaults, nested ones included, compare equal field by field
    assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())


def test_config_derived_and_cameras_equal():
    for cam in ("tum_fr1", "tum_fr2", "tum_fr3"):
        assert dataclasses.asdict(getattr(jcfg.CameraIntrinsics, cam)()) == \
            dataclasses.asdict(getattr(tcfg.CameraIntrinsics, cam)())
    j, t = jcfg.PipelineConfig(), tcfg.PipelineConfig()
    for prop in ("grid_w", "grid_h", "nb_superpixels", "conf_thresh"):
        assert getattr(j, prop) == getattr(t, prop)


def _spd(rng, n):
    """Symmetric PD 3x3 with well-separated eigenvalues."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    ev = np.stack([rng.uniform(2.0, 3.0, n), rng.uniform(0.5, 1.0, n),
                   rng.uniform(0.01, 0.1, n)], -1)
    return (Q * ev[:, None, :]) @ np.swapaxes(Q, -1, -2)


def _rot(rng, n):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-3.0, 3.0, n)
    return axis.astype(np.float32), angle.astype(np.float32)


def test_eigh3x3_matches_jax():
    rng = np.random.default_rng(0)
    A = _spd(rng, 64).astype(np.float32)
    vj, ej = jgeo.eigh3x3(jnp.asarray(A))
    vt, et = tgeo.eigh3x3(torch.from_numpy(A))
    # 10 trace-normalised squarings: f32 rounding differs by op order only
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)


def test_solve3x3_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A[0] = 0.0  # singular: ok=False, x=0
    b = rng.normal(size=(64, 3)).astype(np.float32)
    xj, okj = jgeo.solve3x3(jnp.asarray(A), jnp.asarray(b))
    xt, okt = tgeo.solve3x3(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-6)


def test_inv3x3_sym_matches_jax():
    rng = np.random.default_rng(2)
    A = _spd(rng, 64).astype(np.float32)
    A[0] = 0.0
    ij, okj = jgeo.inv3x3_sym(jnp.asarray(A))
    it, okt = tgeo.inv3x3_sym(torch.from_numpy(A))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6,
                               atol=1e-6)


def test_rotations_match_jax():
    rng = np.random.default_rng(3)
    axis, angle = _rot(rng, 64)
    Rj = jgeo.axis_angle_to_mat(jnp.asarray(axis), jnp.asarray(angle))
    Rt = tgeo.axis_angle_to_mat(torch.from_numpy(axis),
                                torch.from_numpy(angle))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=1e-6,
                               atol=1e-6)
    R = np.array(Rj)
    qj = jgeo.mat_to_quat(jnp.asarray(R))
    qt = tgeo.mat_to_quat(torch.from_numpy(R))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tgeo.quat_to_mat(qt).numpy(),
                               np.asarray(jgeo.quat_to_mat(qj)), rtol=1e-6,
                               atol=1e-6)
    # a perturbed rotation re-orthonormalised
    Rn = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.orthonormalize(torch.from_numpy(Rn)).numpy(),
        np.asarray(jgeo.orthonormalize(jnp.asarray(Rn))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("fn", ["rgb_to_lab", "lab_to_rgb", "rgb_to_gray"])
def test_color_matches_jax(fn):
    rng = np.random.default_rng(4)
    if fn == "lab_to_rgb":
        x = np.stack([rng.uniform(0, 100, 500), rng.uniform(-80, 80, 500),
                      rng.uniform(-80, 80, 500)], -1).astype(np.float32)
    else:
        x = rng.uniform(0, 255, (500, 3)).astype(np.float32)
    yj = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    yt = getattr(tcolor, fn)(torch.from_numpy(x)).numpy()
    # cbrt vs pow(x, 1/3) and the 2.4 power differ in the last bits: a few
    # f32 ulps of the 0..100 Lab range
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-4)

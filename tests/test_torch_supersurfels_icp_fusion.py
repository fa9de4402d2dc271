"""PyTorch port vs the JAX package: supersurfel generation, symmetric ICP
and the model update, on seeded numpy inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu.ops import fusion as jfusion
from supersurfel_fusion_tpu.ops import icp as jicp
from supersurfel_fusion_tpu.ops import supersurfels as jss
from supersurfel_fusion_tpu.ops import tps as jtps
from supersurfel_fusion_tpu.types import ModelState as JModelState
from supersurfel_fusion_tpu.types import Supersurfels as JSurfels
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.ops import fusion as tfusion
from supersurfel_fusion_tpu_torch.ops import icp as ticp
from supersurfel_fusion_tpu_torch.ops import supersurfels as tss
from supersurfel_fusion_tpu_torch.ops import tps as ttps
from supersurfel_fusion_tpu_torch.types import ModelState, Supersurfels

from test_icp import CAM as ICP_CAM
from test_icp import CS as ICP_CS
from test_icp import make_frame_and_model


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch_surfels(s):
    return Supersurfels(*(_t(a) for a in s))


def test_generate_supersurfels_matches_jax():
    cam = tcfg.CameraIntrinsics(fx=100.0, fy=100.0, cx=79.5, cy=63.5,
                                width=160, height=128)
    jcam = jcfg.CameraIntrinsics(**vars(cam))
    rgb, depth_u16 = synthetic.render(cam, *synthetic.trajectory(3)[2])
    rgb = rgb.astype(np.float32)
    depth = depth_u16.astype(np.float32) / 5000.0
    disp = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-12), np.inf)
    disp = disp.astype(np.float32)
    res = jtps.segment(jnp.asarray(rgb), jnp.asarray(disp),
                       jcfg.TPSConfig(nb_iters=2))
    gh, gw = 128 // 16, 160 // 16
    plane = jtps.render_plane_depth(res.stats.theta, res.labels, gh, gw, 16)
    fj = jss.generate_supersurfels(
        jnp.asarray(rgb), plane, res, jcam, jcfg.TPSConfig(),
        jcfg.GenerationConfig(), 0.2, 5.0, jnp.int32(7))
    tres = ttps.TPSResult(
        labels=_t(res.labels), boundary=_t(res.boundary),
        inliers=_t(res.inliers),
        stats=ttps.SuperpixelStats(*(_t(a) for a in res.stats)),
        disp=_t(res.disp))
    ft = tss.generate_supersurfels(
        _t(rgb), _t(plane), tres, cam, tcfg.TPSConfig(),
        tcfg.GenerationConfig(), 0.2, 5.0, torch.tensor(7, dtype=torch.int32))

    cj, ct = np.asarray(fj.confidences), ft.confidences.numpy()
    np.testing.assert_array_equal(ct, cj)
    ok = cj > 0
    assert ok.sum() > 20
    np.testing.assert_array_equal(ft.stamps.numpy(), np.asarray(fj.stamps))
    # moments summed in another order (one-hot contraction vs einsum)
    np.testing.assert_allclose(ft.positions.numpy()[ok],
                               np.asarray(fj.positions)[ok], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ft.colors.numpy()[ok],
                               np.asarray(fj.colors)[ok], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(ft.shapes.numpy()[ok],
                               np.asarray(fj.shapes)[ok], rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(ft.dims.numpy()[ok], np.asarray(fj.dims)[ok],
                               rtol=1e-3, atol=1e-7)
    # the normal (smallest-eigenvalue row) is well conditioned
    nj = np.asarray(fj.orientations)[ok, 2]
    nt = ft.orientations.numpy()[ok, 2]
    assert np.abs(np.sum(nj * nt, -1)).min() > 1 - 1e-5


def _icp_inputs(motion=True, noise=0.0):
    depth, labels, frame, fpos, fori = make_frame_and_model()
    n_sp = fpos.shape[0]
    C = 256
    mpos = np.zeros((C, 3), np.float32)
    mori = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    conf = np.full(C, -1.0, np.float32)
    mpos[:n_sp] = fpos
    mori[:n_sp] = fori
    conf[:n_sp] = np.where(np.asarray(frame.confidences) > 0, 10.0, -1.0)
    if motion:
        axis = np.array([0.2, 1.0, -0.3])
        axis /= np.linalg.norm(axis)
        c, s = np.cos(0.02), np.sin(0.02)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R_gt = (np.eye(3) + s * K + (1 - c) * K @ K).astype(np.float32)
        t_gt = np.array([0.01, -0.015, 0.02], np.float32)
        mpos[:n_sp] = mpos[:n_sp] @ R_gt.T + t_gt
        mori[:n_sp] = mori[:n_sp] @ R_gt.T
    mpos[:n_sp] += np.random.default_rng(5).normal(0, noise, (n_sp, 3))
    model = JSurfels.empty(C)._replace(
        positions=jnp.asarray(mpos), orientations=jnp.asarray(mori),
        colors=jnp.full((C, 3), 128.0), confidences=jnp.asarray(conf))
    tm = jicp.build_target_maps(frame, labels, jnp.asarray(depth, jnp.float32),
                                ICP_CAM, ICP_CS, 0.2, 10.0)
    return frame, labels, depth, model, n_sp, tm


def test_build_target_maps_matches_jax():
    frame, labels, depth, _, _, tmj = _icp_inputs()
    tmt = ticp.build_target_maps(
        _to_torch_surfels(frame), _t(labels), _t(np.asarray(depth, np.float32)),
        tcfg.CameraIntrinsics(**vars(ICP_CAM)), ICP_CS, 0.2, 10.0)
    # Lab a/b = 500 (fx - fy): cbrt rounding differences are amplified to a
    # few 1e-5 near grey
    np.testing.assert_allclose(tmt.numpy(), np.asarray(tmj), rtol=1e-5,
                               atol=1e-4)


def _icp_both(model, n_sp, tm, **cfg_kw):
    eye = np.eye(3, dtype=np.float32)
    zero = np.zeros(3, np.float32)
    rt = ticp.symmetric_icp(
        _to_torch_surfels(model), torch.tensor(n_sp, dtype=torch.int32),
        _t(tm), _t(eye), _t(zero), tcfg.CameraIntrinsics(**vars(ICP_CAM)),
        tcfg.ICPConfig(**cfg_kw))
    rj = jicp.symmetric_icp(model, jnp.int32(n_sp), tm, jnp.eye(3),
                            jnp.zeros(3), ICP_CAM, jcfg.ICPConfig(**cfg_kw))
    return rt, rj


def test_symmetric_icp_matches_jax():
    """R, t, valid, code, cov_diag, inliers and error (default damping)."""
    _, _, _, model, n_sp, tm = _icp_inputs()
    rt, rj = _icp_both(model, n_sp, tm, max_dist=0.2, cov_thresh=1.0,
                       min_inliers=50.0)
    assert bool(rt.valid) and bool(rj.valid)
    assert int(rt.code) == int(rj.code) == 15
    np.testing.assert_allclose(rt.R_rel.numpy(), np.asarray(rj.R_rel),
                               atol=2e-6)
    np.testing.assert_allclose(rt.t_rel.numpy(), np.asarray(rj.t_rel),
                               atol=2e-6)
    # 6x6 normal equations summed in another order
    np.testing.assert_allclose(rt.cov_diag.numpy(), np.asarray(rj.cov_diag),
                               rtol=1e-3)
    assert float(rt.inliers) == float(rj.inliers)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-3)


def _jax_iteration_count(model, n_sp, tm, cfg):
    """The trip count of the JAX `lax.while_loop`, replayed eagerly with the
    JAX package's own loop body pieces and exit condition."""
    from supersurfel_fusion_tpu.utils.color import rgb_to_lab

    ids = jnp.arange(model.capacity)
    mask = (ids < n_sp) & (model.confidences > 0.0)
    lab = rgb_to_lab(model.colors)
    normal = model.orientations[:, 2, :]
    R_inc, t_inc = jnp.eye(3), jnp.zeros(3)
    prev, it, cont = np.finfo(np.float32).max, 0, True
    while cont and it < cfg.nb_iters:
        JtJ, Jtr, r, inl = jicp._build_system(
            model.positions, normal, lab, mask, tm, R_inc, t_inc, ICP_CAM,
            cfg)
        err = float(jnp.sqrt(r / jnp.maximum(inl, 1.0)))
        enough = float(inl) >= cfg.min_inliers
        Xp, _, _ = jicp._precond_solve(JtJ, Jtr,
                                       abs_damping=cfg.solve_damping)
        Xp = jnp.where(jnp.isfinite(Xp), Xp, 0.0)
        R_it, t_it = jicp._apply_solution(Xp)
        if enough:
            R_inc, t_inc = R_it @ R_inc, R_it @ t_inc + t_it
        cont = enough and err / max(prev, 1e-20) <= cfg.rel_error_break
        prev = err
        it += 1
    return it


def test_symmetric_icp_iteration_count_matches_jax():
    """The masked fixed-length loop runs as many Gauss-Newton steps as the
    JAX while_loop. Undamped, on noisy points, the error stalls at the
    noise level within the cap, far above f32 rounding."""
    _, _, _, model, n_sp, tm = _icp_inputs(noise=0.003)
    kw = dict(nb_iters=40, max_dist=0.2, cov_thresh=1.0, min_inliers=50.0,
              solve_damping=0.0)
    rt, rj = _icp_both(model, n_sp, tm, **kw)
    n = int(rt.iters)
    assert 0 < n < 40
    assert n == _jax_iteration_count(model, n_sp, tm, jcfg.ICPConfig(**kw))
    np.testing.assert_allclose(rt.R_rel.numpy(), np.asarray(rj.R_rel),
                               atol=2e-6)
    np.testing.assert_allclose(rt.t_rel.numpy(), np.asarray(rj.t_rel),
                               atol=2e-6)


def test_symmetric_icp_invalid_without_inliers():
    frame, labels, depth, _, _, tm = _icp_inputs(motion=False)
    rt = ticp.symmetric_icp(
        Supersurfels.empty(64, "cpu"), torch.tensor(0, dtype=torch.int32),
        _t(tm), torch.eye(3), torch.zeros(3),
        tcfg.CameraIntrinsics(**vars(ICP_CAM)), tcfg.ICPConfig())
    rj = jicp.symmetric_icp(JSurfels.empty(64), jnp.int32(0), tm, jnp.eye(3),
                            jnp.zeros(3), ICP_CAM, jcfg.ICPConfig())
    assert not bool(rt.valid) and int(rt.code) == int(rj.code)
    assert float(rt.inliers) == 0.0 and int(rt.iters) == 1


# --- model update ----------------------------------------------------------

_H, _W, _CS = 64, 96, 16
_FCAM = dict(fx=80.0, fy=80.0, cx=47.5, cy=31.5, width=_W, height=_H)


def _frame(rng, z, jitter, conf, stamp):
    """One surfel per grid cell, at the cell centre's ray at depth z, with a
    flat (well-conditioned) covariance so the inverse-covariance blend is
    stable."""
    gh, gw = _H // _CS, _W // _CS
    n = gh * gw
    gy, gx = np.mgrid[0:gh, 0:gw].reshape(2, -1)
    u = gx * _CS + (_CS - 1) / 2.0
    v = gy * _CS + (_CS - 1) / 2.0
    pos = np.stack([(u - _FCAM["cx"]) * z / _FCAM["fx"],
                    (v - _FCAM["cy"]) * z / _FCAM["fy"],
                    np.full(n, z)], -1)
    pos = pos + rng.normal(0, jitter, pos.shape)
    shapes = np.zeros((n, 3, 3))
    shapes[:, 0, 0] = rng.uniform(1e-3, 2e-3, n)
    shapes[:, 1, 1] = rng.uniform(3e-4, 8e-4, n)
    shapes[:, 2, 2] = rng.uniform(1e-5, 2e-5, n)
    ori = np.tile(np.eye(3), (n, 1, 1))
    dims = np.stack([shapes[:, 0, 0], shapes[:, 1, 1]], -1)
    colors = np.full((n, 3), 128.0) + rng.normal(0, 2, (n, 3))
    return JSurfels(
        positions=jnp.asarray(pos, jnp.float32),
        colors=jnp.asarray(colors, jnp.float32),
        stamps=jnp.full((n, 2), stamp, jnp.int32),
        orientations=jnp.asarray(ori, jnp.float32),
        shapes=jnp.asarray(shapes, jnp.float32),
        dims=jnp.asarray(dims, jnp.float32),
        confidences=jnp.asarray(conf, jnp.float32))


def test_update_model_sequence_matches_jax():
    """Bootstrap, fusion, insertion, stale and free-space eviction and the
    stable compaction over five updates; the whole model SoA is held."""
    rng = np.random.default_rng(11)
    jcam = jcfg.CameraIntrinsics(**_FCAM)
    tcam = tcfg.CameraIntrinsics(**_FCAM)
    fcj = jcfg.FusionConfig(nb_supersurfels_max=64, visible_cap=48,
                            delta_t=2)
    fct = tcfg.FusionConfig(nb_supersurfels_max=64, visible_cap=48,
                            delta_t=2)
    n = (_H // _CS) * (_W // _CS)
    labels = ((np.mgrid[0:_H, 0:_W][0] // _CS) * (_W // _CS)
              + np.mgrid[0:_H, 0:_W][1] // _CS).astype(np.int32)
    js = JModelState(JSurfels.empty(64), jnp.int32(0), jnp.int32(0))
    ts = ModelState(Supersurfels.empty(64, "cpu"),
                    torch.tensor(0, dtype=torch.int32),
                    torch.tensor(0, dtype=torch.int32))
    R = np.eye(3, dtype=np.float32)
    for k in range(5):
        z = 1.5 + 0.5 * (k % 2)          # alternate depths: fuse / insert
        conf = rng.uniform(20, 60, n) * (rng.random(n) < 0.85) - 1.0 * (
            rng.random(n) < 0.1)
        frame = _frame(rng, z, 0.004, conf, k)
        plane = np.full((_H, _W), 1.9 if k == 3 else 3.0, np.float32)
        t = np.array([0.002 * k, 0.0, 0.0], np.float32)
        js, jstat = jfusion.update_model(
            js, frame, jnp.asarray(labels), jnp.asarray(plane),
            jnp.asarray(R), jnp.asarray(t), jcam, fcj, 2000.0, jnp.int32(k))
        ts, tstat = tfusion.update_model(
            ts, _to_torch_surfels(frame), _t(labels), _t(plane), _t(R),
            _t(t), tcam, fct, 2000.0, torch.tensor(k, dtype=torch.int32))
        assert [int(a) for a in tstat] == [int(a) for a in jstat], k
        assert int(ts.nb_supersurfels) == int(js.nb_supersurfels)
        assert int(ts.nb_visible) == int(js.nb_visible)
        for f in JSurfels._fields:
            a = np.asarray(getattr(js.surfels, f))
            b = getattr(ts.surfels, f).numpy()
            if a.dtype.kind in "ib":
                np.testing.assert_array_equal(b, a, err_msg=f)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                           err_msg=f)
        # carry the JAX state forward so rounding cannot accumulate
        ts = ModelState(_to_torch_surfels(js.surfels),
                        _t(js.nb_supersurfels), _t(js.nb_visible))

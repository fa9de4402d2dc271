"""PyTorch port vs the JAX package: the keyframe store and the whole
loop-closure branch (`close_global_loop`), the latter on the inputs the
JAX frame step hands it when its fern gate fires on the revisit clip."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu import pipeline as jpipe
from supersurfel_fusion_tpu.ops import deformation as jdefo
from supersurfel_fusion_tpu.ops import loop_closure as jlc
from supersurfel_fusion_tpu.ops.features import Keypoints as JKeypoints
from supersurfel_fusion_tpu.types import Pose as JPose
from supersurfel_fusion_tpu.types import Supersurfels as JSurfels
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch.ops import loop_closure as tlc
from supersurfel_fusion_tpu_torch.ops.features import Keypoints as TKeypoints
from supersurfel_fusion_tpu_torch.types import Pose as TPose
from supersurfel_fusion_tpu_torch.types import Supersurfels as TSurfels

from test_torch_pipeline import _rot_angle

torch.set_num_threads(1)

T = torch.from_numpy
# the frame of the revisit clip on which the gate fires in `lc_config`,
# and the closure is accepted (JAX package, CPU)
GATE_FRAME = 27


def lc_config(C, loop_closure: bool = True):
    """The loop-closure test configuration: 320x240 (half the fr1 camera),
    300 superpixels, 512 features, two TPS iterations, a 4096-surfel
    model, a 16-keyframe store and the revisit test's `min_frame_gap=8`.
    At 256x192 the revisit's alignment finds fewer than the 50 ICP inliers
    a closure needs; at this size the JAX package accepts the closure of
    frame 27."""
    return C.PipelineConfig(
        cam=C.CameraIntrinsics(fx=262.5, fy=262.5, cx=159.5, cy=119.5,
                               width=320, height=240),
        tps=C.TPSConfig(nb_iters=2, filter_iter=1),
        icp=C.ICPConfig(min_inliers=20.0),
        fusion=C.FusionConfig(nb_supersurfels_max=4096, visible_cap=2048),
        vo=C.VOConfig(nb_features=512, nb_levels=2, local_map_capacity=1024,
                      detect_cell=16),
        max_frames=40, enable_loop_closure=loop_closure,
        ferns=C.FernsConfig(enabled=True, min_frame_gap=8, max_keyframes=16))


def _surfels(s):
    return TSurfels(*(T(np.array(getattr(s, f))) for f in TSurfels._fields))


def _keypoints(kp):
    return TKeypoints(*(T(np.array(getattr(kp, f)).view(np.int32)
                          if f == "desc" else np.array(getattr(kp, f)))
                        for f in TKeypoints._fields))


def test_add_keyframe_payload_exact():
    """Five snapshots into a 3-keyframe store (two past capacity), and a
    masked one: every field equals JAX's."""
    rng = np.random.default_rng(2)
    K, KP, F = 3, 40, 24
    js = jlc.KeyframeStore.empty(K, 50, KP, F)
    ts = tlc.KeyframeStore.empty(K, 50, KP, F, "cpu")
    for k in range(5):
        codes = rng.integers(0, 16, 50).astype(np.uint8)
        R = synthetic.axis_angle(rng.normal(size=3), 0.3).astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        kp = dict(xy=rng.uniform(0, 300, (KP, 2)).astype(np.float32),
                  level=rng.integers(0, 2, KP).astype(np.int32),
                  angle=rng.normal(size=KP).astype(np.float32),
                  score=rng.random(KP).astype(np.float32),
                  valid=rng.random(KP) > 0.3,
                  desc=rng.integers(0, 2**32, (KP, 8), dtype=np.uint32))
        p3d = rng.normal(size=(KP, 3)).astype(np.float32)
        dok = rng.random(KP) > 0.2
        fr = dict(positions=rng.normal(size=(F, 3)),
                  colors=rng.uniform(0, 255, (F, 3)),
                  orientations=rng.normal(size=(F, 3, 3)),
                  confidences=rng.normal(size=F))
        fr = {k2: v.astype(np.float32) for k2, v in fr.items()}
        jf = JSurfels.empty(F)._replace(**{k2: jnp.asarray(v)
                                           for k2, v in fr.items()})
        tf = TSurfels.empty(F, "cpu")._replace(**{k2: T(v)
                                                  for k2, v in fr.items()})
        js = jlc.add_keyframe_payload(
            js, jnp.asarray(codes), JPose(jnp.asarray(R), jnp.asarray(t)),
            jnp.int32(k), JKeypoints(**{k2: jnp.asarray(v)
                                        for k2, v in kp.items()}),
            jnp.asarray(p3d), jnp.asarray(dok), jf)
        ts = tlc.add_keyframe_payload(
            ts, T(codes), TPose(T(R), T(t)),
            torch.tensor(k, dtype=torch.int32),
            _keypoints(JKeypoints(**kp)), T(p3d), T(dok), tf)
        back = convert.keyframe_store_from_numpy(
            jax.tree.map(np.asarray, js), "cpu")
        for a, b, name in zip(jax.tree.leaves(back), jax.tree.leaves(ts),
                              ["db." + f for f in jlc.FernDB._fields]
                              + list(tlc.KeyframeStore._fields[1:])):
            assert a.dtype == b.dtype, name
            assert torch.equal(a, b), (k, name)
    assert int(ts.db.count) == K
    masked = tlc.add_keyframe_payload(
        tlc.KeyframeStore.empty(K, 50, KP, F, "cpu"), T(codes),
        TPose(T(R), T(t)), torch.tensor(9, dtype=torch.int32),
        _keypoints(JKeypoints(**kp)), T(p3d), T(dok), tf,
        when=torch.tensor(False))
    for a, b in zip(jax.tree.leaves(masked),
                    jax.tree.leaves(tlc.KeyframeStore.empty(K, 50, KP, F,
                                                            "cpu"))):
        assert torch.equal(a, b)


def capture_closure(cfg, clip, monkeypatch):
    """Run the JAX frame step over `clip` and return the inputs and result
    of every `close_global_loop` it runs, as numpy trees."""
    captured = []
    orig = jlc.close_global_loop

    def capturing(*args, **kw):
        res = orig(*args, **kw)
        jax.debug.callback(
            lambda a, r: captured.append(jax.tree.map(np.array, (a, r))),
            args[:11], res)
        return res

    monkeypatch.setattr(jlc, "close_global_loop", capturing)

    # a fresh trace of the frame step, so the patched branch is the one
    # compiled
    def step(st, rgb, depth):
        with jax.default_matmul_precision("float32"):
            return jpipe._process_frame_impl(
                st, rgb.astype(jnp.float32),
                depth.astype(jnp.float32) * cfg.depth_scale, cfg)

    step = jax.jit(step)
    st = jpipe.init_state(cfg)
    for rgb, depth, _ in clip:
        st, _ = step(st, jnp.asarray(rgb), jnp.asarray(depth))
    jax.block_until_ready(st)
    return captured, st


def _constraint_nodes(args, jres, jg):
    """The graph nodes the closure's constraints bind to, rebuilt from the
    branch's inputs as `close_global_loop` builds them (an accepted
    closure's pose is the loop-corrected one)."""
    store, best_id, _, _, frame, _, _, _, _, pose, stamp = args
    F = frame.positions.shape[0]
    sel = np.arange(0, F, max(F // 50, 1))[:50]
    p = frame.positions[sel]
    ok = frame.confidences[sel] > 0
    src = p @ pose.R.T + pose.t
    tgt = p @ jres.pose.R.T + jres.pose.t
    con_stamp = np.concatenate([np.full(50, int(stamp)),
                                np.full(50, store.db.stamps[int(best_id)])])
    b = jdefo.bind_vertices(jg, jnp.asarray(np.concatenate([src, tgt])
                                            .astype(np.float32)),
                            jnp.asarray(con_stamp.astype(np.int32)),
                            jnp.asarray(np.concatenate([ok, ok])))
    return np.unique(np.asarray(b.nodes)[np.concatenate([ok, ok])])


def test_close_global_loop_matches_jax(monkeypatch):
    """The branch on JAX's own inputs at the gate-firing frame.

    `accepted` equal and the pose within 1e-4 m and 1e-4 rad. The deformed
    model: in f32 the graph's normal equations round as much as their
    damping, which leaves the nodes far in time from both constraint sets
    at the mercy of rounding (ROADMAP Queue 3: on this closure JAX's node
    translations lie up to 0.18 m from an f64 solve, which the port
    does). So positions are held within 5e-4 m on the surfels bound only
    to the nodes the constraints bind, which both solves determine; the
    other fields exactly, and the keyframe pose at the constrained
    keyframe within 1e-4."""
    jc, tc = lc_config(jcfg), lc_config(tcfg)
    clip = synthetic.revisit_frames(tc.cam)[:GATE_FRAME + 1]
    captured, _ = capture_closure(jc, clip, monkeypatch)
    assert len(captured) == 1
    args, jres = captured[0]
    (store, best_id, model, nb, frame, kp, kp_p3d, kp_ok, tmaps, pose,
     stamp) = args
    assert int(stamp) == GATE_FRAME and bool(jres.accepted)
    tres = tlc.close_global_loop(
        convert.keyframe_store_from_numpy(store, "cpu"), T(best_id),
        _surfels(model), T(nb), _surfels(frame), _keypoints(kp), T(kp_p3d),
        T(kp_ok), T(tmaps), TPose(T(pose.R), T(pose.t)), T(stamp), tc.cam,
        tc.icp)
    assert bool(tres.accepted) == bool(jres.accepted)
    assert np.abs(tres.pose.t.numpy() - jres.pose.t).max() <= 1e-4
    assert _rot_angle(tres.pose.R.numpy(), jres.pose.R) <= 1e-4

    n = int(nb)
    live = (np.arange(len(model.confidences)) < n) \
        & (model.confidences > 0)
    jg = jdefo.build_graph(jnp.asarray(model.positions),
                           jnp.asarray(model.stamps[:, 0]), None,
                           jnp.int32(n))
    vb = jdefo.bind_vertices(jg, jnp.asarray(model.positions),
                             jnp.asarray(model.stamps[:, 0]),
                             jnp.asarray(live))
    determined = live & np.isin(np.asarray(vb.nodes),
                                _constraint_nodes(args, jres, jg)).all(-1)
    assert determined.sum() >= 100, determined.sum()
    np.testing.assert_allclose(tres.model.positions.numpy()[determined],
                               jres.model.positions[determined], atol=5e-4)
    # the closure moved those surfels: the comparison is not of a no-op
    moved = np.abs(jres.model.positions[determined]
                   - model.positions[determined]).max()
    assert moved > 5e-3, moved
    for f in ("positions", "orientations", "shapes"):
        np.testing.assert_array_equal(getattr(tres.model, f).numpy()[~live],
                                      getattr(jres.model, f)[~live])
    for f in ("colors", "stamps", "dims", "confidences"):
        np.testing.assert_array_equal(getattr(tres.model, f).numpy(),
                                      getattr(jres.model, f), err_msg=f)
    assert np.isfinite(tres.model.positions.numpy()).all()
    k0 = int(best_id)
    np.testing.assert_allclose(tres.kf_poses_t.numpy()[k0],
                               jres.kf_poses_t[k0], atol=1e-4)
    np.testing.assert_allclose(tres.kf_poses_R.numpy()[k0],
                               jres.kf_poses_R[k0], atol=1e-4)
    kf_live = np.arange(len(store.db.stamps)) < int(store.db.count)
    np.testing.assert_array_equal(tres.kf_poses_t.numpy()[~kf_live],
                                  jres.kf_poses_t[~kf_live])

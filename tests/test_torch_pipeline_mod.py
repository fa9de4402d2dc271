"""PyTorch port vs the JAX package: the MOD frame step (bench's fr3
configuration: moving-object detection with the person detector) at
256x192 on the synthetic dynamic clip, each frame started from the JAX
state carried over, plus the MOD options of the entry points."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu import pipeline as jpipe
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch import pipeline as tpipe
from supersurfel_fusion_tpu_torch.ops.features import keypoint_capacity
from supersurfel_fusion_tpu_torch.parallel.pipeline_sharded import (
    check_supported as check_sharded,
)

from test_torch_motion import MOVER_STEP, WEIGHTS, mod_config
from test_torch_pipeline import _rot_angle, small_config


def _state_np(state):
    return jax.tree.map(np.array, state)


@pytest.mark.parametrize("yolo", [True, False], ids=["combined", "simple"])
def test_mod_frame_step_matches_jax(yolo):
    """Four dynamic frames; from the third on the mover is detected.
    Poses within 1e-3 m and 1e-3 rad and static_sp exact; nb_supersurfels
    exact but where the known fusion fault decides it."""
    jc = mod_config(jcfg, yolo)
    tc = mod_config(tcfg, yolo)
    clip = synthetic.dynamic_frames(tc.cam, 4, step=MOVER_STEP)
    js = jpipe.init_state(jc)
    n_dyn = n_icp = n_fuse_fault = 0
    for k, (rgb, depth, _, mover) in enumerate(clip):
        ts = convert.state_from_jax_numpy(_state_np(js), device="cpu")
        assert (ts.detector is not None) == yolo
        js, jo = jpipe.process_frame(js, jnp.asarray(rgb), jnp.asarray(depth),
                                     jc)
        ts, to = tpipe.process_frame(ts, rgb, depth, tc)
        np.testing.assert_array_equal(to.static_sp.numpy(),
                                      np.asarray(jo.static_sp), err_msg=str(k))
        nb_t, nb_j = int(to.nb_supersurfels), int(jo.nb_supersurfels)
        if nb_t != nb_j:
            # the open fault of ROADMAP Queue 3 (`fusion._fuse`, both
            # packages): the inverse-covariance blend of plane-rendered
            # covariances throws fused surfels kilometres off the scene,
            # where f32 rounding alone decides their free-space test. The
            # count may differ by no more than the JAX model holds of them
            pos = np.asarray(js.model.surfels.positions)[:nb_j]
            thrown = int((np.abs(pos).max(axis=1) > 100.0).sum())
            assert abs(nb_t - nb_j) <= thrown, (k, nb_t, nb_j, thrown)
            n_fuse_fault += 1
        assert np.abs(to.pose.t.numpy() - np.asarray(jo.pose.t)).max() \
            <= 1e-3, k
        assert _rot_angle(to.pose.R.numpy(), np.asarray(jo.pose.R)) \
            <= 1e-3, k
        assert bool(to.icp_valid) == bool(jo.icp_valid), k
        assert bool(to.vo_valid) == bool(jo.vo_valid), k
        n_dyn += int((~np.asarray(jo.static_sp)).sum())
        n_icp += bool(jo.icp_valid)
        if k >= 2:
            s = synthetic.mover_scores(np.asarray(jo.labels),
                                       np.asarray(jo.static_sp), mover)
            assert s["mover_dynamic"] > 0, (k, s)
    assert n_dyn > 0 and n_icp >= 2
    assert n_fuse_fault <= 1


def test_keypoint_capacity_matches_jax():
    for cfg in (small_config(jcfg), jcfg.PipelineConfig(),
                jcfg.PipelineConfig(vo=jcfg.VOConfig(detect_cell=16))):
        js = jax.eval_shape(lambda: jpipe.init_state(cfg))
        tv = tcfg.VOConfig(**vars(cfg.vo))
        assert keypoint_capacity(tv, cfg.cam.height, cfg.cam.width) \
            == js.mod_prev.kp_xy.shape[0]


def test_mod_options_of_the_entry_points():
    base = small_config(tcfg)
    # use_yolo without weights runs the simple path
    s = tpipe.init_state(dataclasses.replace(
        base, mod=tcfg.MODConfig(enabled=True, use_yolo=True)), device="cpu")
    assert s.detector is None
    # named weights that are not there raise
    missing = tcfg.MODConfig(enabled=True, use_yolo=True,
                             weights_path=WEIGHTS + ".absent")
    with pytest.raises(FileNotFoundError):
        tpipe.init_state(dataclasses.replace(base, mod=missing), device="cpu")
    # the default-off options run (their parity:
    # test_torch_pipeline_options.py); the sharded step refuses the
    # insertion gate, which the JAX package's sharded step lacks
    for kw in (dict(mod=tcfg.MODConfig(enabled=True, temporal_heat=True)),
               dict(fusion=tcfg.FusionConfig(freeze_on_tracking_loss=True)),
               dict(fusion=tcfg.FusionConfig(insert_requires_icp=True))):
        cfg = dataclasses.replace(base, **kw)
        s = tpipe.init_state(cfg, device="cpu")
        s, out = tpipe.process_frame(s, *synthetic.frames(cfg.cam, 1)[0][:2],
                                     cfg)
        assert int(out.nb_supersurfels) > 0
        if cfg.fusion.insert_requires_icp:
            with pytest.raises(NotImplementedError):
                check_sharded(cfg)
        else:
            check_sharded(cfg)


def test_runner_warns_past_max_frames():
    cfg = dataclasses.replace(small_config(tcfg), max_frames=2)
    slam = tpipe.SupersurfelFusion(cfg, device="cpu")
    frames = synthetic.frames(cfg.cam, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for k, (rgb, depth, _) in enumerate(frames[:2]):
            slam.process(rgb, depth, timestamp=float(k))
    with pytest.warns(UserWarning, match="max_frames"):
        slam.process(*frames[2][:2], timestamp=2.0)
    assert len(slam.trajectory) == 3

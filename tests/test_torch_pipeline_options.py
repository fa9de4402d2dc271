"""PyTorch port vs the JAX package: the frame step's default-off options,
each on an input where it changes the result.

* `fusion.freeze_on_tracking_loss` and `fusion.insert_requires_icp` on
  a frame whose ICP is gate-rejected: the third frame of the static clip
  with its colours inverted (the geometry is unchanged, but no ICP
  correspondence passes the colour gate and no descriptor matches), in
  the default step at 256x192 and, for the freeze, in the sharded step on
  2 ranks at 128x96;
* `mod.temporal_heat` in the MOD frame step on the dynamic clip, where
  the heat keeps superpixels dynamic that the frame's cues no longer
  mark;
* the sharded step's broadcast of rank 0's MOD decision and heat.

Every frame both packages start from the JAX state carried over."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu import pipeline as jpipe
from supersurfel_fusion_tpu.parallel.mesh import make_mesh
from supersurfel_fusion_tpu.parallel.pipeline_sharded import (
    init_sharded_state,
    make_process_frame_sharded,
)
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch import pipeline as tpipe
from supersurfel_fusion_tpu_torch.parallel.distributed import launch

import torch_parallel_ranks
from test_torch_motion import MOVER_STEP, mod_config
from test_torch_pipeline import _rot_angle, small_config
from test_torch_pipeline_sharded import (
    D,
    _thrown,
    scene_frames,
    sharded_config,
)

torch.set_num_threads(1)

OPTIONS = {"freeze": dict(freeze_on_tracking_loss=True),
           "gate": dict(insert_requires_icp=True)}


def _state_np(state):
    return jax.tree.map(np.array, state)


def _with_fusion(cfg, **kw):
    return dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion,
                                                               **kw))


def rejected_clip(cam):
    """Three frames of the static clip, the third with inverted colours."""
    clip = [(rgb, depth) for rgb, depth, _ in synthetic.frames(cam, 3)]
    clip[2] = (255 - clip[2][0], clip[2][1])
    return clip


@pytest.mark.parametrize("option", ["freeze", "gate"])
def test_fusion_option_on_an_icp_rejected_frame_matches_jax(option):
    """Poses within 1e-3 m / 1e-3 rad, ICP's verdict, the model's count
    and the fusion stats exact. On the rejected frame the freeze leaves
    the model as it was (every surfel bit for bit) with zero stats, and
    the gate inserts nothing, where the default step inserts."""
    jc = _with_fusion(small_config(jcfg), **OPTIONS[option])
    tc = _with_fusion(small_config(tcfg), **OPTIONS[option])
    js = jpipe.init_state(jc)
    for k, (rgb, depth) in enumerate(rejected_clip(tc.cam)):
        ts = convert.state_from_jax_numpy(_state_np(js), device="cpu")
        js, jo = jpipe.process_frame(js, jnp.asarray(rgb), jnp.asarray(depth),
                                     jc)
        ts_new, to = tpipe.process_frame(ts, rgb, depth, tc)
        assert np.abs(to.pose.t.numpy() - np.asarray(jo.pose.t)).max() \
            <= 1e-3, k
        assert _rot_angle(to.pose.R.numpy(), np.asarray(jo.pose.R)) \
            <= 1e-3, k
        assert bool(to.icp_valid) == bool(jo.icp_valid), k
        for f in ("nb_supersurfels", "n_fused", "n_inserted", "n_removed"):
            assert int(getattr(to, f)) == int(getattr(jo, f)), (k, f)
        assert bool(jo.icp_valid) == (k == 1), k
    # the rejected frame, and the default step on the same state
    _, plain = tpipe.process_frame(ts, rgb, depth, small_config(tcfg))
    assert int(plain.n_inserted) > 0
    assert int(to.n_inserted) == 0
    if option == "freeze":
        assert int(to.n_fused) == int(to.n_removed) == 0
        for a, b in zip(ts_new.model.surfels, ts.model.surfels):
            assert torch.equal(a, b)
        assert int(ts_new.model.nb_supersurfels) \
            == int(ts.model.nb_supersurfels)
    else:
        assert int(to.n_fused) == int(plain.n_fused)


def test_mod_step_with_temporal_heat_matches_jax():
    """The MOD frame step (combined path) with `mod.temporal_heat` over
    six dynamic frames: static_sp exact, poses within 1e-3 m / 1e-3 rad,
    the carried heat within 1e-5 (the similarity's recorded tolerance,
    see test_torch_motion.py); on later frames the heat keeps
    superpixels dynamic."""
    jc = mod_config(jcfg, True)
    jc = dataclasses.replace(jc, mod=dataclasses.replace(jc.mod,
                                                         temporal_heat=True))
    base = mod_config(tcfg, True)
    tc = dataclasses.replace(base, mod=dataclasses.replace(
        base.mod, temporal_heat=True))
    clip = synthetic.dynamic_frames(tc.cam, 6, step=MOVER_STEP)
    js = jpipe.init_state(jc)
    n_kept = 0
    for k, (rgb, depth, _, _) in enumerate(clip):
        ts = convert.state_from_jax_numpy(_state_np(js), device="cpu")
        js, jo = jpipe.process_frame(js, jnp.asarray(rgb), jnp.asarray(depth),
                                     jc)
        ts_new, to = tpipe.process_frame(ts, rgb, depth, tc)
        np.testing.assert_array_equal(to.static_sp.numpy(),
                                      np.asarray(jo.static_sp), err_msg=str(k))
        np.testing.assert_allclose(ts_new.mod_prev.heat.numpy(),
                                   np.asarray(js.mod_prev.heat), rtol=0,
                                   atol=1e-5, err_msg=str(k))
        assert np.abs(to.pose.t.numpy() - np.asarray(jo.pose.t)).max() \
            <= 1e-3, k
        assert _rot_angle(to.pose.R.numpy(), np.asarray(jo.pose.R)) \
            <= 1e-3, k
        _, off = tpipe.process_frame(ts, rgb, depth, base)
        n_kept += int((~to.static_sp & off.static_sp).sum())
    assert float(js.mod_prev.heat.max()) == 1.0 and n_kept > 0


def _jax_sharded(cfg, frames):
    mesh = make_mesh(D)
    step = make_process_frame_sharded(mesh, cfg)
    state = init_sharded_state(cfg, mesh)
    states, outs = [], []
    for rgb, depth in frames:
        states.append(jax.tree.map(np.asarray, jax.device_get(state)))
        state, pose, nb = step(state, jnp.asarray(rgb), jnp.asarray(depth))
        outs.append((np.asarray(pose.t), int(nb)))
    return states, outs


def test_sharded_freeze_on_an_icp_rejected_frame_matches_jax():
    """`fusion.freeze_on_tracking_loss` in the sharded step on 2 ranks,
    each frame from JAX's 2-device state: the ranks bit-equal, poses
    within 1e-3 m and the model's total exact but where the known `_fuse`
    fault decides it (test_torch_pipeline_sharded.py's allowance); on the
    rejected frame (the third, colours inverted) the total stays, where
    without the option it grows."""
    if len(jax.devices()) < D:
        pytest.skip("needs 2 JAX devices")
    frames = scene_frames()
    frames[2] = (255.0 - frames[2][0], frames[2][1])
    states, jouts = _jax_sharded(
        _with_fusion(sharded_config(jcfg), freeze_on_tracking_loss=True),
        frames)
    runs = {}
    for name, kw in (("freeze", dict(freeze_on_tracking_loss=True)),
                     ("plain", {})):
        runs[name] = launch(torch_parallel_ranks.pipeline_steps, D, "gloo",
                            "cpu", args=(_with_fusion(sharded_config(tcfg),
                                                      **kw), frames, states))
    for k, (jt, jnb) in enumerate(jouts):
        r0, r1 = (r["carried"][k] for r in runs["freeze"])
        np.testing.assert_array_equal(r0["t"], r1["t"])
        assert r0["nb_total"] == r1["nb_total"], k
        assert np.abs(r0["t"] - jt).max() <= 1e-3, k
        thrown = _thrown(states[k + 1]) if k + 1 < len(states) else 0
        assert abs(r0["nb_total"] - jnb) <= thrown, (k, r0["nb_total"], jnb)
    frozen = runs["freeze"][0]["carried"]
    assert not frozen[2]["icp_valid"] and frozen[1]["icp_valid"]
    assert jouts[2][1] == jouts[1][1]
    # from JAX's state after frame 1 the frozen step keeps JAX's total
    assert frozen[2]["nb_total"] == jouts[1][1]
    assert runs["plain"][0]["carried"][2]["nb_total"] > jouts[1][1]


def test_sharded_ranks_take_rank0_mod_decision_and_heat():
    """The sharded step's MOD agreement on 2 ranks: each rank passes its
    own values and both get rank 0's, the f32 heat bit for bit."""
    out = launch(torch_parallel_ranks.rank0_agreement, D, "gloo", "cpu")
    for r in out:
        np.testing.assert_array_equal(r["static_sp"], out[0]["mine_sp"])
        np.testing.assert_array_equal(r["static_kp"], out[0]["mine_kp"])
        assert r["heat"].tobytes() == out[0]["mine_heat"].tobytes()
    assert out[1]["mine_heat"].tobytes() != out[0]["mine_heat"].tobytes()

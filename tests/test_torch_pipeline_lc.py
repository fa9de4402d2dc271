"""PyTorch port vs the JAX package: the frame step with ferns and loop
closure on the revisit clip, each frame started from the JAX state carried
over, and the state conversion of the loop-closure fields."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu import pipeline as jpipe
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch import pipeline as tpipe

from test_torch_clip_reference import jax_lc_gate
from test_torch_loop_closure import GATE_FRAME, lc_config
from test_torch_pipeline import _rot_angle

torch.set_num_threads(1)


def _state_np(state):
    return jax.tree.map(np.array, state)


def _lockstep(jc, tc, frames):
    """Run JAX free up to frames[0], then each frame of `frames` in both
    packages from JAX's state. Yields (k, JAX's fern lookup and gate, JAX's
    lc_count before, JAX state and output, port state and output)."""
    clip = synthetic.revisit_frames(tc.cam)
    js = jpipe.init_state(jc)
    for rgb, depth, _ in clip[:frames[0]]:
        js, _ = jpipe.process_frame(js, jnp.asarray(rgb), jnp.asarray(depth),
                                    jc)
    for k in frames:
        rgb, depth, _ = clip[k]
        fern = jax_lc_gate(js, rgb, depth, jc)
        lc0 = int(js.lc_count)
        ts = convert.state_from_jax_numpy(_state_np(js), device="cpu")
        js, jo = jpipe.process_frame(js, jnp.asarray(rgb), jnp.asarray(depth),
                                     jc)
        ts, to = tpipe.process_frame(ts, rgb, depth, tc)
        yield k, fern, lc0, js, jo, ts, to


def _check_step(k, js, jo, ts, to):
    """Poses within 1e-3 m and 1e-3 rad; ICP and VO flags equal;
    nb_supersurfels exact but where the known fusion fault decides it (the
    allowance of tests/test_torch_pipeline_mod.py); the keyframe store's
    codes, stamps and count exact and its keypoint payload exact."""
    assert np.abs(to.pose.t.numpy() - np.asarray(jo.pose.t)).max() <= 1e-3, k
    assert _rot_angle(to.pose.R.numpy(), np.asarray(jo.pose.R)) <= 1e-3, k
    assert bool(to.icp_valid) == bool(jo.icp_valid), k
    assert bool(to.vo_valid) == bool(jo.vo_valid), k
    nb_t, nb_j = int(to.nb_supersurfels), int(jo.nb_supersurfels)
    if nb_t != nb_j:
        # ROADMAP Queue 3, `fusion._fuse` (both packages)
        pos = np.asarray(js.model.surfels.positions)[:nb_j]
        thrown = int((np.abs(pos).max(axis=1) > 100.0).sum())
        assert abs(nb_t - nb_j) <= thrown, (k, nb_t, nb_j, thrown)
    for f in ("prev_fern_id", "last_lc_stamp", "lc_count"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), (k, f)
    jks, tks = js.kf_store, ts.kf_store
    for f in ("codes", "stamps", "count"):
        np.testing.assert_array_equal(getattr(tks.db, f).numpy(),
                                      np.asarray(getattr(jks.db, f)),
                                      err_msg=f"{k} {f}")
    np.testing.assert_array_equal(tks.kp_desc.numpy().view(np.uint32),
                                  np.asarray(jks.kp_desc))
    np.testing.assert_array_equal(tks.kp_valid.numpy(),
                                  np.asarray(jks.kp_valid))
    np.testing.assert_array_equal(tks.kp_xy.numpy(), np.asarray(jks.kp_xy))
    return nb_t != nb_j


def test_loop_closure_frame_step_matches_jax():
    """Frames 25-28 of the revisit clip at 320x240, the gate firing and the
    closure accepted on frame 27 (in both packages). Also: the fern ids,
    the new-keyframe flag and the gate exactly; `accepted`, lc_count,
    prev_fern_id and last_lc_stamp exactly; on the closure frame the local
    map (reset at the corrected pose) with its flags, descriptors and
    counters exact and positions within 1e-3 m, and the relocalizing
    keyframe's pose within 1e-3."""
    jc, tc = lc_config(jcfg), lc_config(tcfg)
    n_gate = n_fault = 0
    for k, (best, is_new, gate), lc0, js, jo, ts, to in _lockstep(
            jc, tc, range(GATE_FRAME - 2, GATE_FRAME + 2)):
        assert int(to.fern_id) == best, k
        assert bool(to.fern_new) == is_new, k
        assert to.lc_gate == gate, k
        accepted = int(js.lc_count) > lc0
        assert bool(to.lc_accepted) == accepted, k
        assert gate == (k == GATE_FRAME) and accepted == gate, k
        n_fault += _check_step(k, js, jo, ts, to)
        if accepted:
            n_gate += 1
            jm, tm = js.local_map, ts.local_map
            np.testing.assert_array_equal(tm.valid.numpy(),
                                          np.asarray(jm.valid))
            np.testing.assert_array_equal(tm.desc.numpy().view(np.uint32),
                                          np.asarray(jm.desc))
            np.testing.assert_array_equal(tm.counters.numpy(),
                                          np.asarray(jm.counters))
            v = np.asarray(jm.valid)
            np.testing.assert_allclose(tm.positions.numpy()[v],
                                       np.asarray(jm.positions)[v],
                                       atol=1e-3)
            np.testing.assert_allclose(
                ts.kf_store.db.poses_t.numpy()[best],
                np.asarray(js.kf_store.db.poses_t)[best], atol=1e-3)
    assert n_gate == 1 and n_fault <= 1


def test_ferns_only_frame_step_matches_jax():
    """Ferns without loop closure: frames 9-11, where the second keyframe
    is stored (frame 10). No gate is read and nothing is closed."""
    jc, tc = lc_config(jcfg, False), lc_config(tcfg, False)
    n_new = 0
    for k, (best, is_new, _), lc0, js, jo, ts, to in _lockstep(
            jc, tc, range(9, 12)):
        assert int(to.fern_id) == best, k
        assert bool(to.fern_new) == is_new, k
        assert to.lc_gate is None and to.lc_accepted is None
        _check_step(k, js, jo, ts, to)
        n_new += is_new
        kf = int(js.kf_store.db.count)
        for f, tol in (("sf_pos", 1e-4), ("sf_normal", 1e-4),
                       ("sf_color", 1e-3), ("kp_p3d", 1e-5)):
            np.testing.assert_allclose(
                getattr(ts.kf_store, f).numpy()[:kf],
                np.asarray(getattr(js.kf_store, f))[:kf], atol=tol,
                err_msg=f)
    assert n_new == 1 and int(ts.lc_count) == 0


def test_state_round_trip_of_the_loop_closure_fields():
    cfg = lc_config(jcfg)
    js = jpipe.init_state(cfg)
    ks = js.kf_store
    js = js._replace(
        prev_fern_id=jnp.int32(3), last_lc_stamp=jnp.int32(17),
        lc_count=jnp.int32(2),
        kf_store=ks._replace(
            db=ks.db._replace(count=jnp.int32(4),
                              codes=ks.db.codes.at[1, 2].set(jnp.uint8(13)),
                              stamps=ks.db.stamps.at[3].set(jnp.int32(99))),
            kp_desc=ks.kp_desc.at[2, 5, 7].set(jnp.uint32(0xFEEDFACE)),
            sf_valid=ks.sf_valid.at[0, 4].set(True)))
    jn = _state_np(js)
    ts = convert.state_from_jax_numpy(jn, device="cpu")
    assert ts.kf_store.kp_desc.dtype == torch.int32
    assert ts.kf_store.db.codes.dtype == torch.uint8
    back = convert.state_to_numpy(ts)
    flat = {f"kf_store.db.{f}": getattr(jn.kf_store.db, f)
            for f in jn.kf_store.db._fields}
    flat.update({f"kf_store.{f}": getattr(jn.kf_store, f)
                 for f in jn.kf_store._fields if f != "db"})
    flat.update(prev_fern_id=jn.prev_fern_id,
                last_lc_stamp=jn.last_lc_stamp, lc_count=jn.lc_count)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    assert back["kf_store.kp_desc"][2, 5, 7] == 0xFEEDFACE
    # a fresh port state has the same fields, shapes and values as JAX's
    fresh = convert.state_to_numpy(tpipe.init_state(lc_config(tcfg),
                                                    device="cpu"))
    jfresh = _state_np(jpipe.init_state(cfg))
    np.testing.assert_array_equal(fresh["kf_store.db.poses_R"],
                                  jfresh.kf_store.db.poses_R)
    for f in ("prev_fern_id", "last_lc_stamp", "lc_count"):
        assert fresh[f] == getattr(jfresh, f), f
    assert fresh["kf_store.sf_pos"].shape == jfresh.kf_store.sf_pos.shape

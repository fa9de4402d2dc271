"""PyTorch port vs the JAX package: the whole default frame step on a small
synthetic clip, each frame started from the same carried-over state, plus
the state conversion and the device contract of the entry points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu import pipeline as jpipe
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch import pipeline as tpipe

# One intra-op thread: the suite runs in several worker processes at once,
# and each process's OpenMP threads spinning against the others' made the
# torch tests about 20 times slower on an 8-core machine.
torch.set_num_threads(1)


def small_config(C, **kw):
    """The default configuration cut to 256x192: fewer TPS iterations, a
    smaller model and local map, a 16 px detection cell so the small image
    keeps enough keypoints, and an ICP inlier floor scaled to its 192
    superpixels."""
    return C.PipelineConfig(**kw,
        cam=C.CameraIntrinsics(fx=200.0, fy=200.0, cx=127.5, cy=95.5,
                               width=256, height=192),
        tps=C.TPSConfig(nb_iters=2, filter_iter=1),
        icp=C.ICPConfig(min_inliers=20.0),
        fusion=C.FusionConfig(nb_supersurfels_max=2048, visible_cap=1024),
        vo=C.VOConfig(nb_features=256, nb_levels=2, local_map_capacity=512,
                      detect_cell=16),
        max_frames=16)


def _state_np(state):
    return jax.tree.map(np.array, state)


def test_state_round_trip():
    js = jpipe.init_state(small_config(jcfg))
    js = js._replace(stamp=jnp.int32(3),
                     local_map=js.local_map._replace(
                         desc=js.local_map.desc.at[0].set(
                             jnp.uint32(0xDEADBEEF))),
                     mod_prev=js.mod_prev._replace(
                         kp_desc=js.mod_prev.kp_desc.at[1, 2].set(
                             jnp.uint32(0xCAFEF00D)),
                         initialized=jnp.bool_(True)))
    jn = _state_np(js)
    ts = convert.state_from_jax_numpy(jn, device="cpu")
    back = convert.state_to_numpy(ts)
    assert back["local_map.desc"][0, 0] == 0xDEADBEEF
    assert back["mod_prev.kp_desc"][1, 2] == 0xCAFEF00D
    assert ts.local_map.desc.dtype == torch.int32
    assert ts.mod_prev.kp_desc.dtype == torch.int32
    assert ts.detector is None
    flat = {
        "stamp": jn.stamp, "traj": jn.traj, "pose.R": jn.pose.R,
        "pose.t": jn.pose.t, "vis_peak": jn.vis_peak,
        "dropped_total": jn.dropped_total,
        "model.nb_supersurfels": jn.model.nb_supersurfels,
        "model.nb_visible": jn.model.nb_visible,
    }
    flat.update({f"model.surfels.{f}": getattr(jn.model.surfels, f)
                 for f in jn.model.surfels._fields})
    flat.update({f"local_map.{f}": getattr(jn.local_map, f)
                 for f in jn.local_map._fields})
    flat.update({f"mod_prev.{f}": getattr(jn.mod_prev, f)
                 for f in jn.mod_prev._fields})
    flat.update({f"kf_store.db.{f}": getattr(jn.kf_store.db, f)
                 for f in jn.kf_store.db._fields})
    flat.update({f"kf_store.{f}": getattr(jn.kf_store, f)
                 for f in jn.kf_store._fields if f != "db"})
    flat.update(prev_fern_id=jn.prev_fern_id,
                last_lc_stamp=jn.last_lc_stamp, lc_count=jn.lc_count)
    assert set(flat) == set(back)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("vo", [True, False], ids=["default", "icp_only"])
def test_frame_step_matches_jax(vo):
    """Frames of the synthetic scene, with sparse VO (the default) and
    without (ICP only). Every frame both packages start from the JAX state
    carried over, so differences cannot accumulate."""
    jc = small_config(jcfg, enable_sparse_vo=vo)
    tc = small_config(tcfg, enable_sparse_vo=vo)
    frames = synthetic.frames(tc.cam, 4 if vo else 3)
    js = jpipe.init_state(jc)
    n_icp = n_vo = 0
    for k, (rgb, depth, _) in enumerate(frames):
        ts = convert.state_from_jax_numpy(_state_np(js), device="cpu")
        js, jo = jpipe.process_frame(js, jnp.asarray(rgb), jnp.asarray(depth),
                                     jc)
        ts, to = tpipe.process_frame(ts, rgb, depth, tc)
        assert np.abs(to.pose.t.numpy() - np.asarray(jo.pose.t)).max() \
            <= 1e-3, k
        assert _rot_angle(to.pose.R.numpy(), np.asarray(jo.pose.R)) \
            <= 1e-3, k
        assert bool(to.icp_valid) == bool(jo.icp_valid), k
        assert int(to.icp_code) == int(jo.icp_code), k
        assert bool(to.vo_valid) == bool(jo.vo_valid), k
        assert (to.labels.numpy() == np.asarray(jo.labels)).mean() >= 0.99
        nb_t, nb_j = int(to.nb_supersurfels), int(jo.nb_supersurfels)
        assert nb_t == nb_j, k
        n_icp += bool(jo.icp_valid)
        n_vo += bool(jo.vo_valid)
    # the clip exercises the trackers it runs
    assert n_icp >= 2 and n_vo >= (2 if vo else 0)


def test_entry_points_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_config(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.init_state(cfg)
    with pytest.raises(RuntimeError):
        tpipe.SupersurfelFusion(cfg)
    with pytest.raises(RuntimeError):
        convert.state_from_jax_numpy(_state_np(jpipe.init_state(
            small_config(jcfg))))
    assert tpipe.init_state(cfg, device="cpu").stamp.device.type == "cpu"


def test_helpers_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    """The person detector's loader, the fern table and the empty MOD
    context default to the card, and raise without one unless asked for
    the CPU; so do the sharded ranks (`parallel.distributed.launch`, here
    through `mesh.dryrun`)."""
    from supersurfel_fusion_tpu_torch.models.person_detector import (
        load_detector,
    )
    from supersurfel_fusion_tpu_torch.ops import ferns, motion
    from supersurfel_fusion_tpu_torch.parallel import mesh

    from pathlib import Path

    weights = Path(__file__).resolve().parents[1] / "weights" \
        / "person_detector.npz"
    fc = tcfg.FernsConfig(nb_ferns=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make, cpu in (
            (lambda **kw: load_detector(weights, **kw),
             lambda d: next(d.parameters()).device),
            (lambda **kw: ferns.make_fern_table(fc, 64, 48, 5.0, **kw),
             lambda t: t[0].device),
            (lambda **kw: motion.init_prev(48, 64, 8, 16, **kw),
             lambda p: p.gray.device)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert cpu(make(device="cpu")).type == "cpu"
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            mesh.dryrun(1)


def test_unported_options_are_refused():
    """Only the sharded step refuses an option: the insertion gate, which
    the JAX package's sharded step lacks too. The single-device step takes
    temporal heat, the whole-update freeze and the insertion gate (their
    parity: test_torch_pipeline_options.py); ferns and loop closure run."""
    from supersurfel_fusion_tpu_torch.parallel import pipeline_sharded

    base = small_config(tcfg)
    gate = dataclasses.replace(base, fusion=tcfg.FusionConfig(
        insert_requires_icp=True))
    freeze = dataclasses.replace(base, fusion=tcfg.FusionConfig(
        freeze_on_tracking_loss=True))
    heat = dataclasses.replace(base, mod=tcfg.MODConfig(
        enabled=True, temporal_heat=True))
    with pytest.raises(NotImplementedError, match="insert_requires_icp"):
        pipeline_sharded.check_supported(gate)
    for cfg in (heat, freeze):
        pipeline_sharded.check_supported(cfg)
    for cfg in (heat, freeze, gate,
                dataclasses.replace(base, enable_loop_closure=True),
                dataclasses.replace(base,
                                    ferns=tcfg.FernsConfig(enabled=True))):
        assert int(tpipe.init_state(cfg, device="cpu").lc_count) == 0


def test_supersurfel_fusion_tracks_the_synthetic_clip():
    cfg = small_config(tcfg)
    slam = tpipe.SupersurfelFusion(cfg, device="cpu")
    gt = synthetic.trajectory(3)
    for k, (rgb, depth, _) in enumerate(synthetic.frames(cfg.cam, 3)):
        slam.process(rgb, depth, timestamp=float(k))
    traj = slam.trajectory
    assert len(traj) == 3
    np.testing.assert_allclose(traj[0], [0, 0, 0, 0, 0, 0, 1], atol=1e-6)
    assert np.isfinite(np.array(traj)).all()
    # 256x192 tracks coarsely; the 640x480 bound is chip_smoke.py's
    assert np.linalg.norm(traj[-1][:3] - gt[-1][1]) < 0.05
    assert int(slam.state.stamp) == 3

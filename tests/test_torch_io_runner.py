"""PyTorch port vs the JAX package: trajectory evaluation, the TUM reader,
model export, checkpoints and the offline runner, on TUM-format
directories written from the synthetic clips."""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu.eval import trajectory as jtraj
from supersurfel_fusion_tpu.io import export as jexport
from supersurfel_fusion_tpu.io import tum as jtum
from supersurfel_fusion_tpu.viz import render as jrender
from supersurfel_fusion_tpu.types import Supersurfels as JSurfels
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import pipeline as tpipe
from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.apps import run_benchmark
from supersurfel_fusion_tpu_torch.eval import trajectory as ttraj
from supersurfel_fusion_tpu_torch.io import export as texport
from supersurfel_fusion_tpu_torch.io import native_loader
from supersurfel_fusion_tpu_torch.io import tum as ttum
from supersurfel_fusion_tpu_torch.models.person_detector import load_detector
from supersurfel_fusion_tpu_torch.types import Supersurfels as TSurfels
from supersurfel_fusion_tpu_torch.viz import render as trender

from test_torch_motion import WEIGHTS
from test_torch_pipeline import small_config

torch.set_num_threads(1)


def _random_trajectory(rng, n, t0=0.0, dt=1 / 30):
    out = {}
    for k in range(n):
        R = synthetic.axis_angle(rng.normal(size=3), rng.uniform(0, 0.5))
        out[t0 + k * dt] = np.concatenate(
            [rng.normal(size=3), ttraj.mat_to_quat_np(R)])
    return out


def test_trajectory_evaluation_equals_jax():
    rng = np.random.default_rng(4)
    gt = _random_trajectory(rng, 40)
    # an estimate: the ground truth moved rigidly, with noise and jittered
    # timestamps (two of them past the association window)
    R = synthetic.axis_angle([0.2, 1.0, -0.3], 0.7)
    est = {}
    for i, (t, p) in enumerate(gt.items()):
        q = ttraj.quat_to_mat_np(p[3:])
        ts = t + rng.uniform(-0.005, 0.005) + (0.05 if i in (3, 17) else 0)
        est[ts] = np.concatenate([R @ p[:3] + [0.1, 0.2, 0.3]
                                  + rng.normal(size=3) * 0.01,
                                  ttraj.mat_to_quat_np(R @ q)])
    assert ttraj.associate_timestamps(list(est), list(gt)) \
        == jtraj.associate_timestamps(list(est), list(gt))
    for delta in (1, 5):
        assert vars(ttraj.rpe(est, gt, delta=delta)) \
            == vars(jtraj.rpe(est, gt, delta=delta))
    ta, ja = ttraj.ate(est, gt), jtraj.ate(est, gt)
    assert vars(ta) == vars(ja) and ta.n_pairs == 38 and ta.rmse < 0.05
    m = rng.normal(size=(3, 20))
    for a, b in zip(ttraj.horn_align(m, R @ m + 1.0),
                    jtraj.horn_align(m, R @ m + 1.0)):
        np.testing.assert_array_equal(a, b)
    for p in list(gt.values())[:10]:
        Rm = ttraj.quat_to_mat_np(p[3:])
        np.testing.assert_array_equal(Rm, jtraj.quat_to_mat_np(p[3:]))
        np.testing.assert_array_equal(ttraj.mat_to_quat_np(Rm),
                                      jtraj.mat_to_quat_np(Rm))
    with pytest.raises(ValueError):
        ttraj.ate(dict(list(est.items())[:1]), gt)


def _write_sequence(root, n=3):
    cam = small_config(tcfg).cam
    clip = synthetic.frames(cam, n)
    stamps = synthetic.write_tum_sequence(str(root), clip)
    return clip, stamps


def test_tum_reader_equals_jax(tmp_path):
    clip, stamps = _write_sequence(tmp_path, 4)
    td, jd = ttum.TUMDataset(str(tmp_path)), jtum.TUMDataset(str(tmp_path))
    assert len(td) == len(jd) == 4
    for a, b in zip(td.associations, jd.associations):
        assert (a.rgb_ts, a.rgb_file, a.depth_ts, a.depth_file) \
            == (b.rgb_ts, b.rgb_file, b.depth_ts, b.depth_file)
        np.testing.assert_array_equal(a.gt, b.gt)
    for k in range(4):
        fr, fj = td.load_frame_raw(k), jd.load_frame_raw(k)
        np.testing.assert_array_equal(fr.rgb, clip[k][0])
        np.testing.assert_array_equal(fr.depth, clip[k][1])
        np.testing.assert_array_equal(fr.depth, fj.depth)
        fm = td.load_frame(k)
        np.testing.assert_array_equal(fm.depth, jd.load_frame(k).depth)
        assert fm.timestamp == stamps[k]
    gt = ttum.read_trajectory_file(str(tmp_path / "groundtruth.txt"))
    assert gt.keys() == jtum.read_trajectory_file(
        str(tmp_path / "groundtruth.txt")).keys()
    np.testing.assert_allclose(gt[stamps[2]][:3], clip[2][2][1], atol=1e-8)
    # without the association file: rgb.txt and depth.txt are associated
    os.remove(tmp_path / "associations_with_gt.txt")
    td, jd = ttum.TUMDataset(str(tmp_path)), jtum.TUMDataset(str(tmp_path))
    assert [(a.rgb_ts, a.depth_file) for a in td.associations] \
        == [(a.rgb_ts, a.depth_file) for a in jd.associations]
    assert len(td) == 4 and td.associations[0].gt is None
    poses = [v for v in gt.values()]
    ttum.write_trajectory(str(tmp_path / "t.txt"), stamps, poses)
    jtum.write_trajectory(str(tmp_path / "j.txt"), stamps, poses)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_native_loader_equals_pil(tmp_path):
    """The native decoder (built with g++ from `native/tum_loader.cpp`)
    and its prefetcher give the PIL path's frames bit for bit."""
    clip, _ = _write_sequence(tmp_path, 3)
    ds = ttum.TUMDataset(str(tmp_path))
    pairs = [(str(tmp_path / a.rgb_file), str(tmp_path / a.depth_file))
             for a in ds.associations]
    W, H = small_config(tcfg).cam.width, small_config(tcfg).cam.height
    loader = native_loader.PrefetchingLoader(pairs, W, H)
    try:
        for k in range(3):
            rgb, depth = loader.get(k)
            f = ds.load_frame_raw(k)
            np.testing.assert_array_equal(rgb, f.rgb)
            np.testing.assert_array_equal(depth, f.depth)
            one = native_loader.decode_pair(*pairs[k], W, H)
            np.testing.assert_array_equal(one[0], clip[k][0])
            np.testing.assert_array_equal(one[1], clip[k][1])
    finally:
        loader.close()


def test_renders_equal_jax():
    rng = np.random.default_rng(7)
    H, W, n = 48, 64, 200
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    labels = (np.arange(H)[:, None] // 8 * 8 + np.arange(W)[None] // 8)
    static = rng.random(labels.max() + 1) > 0.3
    depth = rng.uniform(-1, 7, (H, W)).astype(np.float32)
    depth[0, :3] = [np.nan, np.inf, 0.0]
    pos = rng.normal(size=(n, 3)) + [0, 0, 3]
    args = (pos, rng.uniform(0, 255, (n, 3)), rng.random((n, 2)) * 0.01,
            rng.uniform(-1, 5, n), 150, np.eye(3), np.zeros(3), 50.0, 50.0,
            31.5, 23.5, W, H)
    for name, a in (("superpixel_image", (rgb, labels)),
                    ("slanted_plane_image", (depth,)),
                    ("mod_mask_image", (labels, static)),
                    ("model_image", args)):
        np.testing.assert_array_equal(getattr(trender, name)(*a),
                                      getattr(jrender, name)(*a),
                                      err_msg=name)


def _models(n=64, seed=0):
    rng = np.random.default_rng(seed)
    f = dict(positions=rng.normal(size=(n, 3)) * 2,
             colors=rng.uniform(0, 300, (n, 3)),
             orientations=np.stack([synthetic.axis_angle(v, 1.0)
                                    for v in rng.normal(size=(n, 3))]),
             shapes=rng.normal(size=(n, 3, 3)),
             dims=rng.random((n, 2)),
             confidences=np.where(np.arange(n) < 50,
                                  rng.uniform(-1, 800, n), -1.0))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    st = rng.integers(0, 99, (n, 2)).astype(np.int32)
    jm = JSurfels.empty(n)._replace(stamps=jnp.asarray(st),
                                    **{k: jnp.asarray(v)
                                       for k, v in f.items()})
    tm = TSurfels.empty(n, "cpu")._replace(stamps=torch.from_numpy(st),
                                           **{k: torch.from_numpy(v)
                                              for k, v in f.items()})
    return jm, tm


def test_model_export_equals_jax(tmp_path):
    jm, tm = _models()
    for nb, thresh in ((50, 100.0), (64, -0.5)):
        assert texport.export_model(str(tmp_path / "t.txt"), tm,
                                    torch.tensor(nb), thresh) \
            == jexport.export_model(str(tmp_path / "j.txt"), jm, nb, thresh)
        assert (tmp_path / "t.txt").read_bytes() \
            == (tmp_path / "j.txt").read_bytes()
        assert texport.export_model_ply(str(tmp_path / "t.ply"), tm, nb,
                                        thresh) \
            == jexport.export_model_ply(str(tmp_path / "j.ply"), jm, nb,
                                        thresh)
        assert (tmp_path / "t.ply").read_bytes() \
            == (tmp_path / "j.ply").read_bytes()


def test_extract_local_point_cloud_equals_jax():
    """Positions and normals in the camera frame within 1e-6, the mask
    exact."""
    jm, tm = _models(seed=1)
    R = synthetic.axis_angle([0.3, 1.0, 0.2], 0.4).astype(np.float32)
    t = np.array([0.2, -0.1, 0.4], np.float32)
    jp, jn, jok = jexport.extract_local_point_cloud(
        jm, jnp.int32(50), jnp.asarray(R), jnp.asarray(t), 100.0, 3.0)
    tp, tn, tok = texport.extract_local_point_cloud(
        tm, torch.tensor(50, dtype=torch.int32), torch.from_numpy(R),
        torch.from_numpy(t), 100.0, 3.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < 50


def test_checkpoint_resume_equivalence(tmp_path):
    """save -> load -> continue gives the same poses and state as a run
    that was not interrupted (the JAX package's fr1 test, on the synthetic
    clip with ferns on, so the keyframe store is carried)."""
    cfg = small_config(tcfg, ferns=tcfg.FernsConfig(enabled=True,
                                                    max_keyframes=8))
    clip = synthetic.frames(cfg.cam, 5)
    k = 3
    a = tpipe.SupersurfelFusion(cfg, device="cpu")
    for rgb, depth, _ in clip[:k]:
        a.process(rgb, depth)
    path = texport.save_checkpoint(str(tmp_path / "ckpt.pt"), a.state)
    cont = [a.process(rgb, depth).pose for rgb, depth, _ in clip[k:]]
    b = tpipe.SupersurfelFusion(cfg, device="cpu")
    b.state = texport.load_checkpoint(path, device="cpu")
    resumed = [b.process(rgb, depth).pose for rgb, depth, _ in clip[k:]]
    for pa, pb in zip(cont, resumed):
        np.testing.assert_allclose(pa.R.numpy(), pb.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(pa.t.numpy(), pb.t.numpy(), atol=1e-6)
    assert int(b.state.kf_store.db.count) == int(a.state.kf_store.db.count)
    assert int(b.state.stamp) == len(clip)
    # the device is the caller's: loading for a card without one raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            texport.load_checkpoint(path)
    # the person detector travels as its weights
    det_state = a.state._replace(detector=load_detector(WEIGHTS, "cpu"))
    p2 = texport.save_checkpoint(str(tmp_path / "det.pt"), det_state)
    back = texport.load_checkpoint(p2, device="cpu")
    for (ka, va), (kb, vb) in zip(det_state.detector.state_dict().items(),
                                  back.detector.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_runner_one_frame_at_640x480(tmp_path):
    """The runner's `main` on a 640x480 TUM directory (every TUM camera is
    640x480), one frame on the plain CPU path with loop closure on: the
    JSON line, the trajectory file and the native loader. Without `--cpu`
    it runs on the card, and with no card it exits non-zero."""
    seq = tmp_path / "rgbd_dataset_freiburg1_synthetic"
    clip = synthetic.frames(tcfg.PipelineConfig().cam, 2)
    stamps = synthetic.write_tum_sequence(str(seq), clip)
    traj = tmp_path / "est.txt"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_benchmark.main(["--dataset", str(seq), "--cpu",
                                 "--max-frames", "1", "--out", str(traj),
                                 "--loop-closure", "--quiet"])
    assert rc == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["frames"] == 1 and res["device"] == "cpu"
    assert res["loader"] == "native"
    assert res["lc_count"] == 0 and res["keyframes"] == 1
    assert res["trajectory"] == str(traj) and res["model_mb"] > 0
    rows = ttum.read_trajectory_file(str(traj))
    assert list(rows) == [stamps[0]]
    np.testing.assert_allclose(rows[stamps[0]],
                               [0, 0, 0, 0, 0, 0, 1], atol=1e-6)
    if not torch.cuda.is_available():
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = run_benchmark.main(["--dataset", str(seq), "--quiet"])
        assert rc != 0 and "device='cpu'" in err.getvalue()

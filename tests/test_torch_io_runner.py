"""PyTorch port vs the JAX package: trajectory evaluation, the TUM reader,
model export, checkpoints and the offline runner, on TUM-format
directories written from the synthetic clips."""

import contextlib
import io
import json
import os
import re
import struct
import threading
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

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
    """The native decoder (built with g++ from the port's
    `csrc/tum_loader.cpp`) and its prefetcher give the PIL path's frames
    bit for bit."""
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


# the C++ standard library headers the loader may include: no compression
# library (libdeflate.h, zlib.h) and nothing else outside the standard
_STD_HEADERS = {"algorithm", "atomic", "chrono", "condition_variable",
                "cstdint", "cstdio", "cstdlib", "cstring", "mutex", "string",
                "thread", "unordered_map", "vector"}


def test_native_loader_links_only_pthread():
    """The build command links nothing but pthread and names no include or
    library directory; the source is the port's own and includes only the
    C++ standard library, so a machine without libdeflate builds it."""
    cmd = native_loader.build_command("g++", "out.so")
    assert native_loader.SOURCE.parent.name == "csrc"
    assert native_loader.SOURCE.parents[1].name == "supersurfel_fusion_tpu_torch"
    assert str(native_loader.SOURCE) in cmd
    assert [a for a in cmd if a.startswith("-l")] == ["-lpthread"]
    assert not [a for a in cmd if a.startswith(("-L", "-I", "-Wl"))]
    text = native_loader.SOURCE.read_text()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", text,
                          re.M)
    assert includes and set(includes) <= _STD_HEADERS, includes
    assert "libdeflate" not in text and "zlib.h" not in text
    assert native_loader.build_library().exists()


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(raw, bpp, filters):
    """PNG-filter the rows of `raw` ((H, stride) uint8), row y with
    filters[y % len(filters)]."""
    out = bytearray()
    prev = np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw.astype(np.int32)):
        f = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if f == 1:
            row_f = row - a
        elif f == 2:
            row_f = row - b
        elif f == 3:
            row_f = row - (a + b) // 2
        elif f == 4:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            row_f = row - np.where((pa <= pb) & (pa <= pc), a,
                                   np.where(pb <= pc, b, c))
        else:
            row_f = row
        out.append(f)
        out += (row_f & 255).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def write_png(path, img, level, strategy=zlib.Z_DEFAULT_STRATEGY,
              filters=(0, 1, 2, 3, 4), n_idat=1):
    """An 8-bit RGB ((H, W, 3) uint8) or 16-bit grey ((H, W) uint16) PNG
    written here: the rows filtered with `filters` in turn, the zlib
    stream at `level` and `strategy`, split over `n_idat` IDAT chunks.
    Returns the zlib stream."""
    h, w = img.shape[:2]
    if img.dtype == np.uint16:
        kind, depth, bpp = 0, 16, 2
        raw = img.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    else:
        kind, depth, bpp = 2, 8, 3
        raw = img.reshape(h, 3 * w)
    co = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    stream = co.compress(_filter_rows(raw, bpp, filters)) + co.flush()
    cuts = np.linspace(0, len(stream), n_idat + 1).astype(int)
    idat = b"".join(_png_chunk(b"IDAT", stream[a:b])
                    for a, b in zip(cuts[:-1], cuts[1:]))
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, kind, 0,
                                          0, 0))
        + idat + _png_chunk(b"IEND", b""))
    return stream


def _test_images(seed, h=40, w=56):
    """An RGB and a depth image with flat patches, ramps and noise, so
    that every filter and both literals and matches occur."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgb[5:20, 3:40] = [200, 30, 90]
    rgb[25:] = (np.arange(w)[None, :, None] * [3, 5, 7]).astype(np.uint8)
    depth = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    depth[8:30, 10:50] = 4321
    depth[30:] = np.arange(w, dtype=np.uint16)[None] * 997
    return rgb, depth


@pytest.mark.parametrize("level,strategy,btype",
                         [(0, zlib.Z_DEFAULT_STRATEGY, 0),
                          (1, zlib.Z_FIXED, 1),
                          (9, zlib.Z_DEFAULT_STRATEGY, 2)],
                         ids=["stored", "fixed", "dynamic"])
def test_native_decode_equals_pil_on_written_pngs(tmp_path, level, strategy,
                                                  btype):
    """Hand-written PNGs, 8-bit RGB and 16-bit grey, each row filter in
    every image, the IDAT data in one and in three chunks, at zlib level
    0 (stored blocks), 1 with fixed codes and 9 (dynamic codes): the
    native decode equals PIL's and the written image bit for bit."""
    rgb, depth = _test_images(level)
    h, w = depth.shape
    for n_idat, filters in ((1, (0, 1, 2, 3, 4)), (3, (4, 3, 2, 1, 0))):
        rp, dp = tmp_path / f"rgb{n_idat}.png", tmp_path / f"d{n_idat}.png"
        for stream in (write_png(rp, rgb, level, strategy, filters, n_idat),
                       write_png(dp, depth, level, strategy, filters[::-1],
                                 n_idat)):
            assert (stream[2] >> 1) & 3 == btype   # the first block's type
        got_rgb, got_depth = native_loader.decode_pair(str(rp), str(dp), w, h)
        np.testing.assert_array_equal(got_rgb, np.asarray(Image.open(rp)))
        np.testing.assert_array_equal(got_depth, np.asarray(Image.open(dp)))
        np.testing.assert_array_equal(got_rgb, rgb)
        np.testing.assert_array_equal(got_depth, depth)


def test_native_decode_refuses_broken_files(tmp_path):
    """A file cut inside its chunks, a zlib stream cut short inside whole
    chunks, a wrong Adler-32, a wrong size and a missing file: decode_pair
    raises IOError, and the process lives on."""
    rgb, depth = _test_images(5)
    h, w = depth.shape
    rp, dp = tmp_path / "rgb.png", tmp_path / "d.png"
    stream = write_png(rp, rgb, 9)
    write_png(dp, depth, 9)
    good = rp.read_bytes()
    bad = tmp_path / "bad.png"

    def refused(data, width=w, height=h):
        bad.write_bytes(data)
        with pytest.raises(IOError):
            native_loader.decode_pair(str(bad), str(dp), width, height)

    for cut in (20, 45, 70, len(good) // 2, len(good) - 20):
        refused(good[:cut])
    head = good[:good.index(b"IDAT") - 4]
    for short in (stream[:len(stream) // 2], stream[:-4],
                  stream[:-1] + bytes([stream[-1] ^ 1])):
        refused(head + _png_chunk(b"IDAT", short) + _png_chunk(b"IEND", b""))
    refused(good, width=w + 1)
    with pytest.raises(IOError):
        native_loader.decode_pair(str(tmp_path / "none.png"), str(dp), w, h)
    assert native_loader.decode_pair(str(rp), str(dp), w, h)[0].shape \
        == (h, w, 3)


def test_prefetcher_refuses_a_served_frame(tmp_path):
    """Each frame is handed out once: asking again for a frame already
    served, or for one out of range, raises IOError at once (it used to
    wait forever); frames not yet served still come, in any order."""
    rgb, depth = _test_images(6)
    h, w = depth.shape
    pairs = []
    for k in range(4):
        rp, dp = tmp_path / f"rgb{k}.png", tmp_path / f"d{k}.png"
        write_png(rp, np.roll(rgb, k, axis=1), 6)
        write_png(dp, np.roll(depth, k, axis=1), 6)
        pairs.append((str(rp), str(dp)))
    loader = native_loader.PrefetchingLoader(pairs, w, h, n_threads=2,
                                             lookahead=2)
    errors = []

    def consume():
        try:
            for k in (0, 2):
                got = loader.get(k)
                np.testing.assert_array_equal(got[0], np.roll(rgb, k, axis=1))
            for k in (0, 2, 4, -1):
                with pytest.raises(IOError, match="already served"):
                    loader.get(k)
            np.testing.assert_array_equal(loader.get(1)[1],
                                          np.roll(depth, 1, axis=1))
            loader.get(3)
            with pytest.raises(IOError, match="already served"):
                loader.get(3)
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    worker = threading.Thread(target=consume, daemon=True)
    worker.start()
    worker.join(timeout=60)
    try:
        assert not worker.is_alive(), "the prefetcher blocked"
        if errors:
            raise errors[0]
    finally:
        if not worker.is_alive():
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

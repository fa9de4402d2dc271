"""PyTorch port vs the JAX package: the MOD module (superpixel adjacency,
geometric clustering, the person flood fill and the whole
`detect_motion`), on frames of the synthetic dynamic clip at 256x192, on
the CPU. Every MOD input (TPS result, frame surfels, keypoints, previous
context) is computed once by the JAX package and fed to both."""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu.models import person_detector as jpd
from supersurfel_fusion_tpu.ops import motion as jmotion
from supersurfel_fusion_tpu.ops import tps as jtps
from supersurfel_fusion_tpu.ops.depth import bilateral_filter, depth_to_disp
from supersurfel_fusion_tpu.ops.features import detect_and_describe
from supersurfel_fusion_tpu.ops.supersurfels import generate_supersurfels
from supersurfel_fusion_tpu.utils.color import rgb_to_gray
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import convert, synthetic
from supersurfel_fusion_tpu_torch.ops import features as tfeat
from supersurfel_fusion_tpu_torch.ops import motion as tmotion
from supersurfel_fusion_tpu_torch.ops import tps as ttps
from supersurfel_fusion_tpu_torch.types import Supersurfels

from test_torch_pipeline import small_config

# One intra-op thread: the suite runs in several worker processes at once,
# and each process's OpenMP threads spinning against the others' made the
# torch tests about 20 times slower on an 8-core machine.
torch.set_num_threads(1)

# at the 256x192 test camera (fx 200) the mover slides 5 cm per frame,
# about 4.5 px: the fr3 camera's ~5 px at 640x480 for the clip's 2 cm
MOVER_STEP = 0.05
WEIGHTS = str(Path(__file__).resolve().parent.parent / "weights"
              / "person_detector.npz")


def mod_config(C, yolo: bool):
    """The MOD frame step's configuration cut to 256x192 (the pipeline
    tests' small configuration), with or without the person detector."""
    return small_config(C, mod=C.MODConfig(
        enabled=True, use_yolo=yolo, weights_path=WEIGHTS if yolo else ""))


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _to_port(cls, nt):
    """A JAX NamedTuple of numpy arrays as the port's `cls`."""
    if cls is ttps.TPSResult:
        return cls(*(_to_port(ttps.SuperpixelStats, v) if f == "stats"
                     else _t(v) for f, v in zip(cls._fields, nt)))
    return cls(*(_t(v) for v in nt))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_mod_inputs(rgb_u8, depth_u16, cfg):
    """The frame step up to the MOD call (JAX pipeline steps 1-8)."""
    rgb = rgb_u8.astype(jnp.float32)
    depth = depth_u16.astype(jnp.float32) * cfg.depth_scale
    fdepth = bilateral_filter(depth, cfg.bilateral_sigma_value,
                              cfg.bilateral_sigma_space, cfg.bilateral_radius)
    tps = jtps.segment(rgb, depth_to_disp(fdepth), cfg.tps)
    theta = jtps.smooth_planes(tps.stats, cfg.tps)
    tps = tps._replace(stats=tps.stats._replace(theta=theta))
    plane = jtps.render_plane_depth(theta, tps.labels, cfg.grid_h,
                                    cfg.grid_w, cfg.tps.cell_size)
    frame = generate_supersurfels(rgb, plane, tps, cfg.cam, cfg.tps,
                                  cfg.generation, cfg.fusion.range_min,
                                  cfg.fusion.range_max, jnp.int32(0))
    gray = rgb_to_gray(rgb)
    return gray, fdepth, detect_and_describe(gray, cfg.vo), frame, tps


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_detect(gray, fdepth, prev, kp, frame, tps, params, cfg):
    return jmotion.detect_motion(gray, fdepth, prev, kp, frame, tps, cfg.cam,
                                 cfg.tps, cfg.mod, detector_params=params)


@functools.lru_cache(maxsize=None)
def mod_sequence(yolo: bool, n: int = 4):
    """JAX MOD inputs and outputs over the first n dynamic frames: a list
    of (inputs, prev, outputs) per frame, all numpy."""
    cfg = mod_config(jcfg, yolo)
    params = jpd.load_params(WEIGHTS) if yolo else None
    clip = synthetic.dynamic_frames(mod_config(tcfg, yolo).cam, n,
                                    step=MOVER_STEP)
    kcap = None
    prev = None
    seq = []
    for rgb, depth, _, mover in clip:
        ins = _jax_mod_inputs(jnp.asarray(rgb), jnp.asarray(depth), cfg)
        if prev is None:
            kcap = ins[2].xy.shape[0]
            prev = jmotion.init_prev(cfg.cam.height, cfg.cam.width, kcap,
                                     cfg.tps.cell_size)
        out = _jax_detect(*ins[:2], prev, *ins[2:], params, cfg)
        seq.append(jax.tree.map(np.asarray, (ins, prev, out, mover)))
        prev = out[2]
    return seq


def _port_args(ins, prev):
    gray, fdepth, kp, frame, tps = ins
    return (_t(gray), _t(fdepth), _to_port(tmotion.MODPrev, prev),
            _to_port(tfeat.Keypoints, kp), _to_port(Supersurfels, frame),
            _to_port(ttps.TPSResult, tps))


def test_superpixel_adjacency_matches_jax():
    ins, _, _, _ = mod_sequence(False)[1]
    labels = ins[4].labels
    for lab in (labels, np.roll(labels, 3, axis=1)):
        aj = np.asarray(jmotion.superpixel_adjacency(jnp.asarray(lab), 12,
                                                     16, 16))
        at = tmotion.superpixel_adjacency(_t(lab), 12, 16, 16).numpy()
        np.testing.assert_array_equal(at, aj)
    assert aj.sum() > 100 and not aj[..., 12].any()


def test_geometric_clusters_match_jax():
    cfg = jcfg.MODConfig()
    ins, _, _, _ = mod_sequence(False)[1]
    frame, tps = ins[3], ins[4]
    adj = np.asarray(jmotion.superpixel_adjacency(jnp.asarray(tps.labels),
                                                  12, 16, 16))
    pos = frame.positions.reshape(12, 16, 3)
    nrm = frame.orientations[:, 2, :].reshape(12, 16, 3)
    conf = frame.confidences.reshape(12, 16)
    for iters in (3, 64):
        c = dataclasses.replace(cfg, cc_iters=iters)
        rj, gj = jax.jit(jmotion.geometric_clusters,
                         static_argnums=(4, 5, 6))(
            jnp.asarray(adj), jnp.asarray(pos), jnp.asarray(nrm),
            jnp.asarray(conf), 12, 16, c)
        rt, gt = tmotion.geometric_clusters(_t(adj), _t(pos), _t(nrm),
                                            _t(conf), 12, 16,
                                            tcfg.MODConfig(cc_iters=iters))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    # the scene's planes form clusters of many superpixels
    assert np.bincount(np.asarray(rj).ravel()).max() > 20


@pytest.mark.parametrize("n_iters", [2, 48])
def test_person_flood_fill_matches_jax(n_iters):
    ins, _, _, mover = mod_sequence(False)[1]
    frame, tps = ins[3], ins[4]
    adj = np.asarray(jmotion.superpixel_adjacency(jnp.asarray(tps.labels),
                                                  12, 16, 16))
    ys, xs = np.nonzero(mover)
    boxes = np.array([
        [xs.min(), ys.min(), xs.max(), ys.max()],       # the mover
        [10.0, 20.0, 120.0, 150.0],                     # the wall corner
        [-30.0, -30.0, 40.0, 25.0],                     # off the image
        [200.0, 0.0, 260.0, 190.0],                     # invalid box
    ], np.float32)
    valid = np.array([True, True, True, False])
    args = (adj, tps.stats.centroid, frame.positions.reshape(12, 16, 3),
            frame.confidences.reshape(12, 16), tps.labels)
    dj = np.asarray(jax.jit(jmotion.person_flood_fill,
                            static_argnames=("gh", "gw", "cs", "n_iters"))(
        jnp.asarray(boxes), jnp.asarray(valid), *map(jnp.asarray, args),
        gh=12, gw=16, cs=16, n_iters=n_iters))
    dt = tmotion.person_flood_fill(_t(boxes), _t(valid), *map(_t, args),
                                   gh=12, gw=16, cs=16, n_iters=n_iters)
    np.testing.assert_array_equal(dt.numpy(), dj)
    assert dj.sum() >= 4


@pytest.mark.parametrize("yolo", [False, True], ids=["simple", "combined"])
def test_detect_motion_matches_jax(yolo):
    """Frames 2 and 3 of the dynamic clip, each from the JAX package's
    previous context. is_static_sp and static_kp are exact."""
    cfg = mod_config(tcfg, yolo)
    det = convert.detector_from_numpy(jpd.load_params(WEIGHTS)) \
        if yolo else None
    n_dyn = 0
    for k in (2, 3):
        ins, prev, (sj, kj, pj), mover = mod_sequence(yolo)[k]
        st, kt, pt = tmotion.detect_motion(
            *_port_args(ins, prev), cfg.cam, cfg.tps, cfg.mod, detector=det)
        np.testing.assert_array_equal(st.numpy(), sj, err_msg=str(k))
        np.testing.assert_array_equal(kt.numpy(), kj, err_msg=str(k))
        for f in tmotion.MODPrev._fields:
            a, b = getattr(pt, f).numpy(), getattr(pj, f)
            if b.dtype == np.uint32:
                b = b.view(np.int32)
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
        n_dyn += int((~sj).sum())
        scores = synthetic.mover_scores(ins[4].labels, sj, mover)
        assert scores["mover_dynamic"] > 0, scores
    assert n_dyn > 0


def test_first_frame_marks_nothing_without_persons():
    ins, prev, (sj, kj, _), _ = mod_sequence(False)[0]
    cfg = mod_config(tcfg, False)
    st, kt, pt = tmotion.detect_motion(*_port_args(ins, prev), cfg.cam,
                                       cfg.tps, cfg.mod)
    np.testing.assert_array_equal(st.numpy(), sj)
    assert st.all() and bool(pt.initialized)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(ins[2].valid))


def _heat_cases():
    """The JAX package's heat tests (tests/test_motion.py): fresh evidence
    at one cell then 25 frames without (identity motion, decay 0.85), and
    a 32 px pan (decay 0.95) of a hot cell; plus a rotating, scaling
    motion and a failed warp. Each a list of (prev heat, fresh, a, b, tx,
    ty, warp_ok) steps; a None heat continues from the previous step."""
    gh, gw = 6, 8
    fresh = np.zeros((gh, gw), bool)
    fresh[2, 3] = True
    none = np.zeros((gh, gw), bool)
    zero = np.zeros((gh, gw), np.float32)
    ident = (1.0, 0.0, 0.0, 0.0)
    hot = zero.copy()
    hot[3, 2] = 1.0
    warm = np.random.default_rng(5).random((gh, gw)).astype(np.float32)
    return {
        "persistence": (0.85, [(zero, fresh, *ident, True)]
                        + [(None, none, *ident, True)] * 25),
        "pan": (0.95, [(hot, none, 1.0, 0.0, 32.0, 0.0, True)]),
        "rotate_scale": (0.85, [(warm, fresh, 0.97, 0.05, 5.5, -3.25, True),
                                (None, none, 1.02, -0.03, -7.0, 2.0, True)]),
        "no_warp": (0.85, [(warm, fresh, 0.9, 0.2, 30.0, 10.0, False)]),
    }


@pytest.mark.parametrize("case", ["persistence", "pan", "rotate_scale",
                                  "no_warp"])
def test_heat_update_matches_jax(case):
    """`heat_update` step by step against JAX: the marks exact, the heat
    within 1e-6; the persistence case keeps its cell 5-9 frames, the pan
    moves the heat by 2 cells, as the JAX package's own tests require."""
    decay, steps = _heat_cases()[case]
    jc = jcfg.MODConfig(temporal_heat=True, heat_decay=decay,
                        heat_thresh=0.3)
    tc = tcfg.MODConfig(temporal_heat=True, heat_decay=decay,
                        heat_thresh=0.3)
    marks = []
    hj = ht = None
    for heat, fresh, a, b, tx, ty, ok in steps:
        if heat is not None:
            hj, ht = jnp.asarray(heat), _t(heat)
        mj, hj = jmotion.heat_update(hj, jnp.asarray(fresh), a, b, tx, ty,
                                     ok, 16, jc)
        mt, ht = tmotion.heat_update(ht, _t(fresh), a, b, tx, ty, ok, 16,
                                     tc)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                                   atol=1e-6)
        marks.append(mt.numpy())
    if case == "persistence":
        n = next(i for i, m in enumerate(marks[1:]) if not m[2, 3])
        assert 5 <= n <= 9 and not marks[-1].any()
    if case == "pan":
        assert marks[0][3, 4] and not marks[0][3, 2]


@functools.lru_cache(maxsize=None)
def heat_sequence(n: int = 6):
    """JAX `detect_motion` with temporal heat over the first n dynamic
    frames (combined path: the person boxes seed the heat), each from
    JAX's previous context."""
    cfg = mod_config(jcfg, True)
    cfg = dataclasses.replace(cfg, mod=dataclasses.replace(
        cfg.mod, temporal_heat=True))
    params = jpd.load_params(WEIGHTS)
    seq = mod_sequence(True, n)
    prev = seq[0][1]
    out = []
    for ins, _, _, _ in seq:
        res = jax.tree.map(np.asarray, _jax_detect(
            *ins[:2], prev, *ins[2:], params, cfg))
        out.append((ins, prev, res))
        prev = res[2]
    return out


def test_detect_motion_with_temporal_heat_matches_jax(monkeypatch):
    """`detect_motion` with `mod.temporal_heat` (combined path) over six
    dynamic frames, each from JAX's previous context: is_static_sp and
    static_kp exact; the heat keeps superpixels dynamic that the frame's
    own cues no longer mark.

    The carried heat is within 1e-6 of JAX's `heat_update` on the port's
    own inputs, and within 1e-5 of JAX's `detect_motion`: the heat is
    warped by the camera-motion similarity, whose tx and ty the two
    packages fit up to 1e-3 px apart (the recorded tolerance of
    `flow.estimate_similarity_ransac`, ROADMAP Queue 3), and a heat map's
    slope is at most 1/16 per pixel."""
    cfg = mod_config(tcfg, True)
    mod = dataclasses.replace(cfg.mod, temporal_heat=True)
    jmod = dataclasses.replace(mod_config(jcfg, True).mod,
                               temporal_heat=True)
    det = convert.detector_from_numpy(jpd.load_params(WEIGHTS))
    calls = []

    def spy(*args):
        calls.append(args)
        return heat_update(*args)

    heat_update = tmotion.heat_update
    monkeypatch.setattr(tmotion, "heat_update", spy)
    n_kept = 0
    for k, (ins, prev, (sj, kj, pj)) in enumerate(heat_sequence()):
        args = _port_args(ins, prev)
        st, kt, pt = tmotion.detect_motion(*args, cfg.cam, cfg.tps, mod,
                                           detector=det)
        np.testing.assert_array_equal(st.numpy(), sj, err_msg=str(k))
        np.testing.assert_array_equal(kt.numpy(), kj, err_msg=str(k))
        np.testing.assert_allclose(pt.heat.numpy(), pj.heat, rtol=0,
                                   atol=1e-5, err_msg=str(k))
        ph, fresh, a, b, tx, ty, ok, cs, _ = calls[-1]
        _, hj = jmotion.heat_update(
            jnp.asarray(ph.numpy()), jnp.asarray(fresh.numpy()),
            *(jnp.asarray(v.numpy()) for v in (a, b, tx, ty, ok)), cs, jmod)
        np.testing.assert_allclose(pt.heat.numpy(), np.asarray(hj), rtol=0,
                                   atol=1e-6, err_msg=str(k))
        # the same input without the heat
        s_off, _, _ = tmotion.detect_motion(*args, cfg.cam, cfg.tps,
                                            cfg.mod, detector=det)
        n_kept += int((~st & s_off).sum())
    assert len(calls) == 6 and n_kept > 0


@pytest.mark.parametrize("case", ["simple", "combined", "combined_heat",
                                  "no_depth_cue"])
def test_detect_motion_parts_equal_the_whole(case, monkeypatch):
    """`detect_motion`, cut into the parts `mod.a`, `mod.b`, `mod.c`
    around the rigid RANSAC's two SVDs, gives every output bit for bit as
    the function before the cut (`mod_unsplit.py`) on the dynamic clip's
    first four frames, each from the JAX package's previous context (the
    first one uninitialised); without the depth cue there is no `mod.b`
    and no SVD. In a frame the parts and the SVDs are recorder spans,
    counted as parts and ops run op by op."""
    from mod_unsplit import detect_motion_whole

    from supersurfel_fusion_tpu_torch import tracing

    yolo = case != "simple" and case != "no_depth_cue"
    cfg = mod_config(tcfg, yolo)
    mod = cfg.mod
    if case == "combined_heat":
        mod = dataclasses.replace(mod, temporal_heat=True)
    if case == "no_depth_cue":
        mod = dataclasses.replace(mod, depth_cue_scale_simple=0.0)
    det = convert.detector_from_numpy(jpd.load_params(WEIGHTS)) \
        if yolo else None
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    for k, (ins, prev, _, _) in enumerate(mod_sequence(yolo)):
        args = (*_port_args(ins, prev), cfg.cam, cfg.tps, mod)
        with tracing.frame():
            got = tmotion.detect_motion(*args, detector=det)
        want = detect_motion_whole(*args, detector=det)
        for name, a, b in zip(("is_static_sp", "static_kp", "prev"),
                              got, want):
            for f, x, y in zip(getattr(a, "_fields", [name]),
                               a if name == "prev" else [a],
                               b if name == "prev" else [b]):
                assert x.dtype == y.dtype and torch.equal(x, y), (k, f)
    frames = tracing.frames()
    parts = (["mod.a", "mod.c"] if case == "no_depth_cue"
             else ["mod.a", "mod.svd", "mod.b", "mod.svd", "mod.c"])
    for f in frames:
        assert [n for n, p, *_ in f.spans if p == 0] == parts
        assert (f.counts.get("part.replay", 0), f.counts["part.eager"],
                f.counts.get("eager_op", 0)) == (
            0, len(parts) - parts.count("mod.svd"), parts.count("mod.svd"))
    assert len(frames) == 4

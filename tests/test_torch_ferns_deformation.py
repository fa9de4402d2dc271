"""PyTorch port vs the JAX package: fern place recognition (table, codes,
query, keyframe store) and the deformation graph (graph, bindings,
Gauss-Newton, model update), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu.ops import deformation as jdefo
from supersurfel_fusion_tpu.ops import ferns as jferns
from supersurfel_fusion_tpu.ops.depth import bilateral_filter as jbilateral
from supersurfel_fusion_tpu.types import Supersurfels as JSurfels
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.pipeline import FernLookup
from supersurfel_fusion_tpu_torch.ops import deformation as tdefo
from supersurfel_fusion_tpu_torch.ops import ferns as tferns
from supersurfel_fusion_tpu_torch.types import Supersurfels as TSurfels

from test_torch_pipeline import small_config

torch.set_num_threads(1)

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------------
# ferns
# --------------------------------------------------------------------------


@pytest.mark.parametrize("wh", [(640, 480), (256, 192)])
def test_fern_table_equals_jax(wh):
    cfg = tcfg.FernsConfig()
    jt = jferns.make_fern_table(jcfg.FernsConfig(), *wh, 5.0)
    tt = tferns.make_fern_table(cfg, *wh, 5.0, "cpu")
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), _np(a))
        assert b.numpy().dtype == _np(a).dtype


def _structured_scenes(H=480, W=640):
    """The two clearly distinct scenes of the JAX fern test."""
    y, x = np.mgrid[0:H, 0:W]
    rgb1 = np.stack([(x // 80 % 2) * 255.0, (y // 80 % 2) * 255.0,
                     np.full((H, W), 30.0)], -1).astype(np.float32)
    rgb2 = np.stack([np.full((H, W), 200.0), (x // 40 % 2) * 255.0,
                     ((x + y) // 60 % 2) * 255.0], -1).astype(np.float32)
    d1 = np.where((x // 100 % 2) > 0, 1.0, 3.5).astype(np.float32)
    d2 = np.where((y // 60 % 2) > 0, 4.5, 0.7).astype(np.float32)
    return [(rgb1, d1), (rgb2, d2)]


def _synthetic_scenes(cfg):
    """Revisit-clip frames (raw and bilateral-filtered depth, in metres)."""
    out = []
    for R, t in synthetic.revisit_trajectory()[::8]:
        rgb, depth = synthetic.render(cfg.cam, R, t)
        d = depth.astype(np.float32) * np.float32(cfg.depth_scale)
        fd = _np(jbilateral(jnp.asarray(d), cfg.bilateral_sigma_value,
                            cfg.bilateral_sigma_space, cfg.bilateral_radius))
        out += [(rgb.astype(np.float32), d), (rgb.astype(np.float32), fd)]
    return out


@pytest.mark.parametrize("scene", ["structured", "synthetic-640",
                                   "synthetic-256"])
def test_compute_codes_equal_jax(scene):
    """The codes compare the shrunk image with integer thresholds: they
    must equal JAX's exactly."""
    if scene == "structured":
        frames, (W, H) = _structured_scenes(), (640, 480)
    else:
        cfg = tcfg.PipelineConfig() if scene.endswith("640") \
            else small_config(tcfg)
        frames, (W, H) = _synthetic_scenes(cfg), (cfg.cam.width,
                                                  cfg.cam.height)
    fc = tcfg.FernsConfig()
    jt = jferns.make_fern_table(jcfg.FernsConfig(), W, H, 5.0)
    tt = tferns.make_fern_table(fc, W, H, 5.0, "cpu")
    n_distinct = set()
    for rgb, d in frames:
        jc = _np(jferns.compute_codes(jnp.asarray(rgb), jnp.asarray(d), *jt,
                                      fc.pyramid_level))
        tc = tferns.compute_codes(T(rgb), T(d), *tt, fc.pyramid_level)
        assert tc.dtype == torch.uint8
        np.testing.assert_array_equal(tc.numpy(), jc)
        n_distinct.add(jc.tobytes())
    assert len(n_distinct) == len(frames) or scene != "structured"


def _jdb(max_kf, n):
    return jferns.FernDB.empty(max_kf, n)


def _tdb(max_kf, n):
    return tferns.FernDB.empty(max_kf, n, "cpu")


def _assert_db_equal(tdb, jdb):
    for f in jferns.FernDB._fields:
        np.testing.assert_array_equal(getattr(tdb, f).numpy(),
                                      _np(getattr(jdb, f)), err_msg=f)


def _query_both(tdb, jdb, codes, thresh=0.3095):
    jb, jd, jn = jferns.query(jdb, jnp.asarray(codes), thresh)
    tb, td, tn = tferns.query(tdb, T(codes), thresh)
    assert int(tb) == int(jb)
    assert float(td) == float(jd)
    assert bool(tn) == bool(jn)
    return int(tb), float(td), bool(tn)


def test_query_agrees_empty_tie_and_full():
    rng = np.random.default_rng(5)
    n, max_kf = 500, 4
    codes = [rng.integers(0, 16, n).astype(np.uint8) for _ in range(6)]
    jdb, tdb = _jdb(max_kf, n), _tdb(max_kf, n)
    # empty store: dissimilarity 1, a new frame
    assert _query_both(tdb, jdb, codes[0]) == (0, 1.0, True)
    eye = np.eye(3, dtype=np.float32)
    # a tie: the same codes stored twice, the first one wins
    for k, c in enumerate([codes[1], codes[0], codes[0]]):
        jdb = jferns.add_keyframe(jdb, jnp.asarray(c), jnp.asarray(eye),
                                  jnp.zeros(3), jnp.int32(k))
        tdb = tferns.add_keyframe(tdb, T(c), T(eye), torch.zeros(3),
                                  torch.tensor(k, dtype=torch.int32))
    assert _query_both(tdb, jdb, codes[0]) == (1, 0.0, False)
    near = codes[0].copy()
    near[:100] = (near[:100] + 1) % 16
    assert _query_both(tdb, jdb, near)[:2] == (1, float(np.float32(0.2)))
    # full store
    jdb = jferns.add_keyframe(jdb, jnp.asarray(codes[2]), jnp.asarray(eye),
                              jnp.zeros(3), jnp.int32(3))
    tdb = tferns.add_keyframe(tdb, T(codes[2]), T(eye), torch.zeros(3),
                              torch.tensor(3, dtype=torch.int32))
    assert int(tdb.count) == max_kf
    assert _query_both(tdb, jdb, codes[2])[:2] == (3, 0.0)
    assert _query_both(tdb, jdb, codes[5])[2]


@pytest.mark.parametrize("shut", [None, "new keyframe", "empty store",
                                  "same keyframe", "closure within gap",
                                  "keyframe within gap"])
def test_fern_gate_needs_all_five_conditions(shut):
    """The loop-closure gate both frame steps read (`FernLookup.gate`):
    frame 100 with a gap of 10 fires against keyframe 2 of 3, stamped 89,
    after a closure at 89 and a lookup of keyframe 1 last frame; each one
    condition failed keeps it shut (a closure or keyframe exactly `gap`
    frames back is too recent)."""
    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    fl = FernLookup(None, i32(2), torch.tensor(shut == "new keyframe"),
                    None, None)
    fire = fl.gate(i32(0 if shut == "empty store" else 3),
                   i32(90 if shut == "keyframe within gap" else 89),
                   i32(2 if shut == "same keyframe" else 1), i32(100),
                   i32(90 if shut == "closure within gap" else 89), 10)
    assert fire is (shut is None)


def test_add_keyframe_past_capacity():
    rng = np.random.default_rng(6)
    n, max_kf = 64, 3
    jdb, tdb = _jdb(max_kf, n), _tdb(max_kf, n)
    for k in range(5):
        c = rng.integers(0, 16, n).astype(np.uint8)
        R = rng.normal(size=(3, 3)).astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        jdb = jferns.add_keyframe(jdb, jnp.asarray(c), jnp.asarray(R),
                                  jnp.asarray(t), jnp.int32(10 + k))
        tdb = tferns.add_keyframe(tdb, T(c), T(R), T(t),
                                  torch.tensor(10 + k, dtype=torch.int32))
        _assert_db_equal(tdb, jdb)
    assert int(tdb.count) == max_kf
    # a masked add changes nothing
    tdb2 = tferns.add_keyframe(_tdb(max_kf, n), T(c), T(R), T(t),
                               torch.tensor(1, dtype=torch.int32),
                               when=torch.tensor(False))
    _assert_db_equal(tdb2, _jdb(max_kf, n))


# --------------------------------------------------------------------------
# deformation graph
# --------------------------------------------------------------------------


def line_model(n=400):
    """Surfels along a line with increasing stamps (a 'corridor'), as in
    tests/test_deformation.py."""
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.linspace(0, 4, n)
    return pos, np.arange(n, dtype=np.int32)


def random_model(n_cap, nb_live, seed):
    """Random positions and birth stamps with many ties (as a real model's
    frame-wise births give), over a capacity with a live prefix."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n_cap, 3)).astype(np.float32)
    st = np.sort(rng.integers(0, 40, n_cap)).astype(np.int32)
    st = rng.permutation(st)
    return pos, st, nb_live


def _graphs(pos, st, nb_live):
    jg = jdefo.build_graph(jnp.asarray(pos), jnp.asarray(st),
                           jnp.ones(len(pos), bool), jnp.int32(nb_live))
    tg = tdefo.build_graph(T(pos), T(st),
                           torch.tensor(nb_live, dtype=torch.int32))
    return jg, tg


GRAPH_CASES = {
    "line": (*line_model(), 400),
    "random-prefix-1000": random_model(4096, 1000, 1),
    "random-prefix-100": random_model(512, 100, 2),
    "random-prefix-3": random_model(64, 3, 3),
    "empty": random_model(64, 0, 4),
}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_build_graph_exact(case):
    jg, tg = _graphs(*GRAPH_CASES[case])
    for f in jdefo.DeformationGraph._fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      _np(getattr(jg, f)), err_msg=f)
    for n in (0, 1, 3, 5, 6, 100, 256):
        np.testing.assert_array_equal(
            tdefo._temporal_neighbours(torch.tensor(n, dtype=torch.int32))
            .numpy(), _np(jdefo._temporal_neighbours(jnp.int32(n))))


def _random_transforms(seed, scale=0.05):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(jdefo.NODE_CAP, 3)) * scale
    rot = np.stack([synthetic.axis_angle(v, np.linalg.norm(v))
                    if np.linalg.norm(v) > 0 else np.eye(3) for v in w])
    trans = rng.normal(size=(jdefo.NODE_CAP, 3)) * scale
    return rot.astype(np.float32), trans.astype(np.float32)


@pytest.mark.parametrize("case", ["line", "random-prefix-1000",
                                  "random-prefix-3"])
def test_bind_vertices_blends_as_jax(case):
    """Node ids may differ where window candidates tie (infinite distances
    in windows of fewer than 5 nodes get weight 0), so the test compares
    the weights as sorted per vertex and the blended positions: within
    1e-5 (weights) and 1e-5 m (positions)."""
    pos, st, nb = GRAPH_CASES[case]
    jg, tg = _graphs(pos, st, nb)
    rng = np.random.default_rng(9)
    V = 300
    v = (pos[rng.integers(0, max(nb, 1), V)]
         + rng.normal(size=(V, 3)) * 0.05).astype(np.float32)
    vs = st[rng.integers(0, max(nb, 1), V)]
    vs[:5] = [0, 2**30, -5, 39, 1000]
    valid = rng.random(V) > 0.1
    rot, trans = _random_transforms(11)
    for lb in (15, 10):
        jb = jdefo.bind_vertices(jg, jnp.asarray(v), jnp.asarray(vs),
                                 jnp.asarray(valid), look_back=lb)
        tb = tdefo.bind_vertices(tg, T(v), T(vs), T(valid), look_back=lb)
        np.testing.assert_allclose(np.sort(tb.weights.numpy(), -1),
                                   np.sort(_np(jb.weights), -1), atol=1e-5)
        np.testing.assert_allclose(tb.weights.numpy().sum(-1),
                                   valid.astype(np.float32), atol=1e-5)
        jp = _np(jdefo.blend_positions(jg.positions, jnp.asarray(rot),
                                       jnp.asarray(trans), jb,
                                       jnp.asarray(v)))
        tp = tdefo.blend_positions(tg.positions, T(rot), T(trans), tb,
                                   T(v)).numpy()
        np.testing.assert_allclose(tp, jp, atol=1e-5)


def _drifted_end_case():
    """tests/test_deformation.py's corridor: the start pinned, the last 16
    constraints shifted by 0.2 m."""
    pos, stamps = line_model()
    src_idx = np.concatenate([np.arange(16), len(pos) - 16 + np.arange(16)])
    src = pos[src_idx]
    tgt = src.copy()
    tgt[16:, 1] += 0.2
    return pos, stamps, src, tgt, stamps[src_idx], np.ones(32, bool), 5


def _identity_case():
    pos, stamps = line_model()
    src = pos[:16]
    return pos, stamps, src, src, stamps[:16], np.ones(16, bool), 3


@pytest.mark.parametrize("case", ["identity", "drifted-end"])
def test_optimise_agrees_with_jax(case):
    """Both packages run the same Gauss-Newton steps; JAX solves the
    normal equations in f32, the port in f64. On the drifted corridor
    JAX's rotations and translations lie up to 2.4e-4 from an f64
    evaluation of the same steps (the port in f64 throughout), so they are
    held within 3e-4 of JAX's and no farther from the f64 evaluation than
    JAX is; the error within 1e-2 relative (plus 1e-7) and the mean
    constraint error within 1e-6 m."""
    pos, stamps, src, tgt, cst, cvalid, n_iters = (
        _identity_case() if case == "identity" else _drifted_end_case())
    jg, tg = _graphs(pos, stamps, len(pos))
    jb = jdefo.bind_vertices(jg, jnp.asarray(src), jnp.asarray(cst),
                             jnp.asarray(cvalid))
    tb = tdefo.bind_vertices(tg, T(src), T(cst), T(cvalid))
    jr = jdefo.optimise(jg, jb, jnp.asarray(src), jnp.asarray(tgt),
                        jnp.asarray(cvalid), n_iters=n_iters)
    tr = tdefo.optimise(tg, tb, T(src), T(tgt), T(cvalid), n_iters=n_iters)
    g64 = tdefo.DeformationGraph(*(a.double() if a.is_floating_point()
                                   else a for a in tg))
    b64 = tdefo.VertexBinding(tb.nodes, tb.weights.double())
    rr = tdefo.optimise(g64, b64, T(src).double(), T(tgt).double(),
                        T(cvalid), n_iters=n_iters)
    jrot, jtrans, jerr, jcerr = (_np(a) for a in jr)
    trot, ttrans, terr, tcerr = (a.numpy() for a in tr)
    for t_, j_, r_ in ((trot, jrot, rr[0]), (ttrans, jtrans, rr[1])):
        np.testing.assert_allclose(t_, j_, atol=3e-4)
        r_ = r_.numpy()
        assert np.abs(t_ - r_).max() <= max(np.abs(j_ - r_).max(), 1e-6)
    np.testing.assert_allclose(terr, jerr, rtol=1e-2, atol=1e-7)
    np.testing.assert_allclose(tcerr, jcerr, atol=1e-6)
    if case == "identity":
        assert float(tcerr) < 1e-4
    else:
        assert float(tcerr) < 0.02


def test_apply_to_model_agrees_with_jax():
    """The drifted corridor's solution applied to the whole model, from the
    same rotations and translations: positions, orientations and shapes
    within 1e-5."""
    pos, stamps = line_model()
    n = len(pos)
    rng = np.random.default_rng(3)
    rot, trans = _random_transforms(4, scale=0.1)
    ori = np.stack([synthetic.axis_angle(v, np.linalg.norm(v))
                    for v in rng.normal(size=(n, 3))]).astype(np.float32)
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    shapes = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    jm = JSurfels.empty(n)._replace(
        positions=jnp.asarray(pos), orientations=jnp.asarray(ori),
        shapes=jnp.asarray(shapes),
        confidences=jnp.ones(n, jnp.float32),
        stamps=jnp.asarray(np.stack([stamps, stamps], -1)))
    tm = TSurfels.empty(n, "cpu")._replace(
        positions=T(pos), orientations=T(ori), shapes=T(shapes),
        confidences=torch.ones(n),
        stamps=T(np.stack([stamps, stamps], -1)))
    jg, tg = _graphs(pos, stamps, n)
    jb = jdefo.bind_vertices(jg, jm.positions, jm.stamps[:, 0],
                             jnp.ones(n, bool))
    tb = tdefo.bind_vertices(tg, tm.positions, tm.stamps[:, 0],
                             torch.ones(n, dtype=bool))
    mask = rng.random(n) > 0.2
    jo = jdefo.apply_to_model(jm, jg.positions, jnp.asarray(rot),
                              jnp.asarray(trans), jb, jnp.asarray(mask))
    to = tdefo.apply_to_model(tm, tg.positions, T(rot), T(trans), tb,
                              T(mask))
    for f in ("positions", "orientations", "shapes"):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   _np(getattr(jo, f)), atol=1e-5,
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(to.positions.numpy()[~mask], pos[~mask])

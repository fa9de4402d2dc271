"""PyTorch port vs the JAX package: map sharding over 2 ranks. The port's
ranks are 2 spawned processes over gloo (`parallel.distributed.launch`);
the JAX package runs the same scenes on `make_mesh(2)` (conftest gives 8
virtual CPU devices). The scenes are tests/test_sharding.py's: the
sharded fusion update and round-robin insertion, the sharded keyframe
store, the distributed graph build, the summed ICP system and the
distributed graph solve. All scenarios run in one spawn of the two
ranks (`torch_parallel_ranks.sharding_cases`); `mesh.dryrun(2)` is in
test_torch_pipeline_sharded.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from supersurfel_fusion_tpu import config as jcfg
from supersurfel_fusion_tpu.ops import deformation as jdefo
from supersurfel_fusion_tpu.ops import ferns as jferns
from supersurfel_fusion_tpu.ops import icp as jicp
from supersurfel_fusion_tpu.ops.loop_closure import KeyframeStore as JStore
from supersurfel_fusion_tpu.parallel import ba as jba
from supersurfel_fusion_tpu.parallel import kf_sharded as jkfs
from supersurfel_fusion_tpu.parallel.mesh import make_mesh
from supersurfel_fusion_tpu.parallel.sharding import (
    make_distributed_model,
    make_sharded_update,
)
from supersurfel_fusion_tpu.types import Supersurfels as JSurfels
from supersurfel_fusion_tpu.utils.color import rgb_to_lab as jlab
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch.ops import deformation as tdefo
from supersurfel_fusion_tpu_torch.ops import icp as ticp
from supersurfel_fusion_tpu_torch.parallel.distributed import launch
from supersurfel_fusion_tpu_torch.types import Supersurfels as TSurfels

import torch_parallel_ranks

torch.set_num_threads(1)

D = 2
T = torch.from_numpy
SURFEL_FIELDS = JSurfels._fields


# --------------------------------------------------------------------------
# scenes (tests/test_sharding.py's, as numpy)
# --------------------------------------------------------------------------

F = 48


def _cam(C):
    return C.CameraIntrinsics(fx=80.0, fy=80.0, cx=39.5, cy=29.5, width=80,
                              height=60)


def _synth_frame(rng, stamp, t, z=1.5):
    gx = rng.uniform(5, 75, F)
    gy = rng.uniform(5, 55, F)
    pos = np.zeros((F, 3), np.float32)
    pos[:, 0] = (gx - 39.5) * z / 80.0
    pos[:, 1] = (gy - 29.5) * z / 80.0
    pos[:, 2] = z
    yy, xx = np.mgrid[0:60, 0:80]
    d = ((xx[None] - gx[:, None, None]) ** 2
         + (yy[None] - gy[:, None, None]) ** 2)
    frame = dict(
        positions=pos, colors=np.full((F, 3), 120.0, np.float32),
        stamps=np.zeros((F, 2), np.int32),
        orientations=np.tile(np.eye(3, dtype=np.float32), (F, 1, 1)),
        shapes=np.tile(np.eye(3, dtype=np.float32) * 1e-4, (F, 1, 1)),
        dims=np.zeros((F, 2), np.float32),
        confidences=np.full((F,), 200.0, np.float32))
    return dict(frame=frame,
                labels=np.argmin(d, axis=0).astype(np.int32),
                pd=np.full((60, 80), 1.5, np.float32),
                R=np.eye(3, dtype=np.float32),
                t=np.asarray(t, np.float32), stamp=stamp)


def fusion_scene():
    """The same frame three times, the third from a camera moved 2 cm."""
    rng = np.random.default_rng(1234)
    f0 = _synth_frame(rng, 0, [0.0, 0.0, 0.0])
    frames = [f0, dict(f0, stamp=1), dict(f0, stamp=2,
                                          t=np.float32([0.02, 0.0, 0.0]))]
    return frames, 64 * D


def round_robin_scene():
    """Three frames from far-apart poses: nothing re-projects, each frame
    inserts on rank stamp mod D."""
    rng = np.random.default_rng(77)
    return [_synth_frame(rng, k, [100.0 * k, 0.0, 0.0]) for k in range(3)], \
        256 * D


MAX_KF, NF, KP, F2 = 32, 64, 16, 24


def keyframe_scene():
    rng = np.random.default_rng(11)
    kfs = []
    for k in range(21):
        kfs.append(dict(
            codes=rng.integers(0, 16, NF).astype(np.uint8),
            R=np.eye(3, dtype=np.float32),
            t=rng.normal(size=3).astype(np.float32),
            stamp=np.int32(k * 7),
            kp_xy=rng.uniform(0, 640, (KP, 2)).astype(np.float32),
            kp_p3d=rng.normal(size=(KP, 3)).astype(np.float32),
            kp_desc=rng.integers(0, 2**32, (KP, 8), dtype=np.uint64
                                 ).astype(np.uint32),
            kp_valid=rng.random(KP) > 0.3,
            sf_pos=rng.normal(size=(F2, 3)).astype(np.float32),
            sf_normal=rng.normal(size=(F2, 3)).astype(np.float32),
            sf_color=rng.uniform(0, 255, (F2, 3)).astype(np.float32),
            sf_valid=rng.random(F2) > 0.2))
    q = kfs[13]["codes"].copy()
    q[:5] = rng.integers(0, 16, NF).astype(np.uint8)[:5]
    return kfs, q


def graph_cases():
    rng = np.random.default_rng(3)
    C = 1024
    pos = rng.uniform(-1, 1, size=(C, 3)).astype(np.float32)
    st = np.sort(rng.integers(0, 500, size=(C,)).astype(np.int32))
    return [(pos, st, np.int32([C // D] * D)),
            (pos, st, np.int32([300, 100])),
            (pos, st, np.int32([50, 3])),
            (pos, st, np.int32([0, 0]))]


def icp_scene():
    """A tilted plane seen from 1 m, 64 surfels per rank, and a start
    pose 2 cm and 1 degree off."""
    cam = jcfg.CameraIntrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5,
                                width=64, height=48)
    C = 64 * D
    rng = np.random.default_rng(5)
    pos = np.zeros((C, 3), np.float32)
    pos[:, 0] = rng.uniform(-0.4, 0.4, C)
    pos[:, 1] = rng.uniform(-0.3, 0.3, C)
    pos[:, 2] = 1.0 + 0.1 * pos[:, 0] + 0.15 * pos[:, 1] ** 2
    nrm = np.stack([-0.1 * np.ones(C), -0.3 * pos[:, 1], np.ones(C)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ori = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    ori[:, 2, :] = nrm
    model = dict(positions=pos, colors=np.full((C, 3), 128.0, np.float32),
                 stamps=np.zeros((C, 2), np.int32), orientations=ori,
                 shapes=np.zeros((C, 3, 3), np.float32),
                 dims=np.zeros((C, 2), np.float32),
                 confidences=np.where(rng.random(C) > 0.1, 1.0, -1.0
                                      ).astype(np.float32))
    H, W = cam.height, cam.width
    tm = np.zeros((H, W, 10), np.float32)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    xn, yn = (x - cam.cx) / cam.fx, (y - cam.cy) / cam.fy
    z = 1.0 / (1.0 - 0.1 * xn)          # the plane z = 1 + 0.1 x
    tm[..., 0], tm[..., 1], tm[..., 2] = xn * z, yn * z, z
    n = np.array([-0.1, 0.0, 1.0]) / np.linalg.norm([-0.1, 0.0, 1.0])
    tm[..., 3:6] = n
    tm[..., 6] = 53.4                   # Lab of RGB (128, 128, 128)
    tm[..., 9] = 1.0
    a = np.deg2rad(1.0)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]], np.float32)
    t = np.float32([0.02, -0.01, 0.0])
    return cam, model, tm, R, t


def solve_scene():
    """tests/test_sharding.py's corridor: 400 surfels along a line, the
    first 16 constraints pinned, the last 16 moved 0.2 m."""
    n = 400
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.linspace(0, 4, n)
    stamps = np.arange(n, dtype=np.int32)
    src_idx = np.concatenate([np.arange(16), n - 16 + np.arange(16)])
    src = pos[src_idx]
    tgt = src.copy()
    tgt[16:, 1] += 0.2
    return pos, stamps, src, tgt, stamps[src_idx], np.ones(32, bool), 3


def _icp_cfg(C):
    return C.ICPConfig(min_inliers=4.0, cov_thresh=1e9)


def _port_graph(pos, stamps, src, cst, valid):
    g = tdefo.build_graph(T(pos), T(stamps),
                          torch.tensor(len(pos), dtype=torch.int32))
    return g, tdefo.bind_vertices(g, T(src), T(cst), T(valid))


@pytest.fixture(scope="module")
def scenes():
    ff, fcap = fusion_scene()
    rr, rcap = round_robin_scene()
    kfs, q = keyframe_scene()
    cam, model, tm, R, t = icp_scene()
    pos, stamps, src, tgt, cst, valid, iters = solve_scene()
    g, b = _port_graph(pos, stamps, src, cst, valid)
    tcam = tcfg.CameraIntrinsics(**{k: getattr(cam, k) for k in (
        "fx", "fy", "cx", "cy", "width", "height")})
    return {
        "fusion": dict(frames=ff, cam=_cam(tcfg), cfg=tcfg.FusionConfig(
            nb_supersurfels_max=fcap, delta_t=1000)),
        "round_robin": dict(frames=rr, cam=_cam(tcfg), cfg=tcfg.FusionConfig(
            nb_supersurfels_max=rcap, delta_t=1000)),
        "keyframes": dict(keyframes=kfs, query=q, thresh=0.3095,
                          max_kf=MAX_KF, n_ferns=NF, kp=KP, f=F2),
        "graphs": dict(graph_cases=graph_cases()),
        "icp": dict(icp_cam=tcam, icp_model=model, icp_maps=tm, icp_R=R,
                    icp_t=t, icp_cfg=_icp_cfg(tcfg)),
        "solve": dict(ba_graph=[a.numpy() for a in g],
                      ba_binding=[a.numpy() for a in b], ba_src=src,
                      ba_tgt=tgt, ba_valid=valid, ba_iters=iters),
    }


@pytest.fixture(scope="module")
def port(scenes):
    """Every scenario on 2 gloo ranks, in one spawn."""
    return launch(torch_parallel_ranks.sharding_cases, D, backend="gloo",
                  device="cpu", args=(scenes,))


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < D:
        pytest.skip("needs 2 JAX devices")
    return make_mesh(D)


def _jframe(f):
    return JSurfels(*(jnp.asarray(f["frame"][k]) for k in SURFEL_FIELDS))


def _jax_fusion(jmesh, frames, cap):
    cfg = jcfg.FusionConfig(nb_supersurfels_max=cap, delta_t=1000)
    dm = make_distributed_model(cap, jmesh)
    step = make_sharded_update(jmesh, _cam(jcfg), cfg, conf_thresh=1e9)
    out = []
    for f in frames:
        dm = step(dm, _jframe(f), jnp.asarray(f["labels"]),
                  jnp.asarray(f["pd"]), jnp.asarray(f["R"]),
                  jnp.asarray(f["t"]), jnp.int32(f["stamp"]))
        out.append(jax.tree.map(np.asarray, jax.device_get(dm)))
    return out


def _check_fusion(port_ranks, jax_steps):
    for k, js in enumerate(jax_steps):
        counts = [(r[k]["nb_local"], r[k]["nb_visible_local"])
                  for r in port_ranks]
        assert counts == list(zip(js.nb_local.tolist(),
                                  js.nb_visible_local.tolist())), k
        for f in SURFEL_FIELDS:
            got = np.concatenate([r[k]["surfels"][f] for r in port_ranks])
            want = getattr(js.surfels, f)
            if f == "stamps":
                np.testing.assert_array_equal(got, want, err_msg=f"{k} {f}")
            else:
                # colours pass through Lab and back: 1e-5 relative
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{k} {f}")


def test_sharded_update_matches_jax(port, scenes, jmesh):
    """Three frames of the sharded model update: each rank's counts exact,
    the stamps exact, the other surfel fields within 1e-5 (absolute, or
    relative for the colours, 0..255); the repeated frame fuses into the first
    frame's surfels."""
    s = scenes["fusion"]
    js = _jax_fusion(jmesh, s["frames"], s["cfg"].nb_supersurfels_max)
    _check_fusion([r["fusion"] for r in port], js)
    assert sum(r["fusion"][0]["nb_local"] for r in port) == F
    assert sum(r["fusion"][1]["nb_local"] for r in port) == F


def test_sharded_insert_round_robin(port, scenes, jmesh):
    """Frames that never re-project insert on rank stamp mod 2: counts
    [2F, F], exactly as JAX's."""
    s = scenes["round_robin"]
    js = _jax_fusion(jmesh, s["frames"], s["cfg"].nb_supersurfels_max)
    _check_fusion([r["round_robin"] for r in port], js)
    assert [r["round_robin"][-1]["nb_local"] for r in port] == [2 * F, F]


def _jax_keyframes(jmesh, kfs, q):
    store_l = JStore.empty(MAX_KF // D, NF, KP, F2)
    leaves, tree = jax.tree.flatten(store_l)
    stacked = {k: jnp.asarray(np.stack([kd[k] for kd in kfs]))
               for k in kfs[0]}

    def run(store_leaves):
        store = jax.tree.unflatten(tree, store_leaves)

        def add(carry, kd):
            st, cnt = carry
            st, cnt = jkfs.add_keyframe_sharded(
                st, cnt, kd["codes"], kd["R"], kd["t"], kd["stamp"],
                kd["kp_xy"], kd["kp_p3d"], kd["kp_desc"], kd["kp_valid"],
                kd["sf_pos"], kd["sf_normal"], kd["sf_color"],
                kd["sf_valid"], "map")
            return (st, cnt), None

        (store, cnt), _ = jax.lax.scan(add, (store, jnp.int32(0)), stacked)
        best_id, best, is_new = jkfs.query_sharded(
            store.db.codes, cnt, jnp.asarray(q), 0.3095, "map")
        payload = jkfs.get_payload_sharded(store, best_id, "map")
        stamp = jkfs.get_stamp_sharded(store.db.stamps, best_id, "map")
        return (best_id, best, is_new.astype(jnp.int32), payload, stamp,
                jax.tree.leaves(store))

    store_spec = [P("map") if x.ndim else P() for x in leaves]
    sharded = jax.shard_map(
        run, mesh=jmesh, in_specs=(tuple(P() for _ in leaves),),
        out_specs=(P(), P(), P(), jax.tree.map(
            lambda _: P(), jkfs.KeyframePayload(
                *([0.0] * len(jkfs.KeyframePayload._fields)))), P(),
            store_spec),
        check_vma=False)
    out = sharded(tuple(leaves))
    return jax.tree.map(np.asarray, out), tree


def test_sharded_keyframe_store_matches_jax(port, scenes, jmesh):
    """21 keyframes round robin over 2 ranks: each rank's rows, the query
    (best id, dissimilarity, new flag), the broadcast payload (uint32
    descriptors bit for bit) and the best keyframe's stamp exact against
    JAX's 2-device run and the single-device fern query; a masked add is
    a no-op."""
    s = scenes["keyframes"]
    (best_id, best, is_new, payload, stamp, leaves), tree = _jax_keyframes(
        jmesh, s["keyframes"], s["query"])
    jstore = jax.tree.unflatten(tree, leaves)
    pk = [r["keyframes"] for r in port]
    for r in pk:
        assert (r["best_id"], r["best"], r["is_new"], r["stamp"]) == (
            int(best_id), float(best), bool(is_new), int(stamp))
        assert r["count"] == 21 and r["masked_add_is_noop"]
        for f in jkfs.KeyframePayload._fields:
            want = np.asarray(getattr(payload, f))
            got = r["payload"][f]
            if want.dtype == np.uint32:
                got = got.view(np.uint32)
            np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("codes", "poses_R", "poses_t", "stamps"):
        np.testing.assert_array_equal(
            np.concatenate([r["local"][f"db.{f}"] for r in pk]),
            getattr(jstore.db, f), err_msg=f)
    for f in JStore._fields[1:]:
        got = np.concatenate([r["local"][f] for r in pk])
        want = getattr(jstore, f)
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f)
    # the single-device query on the whole store
    codes = np.stack([kd["codes"] for kd in s["keyframes"]])
    db = jferns.FernDB.empty(MAX_KF, NF)._replace(
        codes=jnp.zeros((MAX_KF, NF), jnp.uint8).at[:21].set(codes),
        count=jnp.int32(21))
    b1, d1, n1 = jferns.query(db, jnp.asarray(s["query"]), 0.3095)
    assert (int(b1), bool(n1)) == (pk[0]["best_id"], pk[0]["is_new"]) \
        and pk[0]["best_id"] == 13
    np.testing.assert_allclose(pk[0]["best"], float(d1), atol=1e-6)


def _jax_graph_fn(jmesh):
    def local_build(p, s, nb):
        g = jdefo.build_graph_sharded(p, s, nb[0], "map")
        return g.positions, g.stamps, g.neighbours, g.n_nodes[None]

    f = jax.jit(jax.shard_map(local_build, mesh=jmesh,
                              in_specs=(P("map", None), P("map"), P("map")),
                              out_specs=(P(), P(), P(), P("map")),
                              check_vma=False))

    def run(pos, st, nb_local):
        put = lambda x, spec: jax.device_put(  # noqa: E731
            jnp.asarray(x), NamedSharding(jmesh, spec))
        out = f(put(pos, P("map", None)), put(st, P("map")),
                put(nb_local, P("map")))
        return [np.asarray(a) for a in out]

    return run


def test_build_graph_sharded_matches_jax(port, scenes, jmesh):
    """The gathered graph exact against JAX's 2-device build: full blocks,
    partly filled ones, blocks with fewer live surfels than their share of
    the node budget, and an empty model."""
    jax_graph = _jax_graph_fn(jmesh)
    for k, (pos, st, nb) in enumerate(scenes["graphs"]["graph_cases"]):
        jpos, jst, jnb, jn = jax_graph(pos, st, nb)
        for r in port:
            g = r["graphs"][k]
            np.testing.assert_array_equal(g["positions"], jpos)
            np.testing.assert_array_equal(g["stamps"], jst)
            np.testing.assert_array_equal(g["neighbours"], jnb)
            assert int(g["n_nodes"]) == int(jn[0]), k


def test_summed_icp_system_matches_single_device(port, scenes):
    """Each rank's summed ICP system against the JAX package's
    single-device `_build_system` on the whole model (JAX's own tolerance,
    rtol 1e-4 / atol 1e-3; the inlier count exact), and the whole ICP over
    2 ranks against the port's single-rank ICP on the same model."""
    s = scenes["icp"]
    m = s["icp_model"]
    jcam = jcfg.CameraIntrinsics(**{k: getattr(s["icp_cam"], k) for k in (
        "fx", "fy", "cx", "cy", "width", "height")})
    ref = jicp._build_system(
        jnp.asarray(m["positions"]), jnp.asarray(m["orientations"][:, 2]),
        jlab(jnp.asarray(m["colors"])), jnp.asarray(m["confidences"] > 0),
        jnp.asarray(s["icp_maps"]), jnp.asarray(s["icp_R"]),
        jnp.asarray(s["icp_t"]), jcam, _icp_cfg(jcfg))
    ref = [np.asarray(a) for a in ref]
    assert ref[3] > 50
    model = TSurfels(*(T(m[f]) for f in SURFEL_FIELDS))
    one = ticp.symmetric_icp(
        model, torch.tensor(model.capacity, dtype=torch.int32),
        T(s["icp_maps"]), T(s["icp_R"]), T(s["icp_t"]), s["icp_cam"],
        s["icp_cfg"])
    for r in port:
        got = r["icp"]["system"]
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=1e-6)
        assert float(got[3]) == float(ref[3])
        assert r["icp"]["iters"] == int(one.iters) > 1
        assert r["icp"]["valid"] == bool(one.valid)
        assert r["icp"]["inliers"] == float(one.inliers)
        np.testing.assert_allclose(r["icp"]["R_rel"], one.R_rel.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(r["icp"]["t_rel"], one.t_rel.numpy(),
                                   atol=1e-6)
    np.testing.assert_array_equal(port[0]["icp"]["R_rel"],
                                  port[1]["icp"]["R_rel"])


def test_distributed_solve_matches_one_rank(port, scenes, jmesh):
    """The graph solve with the constraints over 2 ranks: within 1e-5 of
    the port's single-rank solve (both form and solve the normal equations
    in f64), the same on both ranks, and no farther from an f64 evaluation
    of the single-rank solve than the JAX package's 2-device solve."""
    pos, stamps, src, tgt, cst, valid, iters = solve_scene()
    g, b = _port_graph(pos, stamps, src, cst, valid)
    one = tdefo.optimise(g, b, T(src), T(tgt), T(valid), n_iters=iters)
    g64 = tdefo.DeformationGraph(*(a.double() if a.is_floating_point()
                                   else a for a in g))
    b64 = tdefo.VertexBinding(b.nodes, b.weights.double())
    r64 = tdefo.optimise(g64, b64, T(src).double(), T(tgt).double(),
                         T(valid), n_iters=iters)
    jg = jdefo.build_graph(jnp.asarray(pos), jnp.asarray(stamps),
                           jnp.ones(len(pos), bool), jnp.int32(len(pos)))
    jb = jdefo.bind_vertices(jg, jnp.asarray(src), jnp.asarray(cst),
                             jnp.asarray(valid))
    run = jba.make_distributed_optimise(jmesh, n_iters=iters)
    jr = [np.asarray(a) for a in run(jg, *jba.shard_constraints(
        jmesh, jb, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid)))]
    for r in port:
        got = r["solve"]
        for k in range(2):
            np.testing.assert_allclose(got[k], one[k].numpy(), atol=1e-5)
            ref = r64[k].numpy()
            assert np.abs(got[k] - ref).max() <= max(
                np.abs(jr[k] - ref).max(), 1e-6), k
        np.testing.assert_allclose(got[2], float(one[2]), rtol=1e-5)
        np.testing.assert_allclose(got[3], float(one[3]), atol=1e-7)
    for k in range(4):
        np.testing.assert_array_equal(port[0]["solve"][k],
                                      port[1]["solve"][k])


def test_collectives_are_counted(port):
    """Every rank issued the same collectives and bytes, and the mesh
    counted them and the host time spent in them."""
    c0, c1 = (r["counts"] for r in port)
    assert (c0["collectives"], c0["bytes"]) == (c1["collectives"],
                                                c1["bytes"])
    assert c0["collectives"] > 0 and c0["bytes"] > 0
    assert c0["seconds"] > 0 and c1["seconds"] > 0

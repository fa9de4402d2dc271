"""Rank functions of the port's sharded tests (`test_torch_sharding.py`,
`test_torch_pipeline_sharded.py`). Each runs in a spawned rank process
(`parallel.distributed.launch`), so this module imports no JAX: a child
imports it by name, and nothing of the JAX package may load there. The
scenes are numpy arrays made by the test from a seed."""

from __future__ import annotations

import numpy as np
import torch

from supersurfel_fusion_tpu_torch import convert
from supersurfel_fusion_tpu_torch.ops import deformation as defo
from supersurfel_fusion_tpu_torch.ops.loop_closure import KeyframeStore
from supersurfel_fusion_tpu_torch.parallel import ba
from supersurfel_fusion_tpu_torch.parallel import kf_sharded as kfs
from supersurfel_fusion_tpu_torch.parallel import mesh as tmesh
from supersurfel_fusion_tpu_torch.parallel import pipeline_sharded as psh
from supersurfel_fusion_tpu_torch.parallel.sharding import (
    make_distributed_model,
    make_sharded_update,
)
from supersurfel_fusion_tpu_torch.types import Supersurfels

T = torch.from_numpy


def _np(x):
    return x.detach().cpu().numpy()


def _surfels(d: dict) -> Supersurfels:
    return Supersurfels(*(T(np.array(d[f])) for f in Supersurfels._fields))


def _fusion(mesh, s):
    """The sharded model update over `s["frames"]`: each rank's block and
    counts after every frame."""
    step = make_sharded_update(mesh, s["cam"], s["cfg"], conf_thresh=1e9)
    dm = make_distributed_model(s["cfg"].nb_supersurfels_max, mesh)
    out = []
    for f in s["frames"]:
        dm = step(dm, _surfels(f["frame"]), T(f["labels"]), T(f["pd"]),
                  T(f["R"]), T(f["t"]),
                  torch.tensor(f["stamp"], dtype=torch.int32))
        out.append({"surfels": {k: _np(v) for k, v in
                                dm.surfels._asdict().items()},
                    "nb_local": int(dm.nb_local),
                    "nb_visible_local": int(dm.nb_visible_local)})
    return out


def _add(store, count, kd, mesh, when=None):
    return kfs.add_keyframe_sharded(
        store, count, T(kd["codes"]), T(kd["R"]), T(kd["t"]),
        torch.tensor(int(kd["stamp"]), dtype=torch.int32),
        T(kd["kp_xy"]), T(kd["kp_p3d"]), T(kd["kp_desc"].view(np.int32)),
        T(kd["kp_valid"]), T(kd["sf_pos"]), T(kd["sf_normal"]),
        T(kd["sf_color"]), T(kd["sf_valid"]), mesh, when=when)


def _keyframes(mesh, s):
    """Keyframes added to the sharded store, then the query and the best
    keyframe's payload and stamp."""
    rows = kfs.local_rows(s["max_kf"], mesh.axis_size)
    store = KeyframeStore.empty(rows, s["n_ferns"], s["kp"], s["f"], "cpu")
    count = torch.zeros((), dtype=torch.int32)
    for kd in s["keyframes"]:
        store, count = _add(store, count, kd, mesh)
    # a masked add changes nothing
    store2, count2 = _add(store, count, s["keyframes"][0], mesh,
                          when=torch.tensor(False))
    best_id, best, is_new = kfs.query_sharded(
        store.db.codes, count, T(s["query"]), s["thresh"], mesh)
    payload = kfs.get_payload_sharded(store, best_id, mesh)
    stamp = kfs.get_stamp_sharded(store.db.stamps, best_id, mesh)
    local = {f"db.{k}": _np(v) for k, v in store.db._asdict().items()}
    local.update({k: _np(getattr(store, k))
                  for k in KeyframeStore._fields[1:]})
    same = all(torch.equal(a, b) for a, b in zip(
        (*store.db, *store[1:]), (*store2.db, *store2[1:])))
    return {"count": int(count), "best_id": int(best_id),
            "best": float(best), "is_new": bool(is_new),
            "payload": {k: _np(v) for k, v in payload._asdict().items()},
            "stamp": int(stamp), "local": local,
            "masked_add_is_noop": same and int(count2) == int(count)}


def _graphs(mesh, s):
    """build_graph_sharded on each case's blocks."""
    out = []
    for pos, st, nb_local in s["graph_cases"]:
        rows = tmesh.block(pos.shape[0], mesh)
        g = defo.build_graph_sharded(
            T(pos[rows]), T(st[rows]),
            torch.tensor(nb_local[mesh.axis_index], dtype=torch.int32), mesh)
        out.append({k: _np(v) for k, v in g._asdict().items()})
    return out


def _icp(mesh, s):
    """The summed ICP system of this rank's block, and the whole ICP."""
    from supersurfel_fusion_tpu_torch.ops.icp import symmetric_icp

    model = _surfels(s["icp_model"])
    block = tmesh.shard_model(model, mesh)
    run = tmesh.make_sharded_icp_step(mesh, s["icp_cam"], s["icp_cfg"])
    R, t = T(s["icp_R"]), T(s["icp_t"])
    system = [_np(v) for v in run(block, T(s["icp_maps"]), R, t)]
    res = symmetric_icp(block, torch.tensor(block.capacity,
                                            dtype=torch.int32),
                        T(s["icp_maps"]), R, t, s["icp_cam"], s["icp_cfg"],
                        mesh=mesh)
    return {"system": system, "R_rel": _np(res.R_rel),
            "t_rel": _np(res.t_rel), "valid": bool(res.valid),
            "inliers": float(res.inliers), "iters": int(res.iters)}


def _solve(mesh, s):
    """The distributed graph solve on this rank's constraint shard."""
    g = defo.DeformationGraph(*(T(np.array(a)) for a in s["ba_graph"]))
    b = defo.VertexBinding(*(T(np.array(a)) for a in s["ba_binding"]))
    shard = ba.shard_constraints(mesh, b, T(s["ba_src"]), T(s["ba_tgt"]),
                                 T(s["ba_valid"]))
    run = ba.make_distributed_optimise(mesh, n_iters=s["ba_iters"])
    return [_np(v) for v in run(g, *shard)]


def sharding_cases(mesh, scenes: dict) -> dict:
    """Every scenario of test_torch_sharding.py on this rank."""
    return {"fusion": _fusion(mesh, scenes["fusion"]),
            "round_robin": _fusion(mesh, scenes["round_robin"]),
            "keyframes": _keyframes(mesh, scenes["keyframes"]),
            "graphs": _graphs(mesh, scenes["graphs"]),
            "icp": _icp(mesh, scenes["icp"]),
            "solve": _solve(mesh, scenes["solve"]),
            "counts": dict(mesh.counts)}


def _sharded_out(out):
    return {"R": _np(out.pose.R), "t": _np(out.pose.t),
            "nb_total": int(out.nb_total), "icp_valid": bool(out.icp_valid),
            "vo_valid": bool(out.vo_valid),
            "fern_id": None if out.fern_id is None else int(out.fern_id),
            "lc_gate": out.lc_gate,
            "lc_accepted": None if out.lc_accepted is None
            else bool(out.lc_accepted)}


def pipeline_steps(mesh, cfg, frames, jax_states) -> dict:
    """The sharded frame step on `frames`: each frame from the JAX state
    carried over (when `jax_states` is given: one numpy ShardedSLAMState
    per frame), and the frames free-running from an empty state."""
    step = psh.make_process_frame_sharded(mesh, cfg)
    carried = []
    if jax_states is not None:
        for (rgb, depth), js in zip(frames, jax_states):
            st = convert.sharded_state_from_jax_numpy(
                js, mesh.axis_index, mesh.axis_size, device="cpu")
            st, out = step(st, rgb, depth)
            carried.append(_sharded_out(out))
    st = psh.init_sharded_state(cfg, mesh)
    free = []
    for rgb, depth in frames:
        st, out = step(st, rgb, depth)
        free.append(_sharded_out(out))
    return {"carried": carried, "free": free,
            "nb_local": int(st.model.nb_local),
            "keyframes": int(st.kf_store.db.count)}


def rank0_agreement(mesh) -> dict:
    """The sharded step's MOD agreement (`pipeline_sharded._rank0`): each
    rank offers its own decision and heat, drawn from a seed per rank."""
    rng = np.random.default_rng(10 + mesh.axis_index)
    sp = T(rng.random(48) < 0.5)
    kp = T(rng.random(20) < 0.5)
    heat = T(rng.random((6, 8)).astype(np.float32))
    got_sp, got_kp, got_heat = psh._rank0(mesh)(sp, kp, heat)
    return {"mine_sp": _np(sp), "mine_kp": _np(kp), "mine_heat": _np(heat),
            "static_sp": _np(got_sp), "static_kp": _np(got_kp),
            "heat": _np(got_heat)}

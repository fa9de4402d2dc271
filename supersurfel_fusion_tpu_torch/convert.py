"""State and weights carried across from the JAX package.

The carried-over state is the SLAM state itself (model SoA, pose, stamp,
VO local map, MOD context, keyframe store and loop-closure counters,
trajectory ring) and, on the MOD path with the person detector, the
detector's weights. `state_from_jax_numpy` builds the
port's `SLAMState` from a JAX `SLAMState` whose leaves were turned into
numpy arrays (for example with `jax.tree.map(np.asarray, state)`), so both
packages can start from the same state; `detector_from_numpy` builds the
port's `PersonDetector` from the JAX parameter dict. Both read attributes
and keys by name and import nothing of JAX.

`sharded_state_from_jax_numpy` gives rank r of D its block of a JAX
`ShardedSLAMState` as `jax.device_get` returns it: rows [r C/D, (r+1) C/D)
of the model and rows [r K/D, (r+1) K/D) of the keyframe store, which
the JAX package holds block-wise in its local-row layout (local row i of
rank r is global keyframe i D + r).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from supersurfel_fusion_tpu_torch.device import resolve_device
from supersurfel_fusion_tpu_torch.models.person_detector import PersonDetector
from supersurfel_fusion_tpu_torch.ops.ferns import FernDB
from supersurfel_fusion_tpu_torch.ops.loop_closure import KeyframeStore
from supersurfel_fusion_tpu_torch.ops.motion import MODPrev
from supersurfel_fusion_tpu_torch.ops.vo import LocalMap
from supersurfel_fusion_tpu_torch.pipeline import SLAMState
from supersurfel_fusion_tpu_torch.types import ModelState, Pose, Supersurfels

_SURFEL_FIELDS = Supersurfels._fields


def _t(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:   # descriptor words -> int32 bit patterns
        a = a.view(np.int32)
    out = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out if dtype is None else out.to(dtype)


def state_from_jax_numpy(state, device: str | torch.device = "cuda"
                         ) -> SLAMState:
    """Port `SLAMState` from a JAX `SLAMState` with numpy leaves."""
    dev = resolve_device(device)
    s = state.model.surfels
    surfels = Supersurfels(*(_t(getattr(s, f), dev) for f in _SURFEL_FIELDS))
    lm = state.local_map
    mp = state.mod_prev
    i32 = torch.int32
    params = getattr(state, "mod_params", None)
    return SLAMState(
        model=ModelState(surfels, _t(state.model.nb_supersurfels, dev, i32),
                         _t(state.model.nb_visible, dev, i32)),
        pose=Pose(_t(state.pose.R, dev, torch.float32),
                  _t(state.pose.t, dev, torch.float32)),
        stamp=_t(state.stamp, dev, i32),
        local_map=LocalMap(_t(lm.positions, dev), _t(lm.desc, dev),
                           _t(lm.counters, dev, i32),
                           _t(lm.valid, dev, torch.bool)),
        mod_prev=MODPrev(*(_t(getattr(mp, f), dev) for f in MODPrev._fields)),
        kf_store=keyframe_store_from_numpy(state.kf_store, dev),
        prev_fern_id=_t(state.prev_fern_id, dev, i32),
        last_lc_stamp=_t(state.last_lc_stamp, dev, i32),
        lc_count=_t(state.lc_count, dev, i32),
        vis_peak=_t(state.vis_peak, dev, i32),
        dropped_total=_t(state.dropped_total, dev, i32),
        traj=_t(state.traj, dev, torch.float32),
        detector=None if params is None
        else detector_from_numpy(params).to(dev),
    )


def keyframe_store_from_numpy(ks, device: str | torch.device = "cuda"
                              ) -> KeyframeStore:
    """Port `KeyframeStore` from a JAX `KeyframeStore` with numpy leaves
    (descriptor words as int32 bit patterns)."""
    dev = resolve_device(device)
    db = FernDB(_t(ks.db.codes, dev, torch.uint8),
                _t(ks.db.poses_R, dev, torch.float32),
                _t(ks.db.poses_t, dev, torch.float32),
                _t(ks.db.stamps, dev, torch.int32),
                _t(ks.db.count, dev, torch.int32))
    return KeyframeStore(db, *(
        _t(getattr(ks, f), dev, torch.bool if f.endswith("valid") else None)
        for f in KeyframeStore._fields[1:]))


def state_from_numpy(flat: dict, device: str | torch.device = "cuda",
                     detector: PersonDetector | None = None) -> SLAMState:
    """Port `SLAMState` from the flat dict of `state_to_numpy` (descriptor
    words as uint32 or int32), with `detector` as its person detector."""
    root = SimpleNamespace()
    for name, value in flat.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            if not hasattr(node, part):
                setattr(node, part, SimpleNamespace())
            node = getattr(node, part)
        setattr(node, leaf, value)
    state = state_from_jax_numpy(root, device)
    return state if detector is None else state._replace(
        detector=detector.to(state.stamp.device))


def detector_from_numpy(params: dict) -> PersonDetector:
    """The port's `PersonDetector` from the JAX package's parameter dict
    (`models.person_detector.load_params`, values as numpy arrays)."""
    return PersonDetector.from_params(
        {k: np.asarray(v) for k, v in params.items()})


def to_params(det: PersonDetector) -> dict:
    """The JAX package's parameter dict (numpy, HWIO weights) of `det`:
    the inverse of `detector_from_numpy`, the layout the checkpoints
    hold."""
    out = {}
    for name, conv in [(f"conv{i}", c) for i, c in enumerate(det.stages)] \
            + [("heat", det.heat), ("size", det.size)]:
        out[f"{name}_w"] = conv.weight.detach().permute(2, 3, 1, 0) \
            .contiguous().cpu().numpy()
        out[f"{name}_b"] = conv.bias.detach().cpu().numpy().copy()
    return out


def state_to_numpy(state: SLAMState) -> dict:
    """The port's state as a flat dict of numpy arrays, named like the JAX
    fields (descriptor words as uint32, as the JAX package keeps them)."""
    out = {f"model.surfels.{f}": getattr(state.model.surfels, f).cpu().numpy()
           for f in _SURFEL_FIELDS}
    out["model.nb_supersurfels"] = state.model.nb_supersurfels.cpu().numpy()
    out["model.nb_visible"] = state.model.nb_visible.cpu().numpy()
    out["pose.R"] = state.pose.R.cpu().numpy()
    out["pose.t"] = state.pose.t.cpu().numpy()
    out["stamp"] = state.stamp.cpu().numpy()
    for f in LocalMap._fields:
        a = getattr(state.local_map, f).cpu().numpy()
        out[f"local_map.{f}"] = a.view(np.uint32) if f == "desc" else a
    for f in MODPrev._fields:
        a = getattr(state.mod_prev, f).cpu().numpy()
        out[f"mod_prev.{f}"] = a.view(np.uint32) if f == "kp_desc" else a
    for f in FernDB._fields:
        out[f"kf_store.db.{f}"] = getattr(state.kf_store.db, f).cpu().numpy()
    for f in KeyframeStore._fields[1:]:
        a = getattr(state.kf_store, f).cpu().numpy()
        out[f"kf_store.{f}"] = a.view(np.uint32) if f == "kp_desc" else a
    for f in ("prev_fern_id", "last_lc_stamp", "lc_count"):
        out[f] = getattr(state, f).cpu().numpy()
    out["vis_peak"] = state.vis_peak.cpu().numpy()
    out["dropped_total"] = state.dropped_total.cpu().numpy()
    out["traj"] = state.traj.cpu().numpy()
    return out


def sharded_state_from_jax_numpy(state, rank: int, n_ranks: int,
                                 device: str | torch.device = "cuda",
                                 detector: PersonDetector | None = None):
    """Rank `rank` of `n_ranks`'s `ShardedSLAMState` (parallel/
    pipeline_sharded.py) from a JAX `ShardedSLAMState` with numpy leaves,
    with `detector` as its person detector."""
    from supersurfel_fusion_tpu_torch.parallel.pipeline_sharded import (
        ShardedSLAMState,
    )
    from supersurfel_fusion_tpu_torch.parallel.sharding import (
        DistributedModel,
    )

    dev = resolve_device(device)
    i32 = torch.int32

    def rows(a):
        a = np.asarray(a)
        per = a.shape[0] // n_ranks
        return a[rank * per:(rank + 1) * per]

    s = state.model.surfels
    surfels = Supersurfels(*(_t(rows(getattr(s, f)), dev)
                             for f in _SURFEL_FIELDS))
    ks = state.kf_store
    db = ks.db
    local_store = SimpleNamespace(
        db=SimpleNamespace(codes=rows(db.codes), poses_R=rows(db.poses_R),
                           poses_t=rows(db.poses_t), stamps=rows(db.stamps),
                           count=db.count),
        **{f: rows(getattr(ks, f)) for f in KeyframeStore._fields[1:]})
    lm = state.local_map
    mp = state.mod_prev
    nb_vis = np.asarray(state.model.nb_visible_local)
    return ShardedSLAMState(
        model=DistributedModel(
            surfels, _t(np.asarray(state.model.nb_local)[rank], dev, i32),
            _t(nb_vis[rank], dev, i32)),
        kf_store=keyframe_store_from_numpy(local_store, dev),
        pose=Pose(_t(state.pose.R, dev, torch.float32),
                  _t(state.pose.t, dev, torch.float32)),
        stamp=_t(state.stamp, dev, i32),
        local_map=LocalMap(_t(lm.positions, dev), _t(lm.desc, dev),
                           _t(lm.counters, dev, i32),
                           _t(lm.valid, dev, torch.bool)),
        mod_prev=MODPrev(*(_t(getattr(mp, f), dev) for f in MODPrev._fields)),
        prev_fern_id=_t(state.prev_fern_id, dev, i32),
        last_lc_stamp=_t(state.last_lc_stamp, dev, i32),
        lc_count=_t(state.lc_count, dev, i32),
        nb_visible_total=_t(nb_vis.sum(), dev, i32),
        detector=None if detector is None else detector.to(dev),
    )

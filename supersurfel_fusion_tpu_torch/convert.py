"""State carried across from the JAX package.

The main path has no network weights; its carried-over state is the SLAM
state itself (model SoA, pose, stamp, VO local map, trajectory ring).
`state_from_jax_numpy` builds the port's `SLAMState` from a JAX `SLAMState`
whose leaves were turned into numpy arrays (for example with
`jax.tree.map(np.asarray, state)`), so both packages can start from the
same state. It reads attributes by name and imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from supersurfel_fusion_tpu_torch.device import resolve_device
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
    i32 = torch.int32
    return SLAMState(
        model=ModelState(surfels, _t(state.model.nb_supersurfels, dev, i32),
                         _t(state.model.nb_visible, dev, i32)),
        pose=Pose(_t(state.pose.R, dev, torch.float32),
                  _t(state.pose.t, dev, torch.float32)),
        stamp=_t(state.stamp, dev, i32),
        local_map=LocalMap(_t(lm.positions, dev), _t(lm.desc, dev),
                           _t(lm.counters, dev, i32),
                           _t(lm.valid, dev, torch.bool)),
        vis_peak=_t(state.vis_peak, dev, i32),
        dropped_total=_t(state.dropped_total, dev, i32),
        traj=_t(state.traj, dev, torch.float32),
    )


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
    out["vis_peak"] = state.vis_peak.cpu().numpy()
    out["dropped_total"] = state.dropped_total.cpu().numpy()
    out["traj"] = state.traj.cpu().numpy()
    return out

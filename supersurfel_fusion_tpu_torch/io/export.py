"""Model export, local point-cloud extraction and checkpoint/resume.

Port of `supersurfel_fusion_tpu/io/export.py`:

* `export_model`: the text layout of the reference's
  `SupersurfelFusion::exportModel`, byte for byte as the JAX package
  writes it;
* `export_model_ply`: the same surfels as an ASCII PLY point cloud with
  normals and colours;
* `extract_local_point_cloud`: confident surfels near the camera, in the
  camera frame (fixed shape, with a mask);
* `save_checkpoint` / `load_checkpoint`: the whole `SLAMState` through
  `torch.save` (the JAX package uses orbax). The state is stored as CPU
  tensors named as `convert.state_to_numpy` names them, and the person
  detector, when there is one, as its weights; a checkpoint saved on the
  card loads on the CPU and the other way round.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from supersurfel_fusion_tpu_torch import convert
from supersurfel_fusion_tpu_torch.models.person_detector import PersonDetector
from supersurfel_fusion_tpu_torch.types import Supersurfels

Tensor = torch.Tensor


def _host(model: Supersurfels, n: int) -> dict:
    return {f: getattr(model, f)[:n].cpu().numpy() for f in model._fields}


def export_model(path: str, model: Supersurfels, nb_supersurfels,
                 conf_thresh: float) -> int:
    """Write surfels with confidence > conf_thresh in the reference's text
    layout: per surfel 6 lines (stamps+conf / position / color / dims /
    orientation 9 / shape upper-tri 6) + blank. Returns #exported."""
    n = int(nb_supersurfels)
    m = _host(model, n)
    pos, ori, shp = m["positions"], m["orientations"], m["shapes"]
    dims, conf = m["dims"], m["confidences"]
    col, stamps = m["colors"], m["stamps"]
    count = 0
    with open(path, "w") as f:
        for i in range(n):
            if conf[i] > conf_thresh:
                f.write(f"{stamps[i, 0]} {stamps[i, 1]} {conf[i]:.6f}\n")
                f.write(f"{pos[i, 0]:.6f} {pos[i, 1]:.6f} {pos[i, 2]:.6f}\n")
                f.write(f"{col[i, 0]:.6f} {col[i, 1]:.6f} {col[i, 2]:.6f}\n")
                f.write(f"{dims[i, 0]:.6f} {dims[i, 1]:.6f}\n")
                f.write(" ".join(f"{v:.6f}" for v in ori[i].reshape(-1)) + "\n")
                f.write(
                    f"{shp[i, 0, 0]:.6f} {shp[i, 0, 1]:.6f} {shp[i, 0, 2]:.6f} "
                    f"{shp[i, 1, 1]:.6f} {shp[i, 1, 2]:.6f} {shp[i, 2, 2]:.6f}\n"
                )
                f.write("\n")
                count += 1
    return count


def export_model_ply(path: str, model: Supersurfels, nb_supersurfels,
                     conf_thresh: float = 0.0) -> int:
    """Surfel centres as a PLY point cloud with normals + RGB."""
    m = _host(model, int(nb_supersurfels))
    keep = m["confidences"] > conf_thresh
    pos = m["positions"][keep]
    nrm = m["orientations"][:, 2, :][keep]
    col = np.clip(m["colors"][keep], 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pos)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, nv, c in zip(pos, nrm, col):
            f.write(
                f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                f"{nv[0]:.4f} {nv[1]:.4f} {nv[2]:.4f} "
                f"{c[0]} {c[1]} {c[2]}\n"
            )
    return len(pos)


def extract_local_point_cloud(model: Supersurfels, nb_supersurfels: Tensor,
                              R: Tensor, t: Tensor, conf_thresh: float,
                              radius: float):
    """Confident surfels within `radius` of the camera, in camera frame.
    Returns (positions (C,3), normals (C,3), mask (C,)): fixed shape, with
    a validity mask instead of a compacted output."""
    ids = torch.arange(model.capacity, dtype=torch.int32,
                       device=model.positions.device)
    Rv = R.T
    tv = -(Rv @ t)
    p = model.positions @ Rv.T + tv
    nrm = model.orientations[:, 2, :] @ Rv.T
    ok = ((ids < nb_supersurfels) & (model.confidences >= conf_thresh)
          & (torch.linalg.norm(p, dim=-1) < radius))
    return p, nrm, ok


def save_checkpoint(path: str, state, step: Optional[int] = None) -> str:
    """Persist a whole `SLAMState` to the file `path`. Returns its absolute
    path."""
    path = os.path.abspath(path)
    flat = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                else v)
            for k, v in convert.state_to_numpy(state).items()}
    det = state.detector
    detector = None if det is None else {
        "in_ch": det.stages[0].in_channels,
        "weights": {k: v.detach().cpu() for k, v in det.state_dict().items()}}
    torch.save({"state": flat, "detector": detector, "step": step}, path)
    return path


def load_checkpoint(path: str, device: str | torch.device = "cuda"):
    """Restore a `SLAMState` saved by `save_checkpoint` onto `device`."""
    ckpt = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    det = None
    if ckpt["detector"] is not None:
        det = PersonDetector(in_ch=ckpt["detector"]["in_ch"])
        det.load_state_dict(ckpt["detector"]["weights"])
    flat = {k: v.numpy() for k, v in ckpt["state"].items()}
    return convert.state_from_numpy(flat, device, detector=det)

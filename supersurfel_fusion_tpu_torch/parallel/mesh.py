"""The "map" axis: the ranks of a process group, and its collectives.

Port of `supersurfel_fusion_tpu/parallel/mesh.py`. Where the JAX package
runs one `shard_map` program over a device mesh, the port runs one
process per rank (`parallel/distributed.py`), and a `Mesh` names this
rank's place on the axis: the process group, `axis_index` (this rank),
`axis_size` and the device. `psum`, `pmin`, `pmax` and `all_gather` take
the place of `jax.lax.psum` and its siblings; the sharded modules call
them wherever the JAX package does. Each counts its calls, bytes and the
host seconds spent in the call on the mesh (`Mesh.counts`), so a caller
can read the collectives of one frame step: over gloo those seconds are
the host's wait for the collective, over NCCL only its enqueueing.

Design (as in the JAX package): the global model's capacity axis and the
keyframe store are block-sharded over the ranks; the frame's images and
surfels are replicated, and every rank computes the frame's math for
itself. Dense ICP sums each rank's 6x6 normal equations over the axis
(`make_sharded_icp_step`), so every rank takes the same Gauss-Newton step.

Collectives run on `torch.distributed` with tensors on the mesh's device:
NCCL queues them on the device; gloo (the CPU, or several ranks on one
card) makes the host wait for each. Booleans do not travel: NCCL has no
boolean reduction, so callers reduce int32.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from supersurfel_fusion_tpu_torch.config import CameraIntrinsics, ICPConfig
from supersurfel_fusion_tpu_torch.types import Supersurfels

Tensor = torch.Tensor


@dataclass
class Mesh:
    """One rank's view of the "map" axis."""

    group: object | None          # the process group (None: the default)
    axis_index: int               # this rank
    axis_size: int                # number of ranks
    device: torch.device
    backend: str
    # collectives issued through this mesh, the bytes they carried and
    # the host seconds spent in them
    counts: dict = field(default_factory=lambda: {
        "collectives": 0, "bytes": 0, "seconds": 0.0})

    def reset_counts(self) -> None:
        self.counts.update(collectives=0, bytes=0, seconds=0.0)


def make_mesh(device: str | torch.device | None = None,
              group=None) -> Mesh:
    """The mesh over `group` (default: the whole initialized process
    group) on `device` (default: the first CUDA device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/distributed.py)")
    dev = torch.device("cuda" if device is None else device)
    return Mesh(group=group, axis_index=dist.get_rank(group),
                axis_size=dist.get_world_size(group), device=dev,
                backend=str(dist.get_backend(group)))


def _count(mesh: Mesh, t: Tensor, t0: float) -> None:
    mesh.counts["collectives"] += 1
    mesh.counts["bytes"] += t.numel() * t.element_size()
    mesh.counts["seconds"] += time.perf_counter() - t0


def _reduce(x: Tensor, mesh: Mesh, op) -> Tensor:
    if x.dtype == torch.bool:
        raise TypeError("reduce booleans as int32 (NCCL has no boolean "
                        "reduction)")
    buf = x.detach().clone().contiguous()
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=op, group=mesh.group)
    _count(mesh, buf, t0)
    return buf


def psum(x: Tensor, mesh: Mesh) -> Tensor:
    """Sum of `x` over the ranks (`jax.lax.psum`)."""
    return _reduce(x, mesh, dist.ReduceOp.SUM)


def pmin(x: Tensor, mesh: Mesh) -> Tensor:
    """Elementwise minimum over the ranks (`jax.lax.pmin`)."""
    return _reduce(x, mesh, dist.ReduceOp.MIN)


def pmax(x: Tensor, mesh: Mesh) -> Tensor:
    """Elementwise maximum over the ranks (`jax.lax.pmax`)."""
    return _reduce(x, mesh, dist.ReduceOp.MAX)


def all_gather(x: Tensor, mesh: Mesh) -> Tensor:
    """(axis_size, *x.shape): every rank's `x`, in rank order
    (`jax.lax.all_gather`)."""
    if x.dtype == torch.bool:
        raise TypeError("gather booleans as int32")
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size)]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=mesh.group)
    _count(mesh, x, t0)
    return torch.stack(parts)


def psum_packed(tensors, mesh: Mesh) -> list:
    """`psum` of several tensors of one dtype in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    out = psum(flat, mesh)
    res, o = [], 0
    for t in tensors:
        res.append(out[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return res


def block(n: int, mesh: Mesh) -> slice:
    """This rank's rows of an axis of length `n` block-sharded over the
    mesh (`n` must divide by its size)."""
    if n % mesh.axis_size:
        raise ValueError(f"{n} rows do not divide over {mesh.axis_size} "
                         "ranks")
    per = n // mesh.axis_size
    return slice(mesh.axis_index * per, (mesh.axis_index + 1) * per)


def shard_model(model: Supersurfels, mesh: Mesh) -> Supersurfels:
    """This rank's block of the model's capacity axis, on its device."""
    rows = block(model.capacity, mesh)
    return Supersurfels(*(a[rows].to(mesh.device) for a in model))


def make_sharded_icp_step(mesh: Mesh, cam: CameraIntrinsics,
                          cfg: ICPConfig):
    """Distributed linearization: each rank builds the ICP normal
    equations of its model block, and one summed collective gives every
    rank the system of the whole model. Returns run(model_block,
    target_maps, R, t) -> (JtJ, Jtr, r, inliers)."""
    from supersurfel_fusion_tpu_torch.ops.icp import _build_system
    from supersurfel_fusion_tpu_torch.utils.color import rgb_to_lab

    def run(model: Supersurfels, target_maps: Tensor, R: Tensor,
            t: Tensor):
        out = _build_system(model.positions, model.orientations[:, 2, :],
                            rgb_to_lab(model.colors), model.confidences > 0,
                            target_maps, R, t, cam, cfg)
        return tuple(psum_packed(out, mesh))

    return run


def _dryrun_scene(n_ranks: int):
    """The dry run's tiny scene: a 64x48 camera facing a tilted plane,
    16 surfels per rank, and the plane's target maps."""
    cam = CameraIntrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5,
                           width=64, height=48)
    C = 16 * n_ranks
    rng = np.random.default_rng(0)
    pos = np.zeros((C, 3), np.float32)
    pos[:, 0] = rng.uniform(-0.3, 0.3, C)
    pos[:, 1] = rng.uniform(-0.2, 0.2, C)
    pos[:, 2] = 1.0 + 0.1 * pos[:, 0]
    H, W = cam.height, cam.width
    tm = np.zeros((H, W, 10), np.float32)
    y, x = np.mgrid[0:H, 0:W]
    z = 1.0 + 0.1 * (x - cam.cx) / cam.fx
    tm[..., 0] = (x - cam.cx) * z / cam.fx
    tm[..., 1] = (y - cam.cy) * z / cam.fy
    tm[..., 2] = z
    tm[..., 5] = 1.0     # normal ~ +z
    tm[..., 6] = 53.4    # Lab of RGB (128, 128, 128)
    tm[..., 9] = 1.0
    return cam, pos, tm


def _dryrun_rank(mesh: Mesh) -> dict:
    """One rank of `dryrun`: the sharded ICP linearization against the
    single-rank one, then two frames of the sharded fusion."""
    from supersurfel_fusion_tpu_torch.config import FusionConfig
    from supersurfel_fusion_tpu_torch.ops.icp import _build_system
    from supersurfel_fusion_tpu_torch.parallel.sharding import (
        make_distributed_model,
        make_sharded_update,
        totals,
    )
    from supersurfel_fusion_tpu_torch.utils.color import rgb_to_lab

    dev = mesh.device
    cam, pos, tm = _dryrun_scene(mesh.axis_size)
    C = pos.shape[0]
    model = Supersurfels.empty(C, dev)._replace(
        positions=torch.as_tensor(pos, device=dev),
        colors=torch.full((C, 3), 128.0, device=dev),
        confidences=torch.ones(C, device=dev))
    cfg = ICPConfig(min_inliers=4.0, cov_thresh=1e9)
    tm_t = torch.as_tensor(tm, device=dev)
    eye = torch.eye(3, device=dev)
    zero = torch.zeros(3, device=dev)
    run = make_sharded_icp_step(mesh, cam, cfg)
    JtJ, _, _, inl = run(shard_model(model, mesh), tm_t, eye, zero)
    JtJ_ref, _, _, inl_ref = _build_system(
        model.positions, model.orientations[:, 2, :],
        rgb_to_lab(model.colors), model.confidences > 0, tm_t, eye, zero,
        cam, cfg)
    if not bool(torch.isfinite(JtJ).all()) or float(inl) <= 0:
        raise AssertionError("sharded ICP found no inliers")
    if float(inl) != float(inl_ref):
        raise AssertionError(f"inliers {float(inl)} != {float(inl_ref)}")
    torch.testing.assert_close(JtJ, JtJ_ref, rtol=1e-4, atol=1e-3)

    fcfg = FusionConfig(nb_supersurfels_max=16 * mesh.axis_size,
                        delta_t=1000)
    dm = make_distributed_model(fcfg.nb_supersurfels_max, mesh)
    step = make_sharded_update(mesh, cam, fcfg, conf_thresh=1e9)
    F = 12
    frame = Supersurfels.empty(F, dev)._replace(
        positions=torch.as_tensor(pos[:F], device=dev),
        shapes=torch.eye(3, device=dev).repeat(F, 1, 1) * 1e-4,
        colors=torch.full((F, 3), 120.0, device=dev),
        confidences=torch.full((F,), 150.0, device=dev),
        stamps=torch.zeros((F, 2), dtype=torch.int32, device=dev))
    labels = torch.zeros((cam.height, cam.width), dtype=torch.int32,
                         device=dev)
    pd = torch.ones((cam.height, cam.width), device=dev)
    for k in range(2):
        dm = step(dm, frame, labels, pd, eye, zero,
                  torch.tensor(k, dtype=torch.int32, device=dev))
    nb, nvis = totals(dm, mesh)
    if nb <= 0:
        raise AssertionError("sharded fusion inserted nothing")
    return {"inliers": float(inl), "nb_total": nb, "nb_visible": nvis,
            "nb_local": int(dm.nb_local)}


def dryrun(n_ranks: int, backend: str = "gloo",
           device: str = "cuda") -> list:
    """Validate the sharded path on `n_ranks` spawned ranks at tiny
    shapes: the summed ICP system equals the single-rank one, and the
    sharded fusion inserts (the counterpart of the JAX package's
    `__graft_entry__.dryrun_multichip`). The ranks run on the cards over
    gloo unless told otherwise. Returns each rank's summary; raises if a
    rank fails."""
    from supersurfel_fusion_tpu_torch.parallel.distributed import launch

    return launch(_dryrun_rank, n_ranks, backend=backend, device=device)

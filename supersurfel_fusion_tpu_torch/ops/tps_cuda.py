"""The TPS iteration loop on hand-written CUDA kernels (`csrc/tps.cu`).

Replaces the Pallas TPU kernel `run_iterations` of
`supersurfel_fusion_tpu/ops/tps_pallas.py` (pl.pallas_call at :381) and its
wrapper `segment` (:423-464). Two kernels, launched from a host loop, one
of each per iteration:

* `tps_iteration`: the four checkerboard phases of label reassignment of
  one iteration (K1, with the stat-image rebuild K3 folded in as a lookup
  of the table by label), in one launch;
* `tps_merge`: per-superpixel statistics and, in the RGBD pass, the
  disparity-plane refit (K2).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (built from `ops/tps.py`) for a CPU tensor; there is no
fallback from one to the other. The library is compiled with nvcc for
sm_90a at first use into `_build/`, keyed by the hash of the source and the
flags, and bound with ctypes. State: labels (H, W) int32, inliers (H, W)
f32 0/1 and the table (9, GH, GW) f32 = [cx, cy, r, g, b, n, ta, tb, tc];
tc < -1e29 marks "no plane". Every label lies in the 3x3 cell window of its
pixel's cell, as the grid init and every phase keep it. The kernels rely on
that: `tps_iteration` never offers a label outside it as a candidate, and
freezes a pixel that holds one (kept, no inlier), where the plain version
would still move it; `tps_merge` drops such a pixel, as the plain version
does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from supersurfel_fusion_tpu_torch import tracing
from supersurfel_fusion_tpu_torch.config import TPSConfig
from supersurfel_fusion_tpu_torch.ops import tps as tps_ref

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tps.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
)

# Launches of each kernel since the last reset (plain-version calls on CPU
# tensors do not count).
launch_counts = {"tps_iteration": 0, "tps_merge": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: the TPS CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def build_library() -> tuple[Path, str]:
    """Compile `csrc/tps.cu` into `_build/` unless the library for this
    source and these flags exists. Returns (path, compiler log). The build
    writes a temporary file and renames it, so a killed build never leaves
    a half-written library under the final name."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtps_{key}.so"
    if out.exists():
        return out, ""
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".libtps_", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tps_iteration_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                             f, f, f, f, f, f, p]
        lib.tps_iteration_launch.restype = i
        lib.tps_merge_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.tps_merge_launch.restype = i
        _lib = lib
    return _lib


def _check(name: str, t: Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _check_state(rgb_chw, disp, labels, inliers, table, cs):
    if rgb_chw.device.type != "cuda":
        raise ValueError(f"TPS kernels take CUDA or CPU tensors, got "
                         f"{rgb_chw.device}")
    _, H, W = rgb_chw.shape
    if H % cs or W % cs:
        raise ValueError("image must tile by cell_size")
    if cs % 4 or W % 4:
        raise ValueError("the TPS kernels read 4 pixels at a time: "
                         "cell_size and the width must be multiples of 4")
    dev = rgb_chw.device
    _check("rgb_chw", rgb_chw, torch.float32, (3, H, W), dev)
    _check("disp", disp, torch.float32, (H, W), dev)
    _check("labels", labels, torch.int32, (H, W), dev)
    _check("inliers", inliers, torch.float32, (H, W), dev)
    _check("table", table, torch.float32, (9, H // cs, W // cs), dev)
    for name, t in (("rgb_chw", rgb_chw), ("disp", disp), ("labels", labels),
                    ("inliers", inliers)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the TPS kernels need 16-byte aligned "
                             "data (a fresh contiguous tensor)")
    return H, W


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def merge_reference(rgb_chw: Tensor, disp: Tensor, labels: Tensor,
                    inliers: Tensor, table: Tensor, use_disp: bool,
                    cs: int) -> Tensor:
    """Plain version of `tps_merge`: the table rebuilt from the labels
    (channels 0-5) and, with use_disp, the plane refit (channels 6-8);
    without use_disp channels 6-8 are kept."""
    _, H, W = rgb_chw.shape
    gh, gw = H // cs, W // cs
    st = tps_ref._merge_rgb(rgb_chw.permute(1, 2, 0), labels, gh, gw, cs)
    out = table.clone()
    out[0:2] = st.centroid.permute(2, 0, 1)
    out[2:5] = st.color.permute(2, 0, 1)
    out[5] = st.size
    if use_disp:
        theta = tps_ref.fit_planes(disp, labels, inliers > 0.5, gh, gw, cs)
        bad = torch.isnan(theta[..., 2])
        zero = torch.zeros_like(theta[..., 0])
        out[6] = torch.where(bad, zero, theta[..., 0])
        out[7] = torch.where(bad, zero, theta[..., 1])
        out[8] = torch.where(bad, torch.full_like(zero, -1e30), theta[..., 2])
    return out


def phase_reference(rgb_chw: Tensor, disp: Tensor, labels: Tensor,
                    inliers: Tensor, table: Tensor, phase: int,
                    use_disp: bool, cfg: TPSConfig):
    """One checkerboard phase (order (0,0) (1,1) (0,1) (1,0) by `phase`):
    `tps.phase_update` on the stat image gathered from the table. Returns
    (labels, inliers f32)."""
    _, H, W = rgb_chw.shape
    cs = cfg.cell_size
    gh, gw = H // cs, W // cs
    S = table.permute(1, 2, 0).reshape(gh * gw, 9)[labels.to(torch.int64)]
    lab, inl, _ = tps_ref.phase_update(
        labels, inliers > 0.5, S, rgb_chw.permute(1, 2, 0), disp, phase, cfg,
        use_disp, gh, gw)
    return lab, inl.to(torch.float32)


def iteration_reference(rgb_chw: Tensor, disp: Tensor, labels: Tensor,
                        inliers: Tensor, table: Tensor, use_disp: bool,
                        cfg: TPSConfig):
    """Plain version of `tps_iteration`: the four phases in order, with
    one table. Returns (labels, inliers f32)."""
    for phase in range(4):
        labels, inliers = phase_reference(rgb_chw, disp, labels, inliers,
                                          table, phase, use_disp, cfg)
    return labels, inliers


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def tps_iteration(rgb_chw: Tensor, disp: Tensor, labels: Tensor,
                  inliers: Tensor, table: Tensor, use_disp: bool,
                  cfg: TPSConfig):
    """The four checkerboard phases of one iteration in one launch. Returns
    new (labels, inliers); the inputs are not written. In the RGB pass the
    inliers pass through and the same tensor is returned."""
    if rgb_chw.device.type == "cpu":
        return iteration_reference(rgb_chw, disp, labels, inliers, table,
                                   use_disp, cfg)
    cs = cfg.cell_size
    H, W = _check_state(rgb_chw, disp, labels, inliers, table, cs)
    lib = _library()
    lab_out = torch.empty_like(labels)
    inl_out = torch.empty_like(inliers) if use_disp else inliers
    err = lib.tps_iteration_launch(
        rgb_chw.data_ptr(), disp.data_ptr(), labels.data_ptr(),
        table.data_ptr(), lab_out.data_ptr(),
        inl_out.data_ptr() if use_disp else None, H, W, cs, int(use_disp),
        cfg.lambda_pos, cfg.lambda_bound, cfg.lambda_size, cfg.lambda_disp,
        cfg.thresh_disp, cs * cs / 4.0,
        torch.cuda.current_stream(rgb_chw.device).cuda_stream)
    _raise_on(err, "tps_iteration")
    launch_counts["tps_iteration"] += 1
    return lab_out, inl_out


def tps_merge(rgb_chw: Tensor, disp: Tensor, labels: Tensor, inliers: Tensor,
              table: Tensor, use_disp: bool, cs: int) -> Tensor:
    """Per-superpixel statistics from the labels; returns a new table."""
    if rgb_chw.device.type == "cpu":
        return merge_reference(rgb_chw, disp, labels, inliers, table,
                               use_disp, cs)
    H, W = _check_state(rgb_chw, disp, labels, inliers, table, cs)
    lib = _library()
    out = torch.empty_like(table)
    err = lib.tps_merge_launch(
        rgb_chw.data_ptr(), disp.data_ptr(), labels.data_ptr(),
        inliers.data_ptr(), table.data_ptr(), out.data_ptr(), H, W, cs,
        int(use_disp), torch.cuda.current_stream(rgb_chw.device).cuda_stream)
    _raise_on(err, "tps_merge")
    launch_counts["tps_merge"] += 1
    return out


# ---------------------------------------------------------------------------
# The iteration loop and the drop-in segment()
# ---------------------------------------------------------------------------


def _iterate(iteration_fn, merge_fn, rgb_chw, disp, labels, inliers, table,
             n_iters, use_disp, cfg):
    cs = cfg.cell_size
    table = merge_fn(rgb_chw, disp, labels, inliers, table, use_disp, cs)
    for _ in range(n_iters):
        labels, inliers = iteration_fn(rgb_chw, disp, labels, inliers, table,
                                       use_disp, cfg)
        table = merge_fn(rgb_chw, disp, labels, inliers, table, use_disp, cs)
    return labels, inliers, table


def run_iterations(rgb_chw: Tensor, disp: Tensor, labels: Tensor,
                   inliers: Tensor, table: Tensor, n_iters: int,
                   use_disp: bool, cfg: TPSConfig):
    """One merge, then `n_iters` x (1 iteration + 1 merge), through the
    kernels (CUDA tensors) or their plain versions (CPU tensors).
    rgb_chw (3, H, W) f32; disp (H, W) (inf marks invalid); labels (H, W)
    int32; inliers (H, W) f32 0/1; table (9, GH, GW) f32.
    Returns (labels, inliers, table)."""
    return _iterate(tps_iteration, tps_merge, rgb_chw, disp, labels, inliers,
                    table, n_iters, use_disp, cfg)


def run_iterations_reference(rgb_chw: Tensor, disp: Tensor, labels: Tensor,
                             inliers: Tensor, table: Tensor, n_iters: int,
                             use_disp: bool, cfg: TPSConfig):
    """`run_iterations` on the plain versions, on any device."""
    return _iterate(iteration_reference, merge_reference, rgb_chw, disp,
                    labels, inliers, table, n_iters, use_disp, cfg)


def stats_from_table(table: Tensor) -> tps_ref.SuperpixelStats:
    bad = table[8] < -1e29
    zero = torch.zeros_like(table[6])
    theta = torch.stack(
        [torch.where(bad, zero, table[6]), torch.where(bad, zero, table[7]),
         torch.where(bad, torch.full_like(zero, float("nan")), table[8])],
        dim=-1)
    return tps_ref.SuperpixelStats(
        centroid=torch.stack([table[0], table[1]], dim=-1),
        color=torch.stack([table[2], table[3], table[4]], dim=-1),
        size=table[5],
        theta=theta,
    )


def _segment(iterate, rgb: Tensor, disp: Tensor,
             cfg: TPSConfig) -> tps_ref.TPSResult:
    H, W, _ = rgb.shape
    cs = cfg.cell_size
    if H % cs or W % cs:
        raise ValueError("image must tile by cell_size")
    gh, gw = H // cs, W // cs
    dev = rgb.device
    labels = tps_ref.grid_labels(H, W, cs, dev).contiguous()
    inliers = torch.zeros((H, W), dtype=torch.float32, device=dev)
    rgb_chw = rgb.permute(2, 0, 1).contiguous()
    disp = disp.contiguous()
    table = torch.zeros((9, gh, gw), dtype=torch.float32, device=dev)

    n_rgb = cfg.nb_iters // 2
    with tracing.span("tps.rgb"):
        labels, inliers, table = iterate(rgb_chw, disp, labels, inliers,
                                         table, n_rgb, False, cfg)
    with tracing.span("tps.plane_init"):
        stats = stats_from_table(table)
        if cfg.use_ransac:
            _, inl_b = tps_ref.ransac_plane_init(disp, labels, stats, cfg,
                                                 gh, gw)
        else:
            inl_b = torch.isfinite(disp)
        inliers = inl_b.to(torch.float32)
    with tracing.span("tps.rgbd"):
        labels, inliers, table = iterate(rgb_chw, disp, labels, inliers,
                                         table, cfg.nb_iters - n_rgb, True,
                                         cfg)
    return tps_ref.TPSResult(
        labels=labels,
        boundary=tps_ref.boundary_count(labels),
        inliers=inliers > 0.5,
        stats=stats_from_table(table),
        disp=disp,
    )


def segment(rgb: Tensor, disp: Tensor, cfg: TPSConfig) -> tps_ref.TPSResult:
    """TPS segmentation on the kernels (same contract as `tps.segment`):
    an RGB-only `run_iterations` of nb_iters//2, the RANSAC plane init, then
    an RGBD `run_iterations` of the rest. Once-per-iteration merge cadence
    only (`merge_every_phase=False`)."""
    if cfg.merge_every_phase:
        raise ValueError("the TPS kernels implement the once-per-iteration "
                         "merge cadence; use ops.tps.segment")
    return _segment(run_iterations, rgb, disp, cfg)


def segment_reference(rgb: Tensor, disp: Tensor,
                      cfg: TPSConfig) -> tps_ref.TPSResult:
    """`segment` on the plain versions, on any device."""
    return _segment(run_iterations_reference, rgb, disp, cfg)

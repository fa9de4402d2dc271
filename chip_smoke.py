#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, `nvcc`
(on PATH or under $CUDA_HOME, default /usr/local/cuda) and PyTorch built
for CUDA. It imports only the port (`supersurfel_fusion_tpu_torch`), never
JAX, and:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the TPS kernels (`csrc/tps.cu`, nvcc for sm_90a) from the sources;
3. kernel phase: at 640x480 on a synthetic frame, holds each kernel
   (`tps_phase`, `tps_merge`) against its plain PyTorch version on the same
   inputs, and the kernel-backed TPS segmentation against the plain one,
   and times kernel, plain version, bound and library yardstick;
4. pipeline phase: drives the default `PipelineConfig` frame step through
   `SupersurfelFusion` on a synthetic clip with a known trajectory, counts
   the kernel launches, checks tracking, and holds the first frames against
   the plain CPU path;
5. prints the kernel table as one JSON line and, last,
   {"ok": true, "device": {...}}.

Any failed check raises, and the script then exits non-zero without the
last line. It also exits non-zero when no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Total wall-time budget of the run, cold build included (seconds).
BUDGET_S = 600.0
N_FRAMES = 30         # pipeline phase frames
N_CPU_FRAMES = 3      # frames also run on the plain CPU path
H100_HBM_BPS = 3.35e12
H100_FP32_FLOPS = 67e12

_T0 = time.time()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_done(name: str, t0: float) -> None:
    now = time.time()
    log(f"[phase] {name}: {now - t0:.2f} s (total {now - _T0:.2f} s)")
    if now - _T0 > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S:.0f} s budget after {name}")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean stream time of fn() over `reps` eager calls, CUDA events (host
    launch overhead included where it exceeds the device time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device time of fn(): `reps` calls captured in one CUDA graph,
    replayed `replays` times between CUDA events, so host launch overhead
    is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def header():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")


def build():
    from supersurfel_fusion_tpu_torch.ops import tps_cuda

    t0 = time.time()
    path, compiler_log = tps_cuda.build_library()
    log(f"built {path.name} in {time.time() - t0:.2f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")


def kernel_phase(dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from supersurfel_fusion_tpu_torch.config import PipelineConfig
    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.ops import tps as tps_ref
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.ops.depth import (
        bilateral_filter,
        depth_to_disp,
    )

    cfg = PipelineConfig()
    tcfg = cfg.tps
    cam = cfg.cam
    H, W, cs = cam.height, cam.width, tcfg.cell_size
    gh, gw = H // cs, W // cs
    R, t = synthetic.trajectory(8)[7]
    rgb_u8, depth_u16 = synthetic.render(cam, R, t)
    rgb = torch.from_numpy(rgb_u8).to(dev).float()
    depth = torch.from_numpy(depth_u16).to(dev).float() * cfg.depth_scale
    disp = depth_to_disp(bilateral_filter(
        depth, cfg.bilateral_sigma_value, cfg.bilateral_sigma_space,
        cfg.bilateral_radius)).contiguous()
    rgb_chw = rgb.permute(2, 0, 1).contiguous()

    # the whole segmentation: kernels vs plain versions, on the card
    k = tps_cuda.segment(rgb, disp, tcfg)
    p = tps_cuda.segment_reference(rgb, disp, tcfg)
    torch.cuda.synchronize()
    agree = (k.labels == p.labels).float().mean().item()
    log(f"  segment labels agreement {agree:.5f}")
    check(agree >= 0.99, "kernel vs plain segment: labels agree >= 0.99")
    check(float(k.stats.size.sum()) == H * W,
          f"kernel segment: sum(size) == {H * W}")
    fin_k = torch.isfinite(k.stats.theta[..., 2])
    fin_p = torch.isfinite(p.stats.theta[..., 2])
    log(f"  finite planes: kernel {fin_k.float().mean().item():.4f} "
        f"plain {fin_p.float().mean().item():.4f}")
    check(fin_k.float().mean().item() >= 0.9, "finite plane share >= 0.9")
    both = fin_k & fin_p
    th_med = (k.stats.theta[both] - p.stats.theta[both]).abs().median()
    log(f"  theta median |diff| {th_med.item():.3e}")
    check(th_med.item() < 1e-4, "theta median diff < 1e-4")

    # a mid-run state at the main path's shapes: the RGB pass, then the
    # RANSAC inliers, as the second call of run_iterations receives it
    labels0 = tps_ref.grid_labels(H, W, cs, dev).contiguous()
    table0 = torch.zeros((9, gh, gw), dtype=torch.float32, device=dev)
    zeros = torch.zeros((H, W), dtype=torch.float32, device=dev)
    labels, _, table = tps_cuda.run_iterations_reference(
        rgb_chw, disp, labels0, zeros, table0, tcfg.nb_iters // 2, False,
        tcfg)
    _, inl = tps_ref.ransac_plane_init(
        disp, labels, tps_cuda.stats_from_table(table), tcfg, gh, gw)
    inliers = inl.float().contiguous()
    table_d = tps_cuda.merge_reference(rgb_chw, disp, labels, inliers, table,
                                       True, cs)

    # tps_phase: exact agreement expected (same arithmetic, no fma)
    phase_err = 0.0
    for use_disp, tab in ((False, table), (True, table_d)):
        for ph in range(4):
            lk, ik = tps_cuda.tps_phase(rgb_chw, disp, labels, inliers, tab,
                                        ph, use_disp, tcfg)
            lp, ip = tps_cuda.phase_reference(rgb_chw, disp, labels, inliers,
                                              tab, ph, use_disp, tcfg)
            n_lab = int((lk != lp).sum())
            n_inl = int((ik != ip).sum())
            phase_err = max(phase_err, float((lk - lp).abs().max()),
                            float((ik - ip).abs().max()))
            log(f"  tps_phase use_disp={use_disp} phase={ph}: "
                f"{n_lab} label and {n_inl} inlier mismatches")
            check(n_lab <= 0.0005 * H * W and n_inl <= 0.0005 * H * W,
                  f"tps_phase ({use_disp}, {ph}) matches plain version")

    # tps_merge: sums in another order; stats and plane disparity at the
    # centroid held to f32 summation tolerance
    merge_err = 0.0
    for use_disp in (False, True):
        mk = tps_cuda.tps_merge(rgb_chw, disp, labels, inliers, table,
                                use_disp, cs)
        mp = tps_cuda.merge_reference(rgb_chw, disp, labels, inliers, table,
                                      use_disp, cs)
        err_stats = float((mk[:6] - mp[:6]).abs().max())
        tol = 1e-3 + 1e-5 * float(mp[:6].abs().max())
        log(f"  tps_merge use_disp={use_disp}: stats max |err| "
            f"{err_stats:.3e} (tol {tol:.1e})")
        check(err_stats <= tol, f"tps_merge ({use_disp}) stats match")
        merge_err = max(merge_err, err_stats)
        if use_disp:
            sk = tps_cuda.stats_from_table(mk)
            sp = tps_cuda.stats_from_table(mp)
            cx, cy = sp.centroid[..., 0], sp.centroid[..., 1]
            dk = tps_ref.eval_plane(sk.theta, cx, cy)
            dp = tps_ref.eval_plane(sp.theta, cx, cy)
            ok = torch.isfinite(dk) & torch.isfinite(dp)
            same_fit = (torch.isfinite(dk) == torch.isfinite(dp)).float()
            d_err = (dk[ok] - dp[ok]).abs()
            frac = (d_err <= 1e-4).float().mean().item()
            log(f"  tps_merge planes: fit flags agree "
                f"{same_fit.mean().item():.4f}, disparity at centroid "
                f"max |err| {d_err.max().item():.3e}, share <= 1e-4: "
                f"{frac:.4f}")
            check(same_fit.mean().item() >= 0.99 and frac >= 0.99,
                  "tps_merge planes match")

    # times: kernel, plain version, library yardstick. Device time from
    # CUDA-graph replays; the eager per-call time is printed beside it
    def phase_k():
        tps_cuda.tps_phase(rgb_chw, disp, labels, inliers, table_d, 0, True,
                           tcfg)

    def phase_p():
        tps_cuda.phase_reference(rgb_chw, disp, labels, inliers, table_d, 0,
                                 True, tcfg)

    def merge_k():
        tps_cuda.tps_merge(rgb_chw, disp, labels, inliers, table_d, True, cs)

    def merge_p():
        tps_cuda.merge_reference(rgb_chw, disp, labels, inliers, table_d,
                                 True, cs)

    # library yardstick for the merge: one scatter_add_ of the 15 per-pixel
    # features of the RGBD merge by label
    y = torch.arange(H, device=dev, dtype=torch.float32)[:, None].expand(H, W)
    x = torch.arange(W, device=dev, dtype=torch.float32)[None, :].expand(H, W)
    feats = torch.stack([torch.ones_like(x), x, y, rgb_chw[0], rgb_chw[1],
                         rgb_chw[2]] + [inliers * x] * 9, -1).reshape(-1, 15)
    idx = labels.reshape(-1, 1).to(torch.int64).expand(-1, 15)
    acc = torch.zeros((gh * gw, 15), dtype=torch.float32, device=dev)

    def scatter():
        acc.zero_().scatter_add_(0, idx, feats)

    ms_phase = graph_time_ms(phase_k, 100)
    ms_phase_plain = graph_time_ms(phase_p, 10)
    ms_merge = graph_time_ms(merge_k, 100)
    ms_merge_plain = graph_time_ms(merge_p, 10)
    ms_scatter = graph_time_ms(scatter, 100)
    eager_phase = cuda_time_ms(phase_k, 100)
    eager_merge = cuda_time_ms(merge_k, 100)
    ms_seg = cuda_time_ms(lambda: tps_cuda.segment(rgb, disp, tcfg), 5)
    ms_seg_plain = cuda_time_ms(
        lambda: tps_cuda.segment_reference(rgb, disp, tcfg), 3)

    # bounds from this run's shapes: each input read once, each output
    # written once; operations counted from the data where they depend on it
    npx = H * W
    tab_bytes = 9 * gh * gw * 4
    phase_bytes = npx * (3 * 4 + 4 + 4 + 4) + tab_bytes + npx * (4 + 4)
    b = tps_ref.boundary_count(labels) > 0
    phase_ops = 40 * npx + 4 * 40 * int(b.sum()) // 4
    merge_bytes = npx * (3 * 4 + 4 + 4 + 4) + 2 * tab_bytes
    merge_ops = 35 * npx
    bound_phase = max(phase_bytes / H100_HBM_BPS,
                      phase_ops / H100_FP32_FLOPS) * 1e3
    bound_merge = max(merge_bytes / H100_HBM_BPS,
                      merge_ops / H100_FP32_FLOPS) * 1e3
    log(f"  tps_phase {ms_phase * 1e3:.2f} us device (eager call "
        f"{eager_phase * 1e3:.2f} us; plain {ms_phase_plain * 1e3:.1f} us, "
        f"bound {bound_phase * 1e3:.2f} us)")
    log(f"  tps_merge {ms_merge * 1e3:.2f} us device (eager call "
        f"{eager_merge * 1e3:.2f} us; plain {ms_merge_plain * 1e3:.1f} us, "
        f"bound {bound_merge * 1e3:.2f} us, scatter_add_ "
        f"{ms_scatter * 1e3:.2f} us)")
    log(f"  TPS segment: kernels {ms_seg:.3f} ms, plain {ms_seg_plain:.3f} ms")
    return {
        "tps_phase": dict(max_abs_err=phase_err, ms=ms_phase,
                          plain_ms=ms_phase_plain, bound_ms=bound_phase,
                          bound_by="bytes" if phase_bytes / H100_HBM_BPS
                          >= phase_ops / H100_FP32_FLOPS else "operations",
                          library_ms=None),
        "tps_merge": dict(max_abs_err=merge_err, ms=ms_merge,
                          plain_ms=ms_merge_plain, bound_ms=bound_merge,
                          bound_by="bytes" if merge_bytes / H100_HBM_BPS
                          >= merge_ops / H100_FP32_FLOPS else "operations",
                          library_ms=ms_scatter),
    }


def pipeline_phase(dev):
    """The default frame step on the card through the user's entry point."""
    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.config import PipelineConfig
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    cfg = PipelineConfig()
    t0 = time.time()
    clip = synthetic.frames(cfg.cam, N_FRAMES)
    log(f"  rendered {N_FRAMES} frames in {time.time() - t0:.2f} s")

    slam = SupersurfelFusion(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tps_cuda.reset_launch_counts()
    outs, frame_s = [], []
    for k, (rgb, depth, _) in enumerate(clip):
        t1 = time.time()
        out = slam.process(rgb, depth, timestamp=float(k))
        torch.cuda.synchronize()
        frame_s.append(time.time() - t1)
        outs.append(out)
    launches = dict(tps_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    log(f"  launches {launches} over {N_FRAMES} frames")
    check(launches["tps_phase"] == 40 * N_FRAMES,
          "40 tps_phase launches per frame")
    check(launches["tps_merge"] == 12 * N_FRAMES,
          "12 tps_merge launches per frame")
    steady = frame_s[2:]
    log(f"  ms/frame: first {frame_s[0] * 1e3:.1f}, steady mean "
        f"{np.mean(steady) * 1e3:.2f} median {np.median(steady) * 1e3:.2f} "
        f"(frames 2..{N_FRAMES - 1}); peak memory "
        f"{peak / 2**20:.1f} MiB")

    gt = synthetic.trajectory(N_FRAMES)
    traj = np.array(slam.trajectory)
    err = np.linalg.norm(traj[:, :3] - np.array([t for _, t in gt]), axis=1)
    icp_ok = np.array([bool(o.icp_valid) for o in outs])
    vo_ok = np.array([bool(o.vo_valid) for o in outs])
    nb = int(outs[-1].nb_supersurfels)
    log(f"  icp valid {icp_ok[1:].mean():.3f}, vo valid {vo_ok[1:].mean():.3f}"
        f", nb_supersurfels {nb}, nb_visible {int(outs[-1].nb_visible)}")
    log(f"  translation error vs known trajectory: final {err[-1]:.4f} m, "
        f"max {err.max():.4f} m")
    check(nb > 0, "nb_supersurfels > 0")
    check(bool(np.isfinite(traj).all()), "all poses finite")
    check(icp_ok[1:].mean() >= 0.8, "ICP valid on >= 80% of frames after the "
          "first")
    check(err.max() < 0.05, "drift against the known trajectory < 0.05 m")

    # the same first frames through the plain CPU path
    ref = SupersurfelFusion(cfg, device="cpu")
    for k, (rgb, depth, _) in enumerate(clip[:N_CPU_FRAMES]):
        ref.process(rgb, depth, timestamp=float(k))
    ref_traj = np.array(ref.trajectory)
    d = np.abs(ref_traj[:, :3] - traj[:N_CPU_FRAMES, :3]).max()
    log(f"  card vs plain CPU path, first {N_CPU_FRAMES} poses: max |dt| "
        f"{d:.2e} m")
    check(d < 2e-3, "card pipeline agrees with the plain CPU path "
          "(|dt| < 2 mm)")
    return launches, float(np.mean(steady) * 1e3), peak


def main() -> int:
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 2
    # the port must be importable from here (run from the repository root)
    import supersurfel_fusion_tpu_torch  # noqa: F401

    dev = torch.device("cuda", 0)
    t0 = time.time()
    header()
    phase_done("header", t0)

    t0 = time.time()
    build()
    phase_done("build", t0)

    t0 = time.time()
    kern = kernel_phase(dev)
    phase_done("kernels", t0)

    t0 = time.time()
    launches, ms_frame, peak = pipeline_phase(dev)
    phase_done("pipeline", t0)

    rows = []
    for name in ("tps_phase", "tps_merge"):
        r = kern[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "supersurfel_fusion_tpu_torch/csrc/tps.cu",
            "replaces": "supersurfel_fusion_tpu/ops/tps_pallas.py:381",
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(f"pipeline: {ms_frame:.2f} ms/frame steady, peak "
        f"{peak / 2**20:.1f} MiB, total {time.time() - _T0:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

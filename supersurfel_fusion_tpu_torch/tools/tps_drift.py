"""How far the TPS route moves the trajectory of the default frame step.

    python -m supersurfel_fusion_tpu_torch.tools.tps_drift \\
        [--frames 30] [--cpu-frames 3] [--device cuda]

Drives the default `PipelineConfig` through `SupersurfelFusion` on the
synthetic clip once per TPS route, on one device:

* `kernels`: `tps_iteration` + `tps_merge`, the main path. On each frame the
  segmentation is also computed by the plain versions from the same input,
  and the two are compared (label agreement, plane disparity at the
  centroid);
* `plain`: `iteration_reference` + `merge_reference` on the same device;
* `kernels, merge +1 ulp` / `-1 ulp`, `plain, merge +1 ulp`: each merged
  table moved by one f32 ulp (`torch.nextafter`), a perturbation the size
  of one rounding, to show how far rounding alone moves the trajectory.

For each route it prints the largest translation error against the known
trajectory and the largest |dt| of the first `--cpu-frames` poses against
the plain CPU path, then one JSON line with all of it. On the CPU the
wrappers run their plain versions, so `kernels` and `plain` coincide there.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from supersurfel_fusion_tpu_torch import pipeline, synthetic
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.ops import tps as tps_ref
from supersurfel_fusion_tpu_torch.ops import tps_cuda


def _iterate_with(iteration_fn, merge_fn):
    def iterate(rgb_chw, disp, labels, inliers, table, n_iters, use_disp,
                cfg):
        return tps_cuda._iterate(iteration_fn, merge_fn, rgb_chw, disp,
                                 labels, inliers, table, n_iters, use_disp,
                                 cfg)
    return iterate


def _nudged(merge_fn, direction: float):
    def merge(*args):
        t = merge_fn(*args)
        return torch.nextafter(t, torch.full_like(t, direction * np.inf))
    return merge


def _segment_with(iterate):
    return lambda rgb, disp, cfg: tps_cuda._segment(iterate, rgb, disp,
                                                    cfg.tps)


def _run(cfg, clip, device, segment_fn):
    saved = pipeline._segment
    pipeline._segment = segment_fn
    try:
        slam = pipeline.SupersurfelFusion(cfg, device=device)
        outs = [slam.process(rgb, depth, timestamp=float(k))
                for k, (rgb, depth, _) in enumerate(clip)]
    finally:
        pipeline._segment = saved
    icp = float(np.mean([bool(o.icp_valid) for o in outs[1:]]))
    return np.array(slam.trajectory), icp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--cpu-frames", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("tps_drift needs a CUDA device (or --device cpu)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)

    cfg = PipelineConfig()
    clip = synthetic.frames(cfg.cam, args.frames)
    gt = np.array([t for _, t in synthetic.trajectory(args.frames)])
    cpu_traj, _ = _run(cfg, clip[:args.cpu_frames], "cpu", pipeline._segment)

    # the main path, with the plain segmentation of each frame's own input
    per_frame = []
    main_segment = pipeline._segment

    def compared(rgb, disp, c):
        k = main_segment(rgb, disp, c)
        p = tps_cuda.segment_reference(rgb, disp, c.tps)
        cx, cy = p.stats.centroid[..., 0], p.stats.centroid[..., 1]
        dk = tps_ref.eval_plane(k.stats.theta, cx, cy)
        dp = tps_ref.eval_plane(p.stats.theta, cx, cy)
        ok = torch.isfinite(dk) & torch.isfinite(dp)
        per_frame.append({
            "labels_agree": (k.labels == p.labels).float().mean().item(),
            "plane_flags_agree":
                (torch.isfinite(dk) == torch.isfinite(dp)).float()
                .mean().item(),
            "disp_at_centroid_max_err": (dk[ok] - dp[ok]).abs().max().item(),
        })
        return k

    plain = _iterate_with(tps_cuda.iteration_reference,
                          tps_cuda.merge_reference)
    routes = {
        "kernels": compared,
        "plain": _segment_with(plain),
        "kernels, merge +1 ulp": _segment_with(_iterate_with(
            tps_cuda.tps_iteration, _nudged(tps_cuda.tps_merge, 1.0))),
        "kernels, merge -1 ulp": _segment_with(_iterate_with(
            tps_cuda.tps_iteration, _nudged(tps_cuda.tps_merge, -1.0))),
        "plain, merge +1 ulp": _segment_with(_iterate_with(
            tps_cuda.iteration_reference,
            _nudged(tps_cuda.merge_reference, 1.0))),
    }
    rows = {}
    for name, segment_fn in routes.items():
        tps_cuda.reset_launch_counts()
        traj, icp = _run(cfg, clip, device, segment_fn)
        err = np.linalg.norm(traj[:, :3] - gt, axis=1)
        n = min(args.cpu_frames, len(traj))
        rows[name] = {
            "drift_max_m": float(err.max()),
            "drift_final_m": float(err[-1]),
            "icp_valid": icp,
            "vs_cpu_max_dt_m": float(np.abs(traj[:n, :3]
                                            - cpu_traj[:n, :3]).max()),
            "launches": dict(tps_cuda.launch_counts),
        }
        print(f"{name:<24} drift max {err.max():.4f} m final {err[-1]:.4f}"
              f" m, icp valid {icp:.3f}, first {n} poses vs CPU max |dt| "
              f"{rows[name]['vs_cpu_max_dt_m']:.3e} m, launches "
              f"{rows[name]['launches']}", flush=True)
    agree = [f["labels_agree"] for f in per_frame]
    flags = [f["plane_flags_agree"] for f in per_frame]
    derr = [f["disp_at_centroid_max_err"] for f in per_frame]
    print(f"kernels vs plain segmentation on each frame's input: labels "
          f"agree min {min(agree):.6f} mean {np.mean(agree):.6f}, plane "
          f"flags agree min {min(flags):.6f}, disparity at centroid max "
          f"|err| {max(derr):.3e}", flush=True)
    print(json.dumps({"routes": rows, "per_frame": per_frame}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

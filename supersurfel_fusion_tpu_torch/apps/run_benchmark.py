"""TUM RGB-D benchmark runner (CLI) of the PyTorch/CUDA port.

Port of `supersurfel_fusion_tpu/apps/run_benchmark.py` (the reference's
`supersurfel_fusion_rgbd_benchmark_node`): replays a TUM sequence
synchronously through the frame step, writes a TUM-format trajectory and
prints one JSON line with the run's statistics (with `stage_ms`, the mean
host ms per frame of each span of the port's recorder, `tracing.py`, over
the run's last 4096 frames, and `graphs`: the stages and parts captured as
CUDA graphs, the host ms of their capture and, over the same frames, the
mean stages and parts per frame replayed and run op by op and the ops run
eagerly between parts, `SupersurfelFusion.graph_report`) and, when the
sequence has ground truth, ATE and RPE.

Usage:
  python -m supersurfel_fusion_tpu_torch.apps.run_benchmark \\
      --dataset /path/to/rgbd_dataset_freiburg1_xyz \\
      [--max-frames N] [--out estimated.txt] [--cam fr1|fr2|fr3] [--cpu]
      [--loop-closure] [--mod [--yolo]]

It runs on the CUDA card; `--cpu` runs the plain PyTorch path on the CPU,
and nothing else selects it. PNG frames are decoded by the port's native
loader (`csrc/tum_loader.cpp`, built with g++ on first use, linking only
pthread) ahead of the frame step, or with PIL where it cannot be built;
the JSON line says which.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", required=True, help="TUM sequence directory")
    ap.add_argument("--out", default=None, help="trajectory output path")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--cam", default="auto",
                    choices=["auto", "fr1", "fr2", "fr3"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
    ap.add_argument("--mod", action="store_true",
                    help="enable moving-object detection")
    ap.add_argument("--yolo", action="store_true",
                    help="combined MOD: person detector + flood fill "
                         "(needs --weights)")
    ap.add_argument("--weights", default="weights/person_detector.npz",
                    help="person-detector .npz checkpoint for --yolo")
    ap.add_argument("--no-vo", action="store_true",
                    help="disable sparse VO (ICP only)")
    ap.add_argument("--no-icp", action="store_true",
                    help="disable dense ICP (VO only)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="enable ferns + global loop closure")
    ap.add_argument("--save-model", default=None,
                    help="export the final model (reference text format, "
                         "or .ply)")
    ap.add_argument("--dump-images", default=None, metavar="DIR",
                    help="write superpixel/slanted-plane/MOD-mask/model "
                         "renders for every --dump-every frames to DIR")
    ap.add_argument("--dump-every", type=int, default=25)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--stats", action="store_true",
                    help="read tracking stats from the device during the "
                         "run (the default prints them after the run)")
    return ap.parse_args(argv)


def _config(args, C):
    name = os.path.basename(os.path.normpath(args.dataset))
    cam_key = args.cam
    if cam_key == "auto":
        cam_key = "fr1"
        for k in ("freiburg1", "freiburg2", "freiburg3"):
            if k in name:
                cam_key = "fr" + k[-1]
    cam = {"fr1": C.CameraIntrinsics.tum_fr1,
           "fr2": C.CameraIntrinsics.tum_fr2,
           "fr3": C.CameraIntrinsics.tum_fr3}[cam_key]()
    weights = args.weights if args.yolo and os.path.exists(args.weights) \
        else ""
    if args.yolo and not weights and not args.quiet:
        print(f"--yolo: weights {args.weights} not found; running simple "
              "MOD", flush=True)
    cfg = C.PipelineConfig(
        cam=cam, depth_scale=args.depth_scale,
        mod=C.MODConfig(enabled=args.mod or args.yolo,
                        use_yolo=bool(weights), weights_path=weights),
        enable_sparse_vo=not args.no_vo, enable_icp=not args.no_icp,
        enable_loop_closure=args.loop_closure)
    if args.loop_closure:
        cfg = dataclasses.replace(cfg, ferns=C.FernsConfig(enabled=True))
    return name, cfg


def _dump(d, i, f, out, slam, cfg):
    from supersurfel_fusion_tpu_torch.viz import render as rv

    labels = out.labels.cpu().numpy()
    rv.save_png(os.path.join(d, f"superpixels_{i:05d}.png"),
                rv.superpixel_image(f.rgb, labels))
    rv.save_png(os.path.join(d, f"slanted_plane_{i:05d}.png"),
                rv.slanted_plane_image(out.plane_depth.cpu().numpy()))
    if cfg.mod.enabled:
        rv.save_png(os.path.join(d, f"mod_mask_{i:05d}.png"),
                    rv.mod_mask_image(labels, out.static_sp.cpu().numpy()))
    m = slam.state.model
    s = m.surfels
    cam = cfg.cam
    rv.save_png(os.path.join(d, f"model_{i:05d}.png"), rv.model_image(
        s.positions.cpu().numpy(), s.colors.cpu().numpy(),
        s.dims.cpu().numpy(), s.confidences.cpu().numpy(),
        int(m.nb_supersurfels), out.pose.R.cpu().numpy(),
        out.pose.t.cpu().numpy(), cam.fx, cam.fy, cam.cx, cam.cy,
        cam.width, cam.height))


def main(argv=None) -> int:
    args = _args(argv)

    import torch

    from supersurfel_fusion_tpu_torch import config as C
    from supersurfel_fusion_tpu_torch import tracing
    from supersurfel_fusion_tpu_torch.device import resolve_device
    from supersurfel_fusion_tpu_torch.eval.trajectory import ate, rpe
    from supersurfel_fusion_tpu_torch.io.tum import (
        TUMDataset,
        TUMFrame,
        write_trajectory,
    )
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"run_benchmark: {e}", file=sys.stderr)
        return 2

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    name, cfg = _config(args, C)
    ds = TUMDataset(args.dataset, depth_scale=args.depth_scale)
    n = len(ds) if args.max_frames is None else min(args.max_frames, len(ds))

    # native prefetching loader (background PNG decode); PIL fallback
    prefetcher, loader = None, "pil"
    try:
        from supersurfel_fusion_tpu_torch.io.native_loader import (
            PrefetchingLoader,
        )

        pairs = [(os.path.join(args.dataset, a.rgb_file),
                  os.path.join(args.dataset, a.depth_file))
                 for a in ds.associations[:n]]
        prefetcher = PrefetchingLoader(pairs, cfg.cam.width, cfg.cam.height)
        loader = "native"
    except Exception as e:  # no toolchain / build failure
        if not args.quiet:
            print(f"native loader unavailable ({e}); using PIL", flush=True)

    def get_frame(i):
        # raw uint8 rgb + uint16 depth: the frame step converts them on
        # the device
        if prefetcher is not None:
            rgb, depth16 = prefetcher.get(i)
            a = ds.associations[i]
            return TUMFrame(i, a.rgb_ts, rgb, depth16, a.gt)
        return ds.load_frame_raw(i)

    if args.dump_images:
        os.makedirs(args.dump_images, exist_ok=True)

    slam = SupersurfelFusion(cfg, device=dev)
    first_frame = tracing.RECORDER.count
    t_first = None
    # tracking stats are gathered on the device every 50 frames and read
    # once after the run (or live with --stats)
    windows = []
    out = None
    for i in range(n):
        f = get_frame(i)
        out = slam.process(f.rgb, f.depth, f.timestamp)
        if i == 0:
            sync()
            t_first = time.time()
        if i % 50 == 0:
            if not args.quiet:
                print(f"frame {i}/{n}", flush=True)
            windows.append((i, torch.stack([
                out.icp_valid.to(torch.int32), out.nb_supersurfels,
                out.nb_visible, out.vo_matches.to(torch.int32)])))
            if args.stats and not args.quiet:
                print(f"  icp_valid={bool(out.icp_valid)} "
                      f"nb={int(out.nb_supersurfels)} "
                      f"vis={int(out.nb_visible)}", flush=True)
        if args.dump_images and i % args.dump_every == 0:
            _dump(args.dump_images, i, f, out, slam, cfg)
    if prefetcher is not None:
        prefetcher.close()
    sync()
    t_end = time.time()
    steady = n - 1 if n > 1 else 1
    fps = steady / max(t_end - t_first, 1e-9) if t_first else 0.0

    if not args.quiet and not args.stats and windows:
        sv = torch.stack([w for _, w in windows]).cpu().numpy()
        for (i, _), row in zip(windows, sv):
            print(f"frame {i}: icp_valid={bool(row[0])} nb={row[1]} "
                  f"vis={row[2]} vo_matches={row[3]}", flush=True)

    traj_path = args.out or os.path.join(tempfile.gettempdir(),
                                         f"estimated_{name}.txt")
    write_trajectory(traj_path, slam.stamps, slam.trajectory)

    st = slam.state
    if args.save_model:
        from supersurfel_fusion_tpu_torch.io.export import (
            export_model,
            export_model_ply,
        )

        nmod = int(st.model.nb_supersurfels)
        if args.save_model.endswith(".ply"):
            export_model_ply(args.save_model, st.model.surfels, nmod)
        else:
            export_model(args.save_model, st.model.surfels, nmod,
                         cfg.conf_thresh)

    # silent-cap warnings: each is an accuracy cliff the run would hide
    vis_peak = int(st.vis_peak)
    dropped = int(st.dropped_total)
    if vis_peak > cfg.fusion.visible_cap:
        print(f"WARNING: peak nb_visible {vis_peak} exceeded visible_cap "
              f"{cfg.fusion.visible_cap}: projective association/ICP were "
              f"truncated; raise FusionConfig.visible_cap", file=sys.stderr)
    if dropped > 0:
        print(f"WARNING: {dropped} frame surfels dropped at the "
              f"nb_supersurfels_max={cfg.fusion.nb_supersurfels_max} "
              f"capacity ceiling", file=sys.stderr)
    use_ferns = cfg.ferns.enabled or cfg.enable_loop_closure
    if use_ferns and int(st.kf_store.db.count) >= cfg.ferns.max_keyframes:
        print(f"WARNING: keyframe store saturated at "
              f"{cfg.ferns.max_keyframes}; later keyframes were not "
              f"recorded (raise FernsConfig.max_keyframes)", file=sys.stderr)

    est = {t: p for t, p in zip(slam.stamps, slam.trajectory)}
    gt = {a.rgb_ts: a.gt for a in ds.associations[:n] if a.gt is not None}
    # 104 B/surfel: 24 floats + int2, as the reference counts it
    model_mb = int(st.model.nb_supersurfels) * 104 / 1e6
    recorded = tracing.frames(first_frame)
    result = {"frames": n, "fps": round(fps, 2), "trajectory": traj_path,
              "model_mb": round(model_mb, 2), "device": str(dev),
              "loader": loader, "stage_ms": tracing.stage_ms(recorded),
              "graphs": slam.graph_report(recorded)}
    if use_ferns:
        result["lc_count"] = int(st.lc_count)
        result["keyframes"] = int(st.kf_store.db.count)
    if len(gt) > 2:
        r = ate(est, gt)
        result.update(ate_rmse=round(r.rmse, 4), ate_mean=round(r.mean, 4),
                      ate_max=round(r.max, 4))
        rp = rpe(est, gt)
        result.update(rpe_trans=round(rp.trans_rmse, 4))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

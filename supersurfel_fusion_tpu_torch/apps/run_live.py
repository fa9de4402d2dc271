"""Live (streaming) SLAM runner of the PyTorch/CUDA port: the reference's
live sensor node without ROS.

Port of `supersurfel_fusion_tpu/apps/run_live.py`. It consumes an
unbounded stream of RGB-D frames as they arrive, writes the pose of each
frame online, and can write the node's visualization images and the final
model. Two transports:

* ``--watch DIR``: poll a directory laid out like a TUM sequence
  (``rgb/<stamp>.png`` and ``depth/<stamp>.png``) that another process
  fills (a camera driver, `tools/stream_feeder.py`). New rgb and depth
  files are paired by the closest timestamp (<= 0.02 s) and processed in
  stamp order once both files have stopped growing; ``--idle-timeout``
  seconds without a new frame end the stream.
* ``--stdin``: read lines ``<rgb_path> <depth_path> [timestamp]`` from
  standard input; the end of input ends the stream.

Outputs: one TUM-format pose line per frame, appended and flushed to
``--out``; ``--render-every N`` writes the superpixel, slanted-plane, MOD
mask and model images to ``--render-dir``; ``--save-model`` exports the
final model. The last line on standard output is one JSON object
(``frames``, ``fps``, ``trajectory``).

Frames are processed in order and none is dropped: a feed faster than the
frame step builds a backlog.

It runs on the CUDA card; ``--cpu`` runs the plain PyTorch path on the
CPU, and nothing else selects it (without a card and without ``--cpu`` it
exits with code 2). Demo:

  python -m supersurfel_fusion_tpu_torch.tools.stream_feeder \\
      --dataset .../rgbd_dataset_freiburg1_xyz --target /tmp/live --fps 30 &
  python -m supersurfel_fusion_tpu_torch.apps.run_live --watch /tmp/live \\
      --out /tmp/live_traj.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _load_png_pair(rgb_path: str, depth_path: str):
    from PIL import Image

    rgb = np.asarray(Image.open(rgb_path), dtype=np.uint8)[..., :3]
    depth = np.ascontiguousarray(
        np.asarray(Image.open(depth_path)).astype(np.uint16))
    return rgb, depth


def _stamp_of(fname: str) -> float:
    try:
        return float(os.path.splitext(os.path.basename(fname))[0])
    except ValueError:
        return -1.0


class DirectoryStream:
    """Poll `root`/rgb and `root`/depth for new frames; pair them by the
    closest timestamp (<= max_dt) and yield (stamp, rgb_path, depth_path)
    in stamp order. A pair is consumed only once both files have stopped
    growing (the same size on two polls), so a PNG still being written is
    never decoded."""

    def __init__(self, root: str, max_dt: float = 0.02,
                 poll_interval: float = 0.05, idle_timeout: float = 10.0):
        self.rgb_dir = os.path.join(root, "rgb")
        self.depth_dir = os.path.join(root, "depth")
        self.max_dt = max_dt
        self.poll = poll_interval
        self.idle_timeout = idle_timeout
        self._seen_rgb: dict[float, str] = {}
        self._seen_depth: dict[float, str] = {}
        self._done_rgb: set[float] = set()
        self._done_depth: set[float] = set()
        self._sizes: dict[str, int] = {}

    def _scan(self, d: str, seen: dict, done: set) -> bool:
        new = False
        if not os.path.isdir(d):
            return False
        for f in os.listdir(d):
            path = os.path.join(d, f)
            ts = _stamp_of(f)
            if ts < 0 or ts in done or ts in seen:
                continue
            seen[ts] = path
            new = True
        return new

    def _stable(self, path: str) -> bool:
        try:
            sz = os.path.getsize(path)
        except OSError:
            return False
        prev = self._sizes.get(path)
        self._sizes[path] = sz
        return prev == sz and sz > 0

    def __iter__(self):
        last_new = time.time()
        while True:
            self._scan(self.rgb_dir, self._seen_rgb, self._done_rgb)
            self._scan(self.depth_dir, self._seen_depth, self._done_depth)
            # pair the oldest stable rgb with the closest stable depth
            emitted = False
            for rts in sorted(self._seen_rgb):
                rpath = self._seen_rgb[rts]
                if not self._stable(rpath):
                    continue
                cands = [(abs(rts - dts), dts) for dts in self._seen_depth
                         if abs(rts - dts) <= self.max_dt]
                if not cands:
                    continue
                _, dts = min(cands)
                dpath = self._seen_depth[dts]
                if not self._stable(dpath):
                    continue
                del self._seen_rgb[rts]
                del self._seen_depth[dts]
                self._done_rgb.add(rts)
                self._done_depth.add(dts)
                last_new = time.time()
                emitted = True
                yield rts, rpath, dpath
            if not emitted:
                if time.time() - last_new > self.idle_timeout:
                    return
                time.sleep(self.poll)


def stdin_stream(lines=None):
    """(stamp, rgb_path, depth_path) for each line `<rgb> <depth> [stamp]`
    of `lines` (default: standard input); blank lines and `#` comments
    are skipped, and without a stamp the rgb file's name gives it."""
    for line in sys.stdin if lines is None else lines:
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if len(parts) < 2:
            continue
        ts = float(parts[2]) if len(parts) > 2 else _stamp_of(parts[0])
        yield ts, parts[0], parts[1]


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--watch", metavar="DIR",
                     help="poll DIR/rgb + DIR/depth for new frames")
    src.add_argument("--stdin", action="store_true",
                     help="read '<rgb> <depth> [stamp]' lines from stdin")
    ap.add_argument("--out", default="/tmp/live_trajectory.txt",
                    help="pose stream (TUM format, appended per frame)")
    ap.add_argument("--cam", default="fr1", choices=["fr1", "fr2", "fr3"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
    ap.add_argument("--mod", action="store_true")
    ap.add_argument("--yolo", action="store_true",
                    help="combined MOD with the person detector "
                         "(needs --weights)")
    ap.add_argument("--weights", default="weights/person_detector.npz",
                    help="person-detector .npz checkpoint for --yolo")
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--idle-timeout", type=float, default=10.0,
                    help="--watch: end the stream after this many seconds "
                         "with no new frames")
    ap.add_argument("--render-every", type=int, default=0,
                    help="write visualization PNGs every N frames")
    ap.add_argument("--render-dir", default="/tmp/live_render")
    ap.add_argument("--save-model", default=None)
    ap.add_argument("--quiet", action="store_true")
    return ap.parse_args(argv)


def _config(args, C):
    cam = {"fr1": C.CameraIntrinsics.tum_fr1,
           "fr2": C.CameraIntrinsics.tum_fr2,
           "fr3": C.CameraIntrinsics.tum_fr3}[args.cam]()
    weights = args.weights if args.yolo and os.path.exists(args.weights) \
        else ""
    if args.yolo and not weights and not args.quiet:
        # the JAX runner's behaviour: missing weights run the simple MOD
        print(f"--yolo: weights {args.weights} not found; running the "
              "simple MOD path", file=sys.stderr, flush=True)
    cfg = C.PipelineConfig(
        cam=cam, depth_scale=args.depth_scale,
        mod=C.MODConfig(enabled=args.mod or args.yolo,
                        use_yolo=bool(weights), weights_path=weights),
        enable_loop_closure=args.loop_closure)
    if args.loop_closure:
        cfg = dataclasses.replace(cfg, ferns=C.FernsConfig(enabled=True))
    return cfg


def _render(d: str, n: int, rgb, out, slam, cfg) -> None:
    from supersurfel_fusion_tpu_torch.viz import render as rv

    labels = out.labels.cpu().numpy()
    rv.save_png(os.path.join(d, f"superpixels_{n:05d}.png"),
                rv.superpixel_image(rgb, labels))
    rv.save_png(os.path.join(d, f"slanted_{n:05d}.png"),
                rv.slanted_plane_image(out.plane_depth.cpu().numpy()))
    if cfg.mod.enabled:
        rv.save_png(os.path.join(d, f"mod_{n:05d}.png"),
                    rv.mod_mask_image(labels, out.static_sp.cpu().numpy()))
    m = slam.state.model
    s = m.surfels
    cam = cfg.cam
    rv.save_png(os.path.join(d, f"model_{n:05d}.png"), rv.model_image(
        s.positions.cpu().numpy(), s.colors.cpu().numpy(),
        s.dims.cpu().numpy(), s.confidences.cpu().numpy(),
        int(m.nb_supersurfels), out.pose.R.cpu().numpy(),
        out.pose.t.cpu().numpy(), cam.fx, cam.fy, cam.cx, cam.cy,
        cam.width, cam.height))


def main(argv=None) -> int:
    args = _args(argv)

    from supersurfel_fusion_tpu_torch import config as C
    from supersurfel_fusion_tpu_torch.device import resolve_device
    from supersurfel_fusion_tpu_torch.eval.trajectory import mat_to_quat_np
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    try:
        dev = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"run_live: {e}", file=sys.stderr)
        return 2

    cfg = _config(args, C)
    slam = SupersurfelFusion(cfg, device=dev)
    stream = (DirectoryStream(args.watch, idle_timeout=args.idle_timeout)
              if args.watch else stdin_stream())
    if args.render_every:
        os.makedirs(args.render_dir, exist_ok=True)

    n = 0
    t0 = None
    with open(args.out, "w") as traj:
        for ts, rgb_path, depth_path in stream:
            try:
                rgb, depth = _load_png_pair(rgb_path, depth_path)
            except (OSError, ValueError) as e:
                print(f"skipping unreadable frame {rgb_path}: {e}",
                      file=sys.stderr, flush=True)
                continue
            out = slam.process(rgb, depth, ts)
            # the online pose: one read of the device per frame, the price
            # of a live pose stream (the offline runner reads once)
            R = out.pose.R.cpu().numpy().astype(np.float64)
            t = out.pose.t.cpu().numpy().astype(np.float64)
            p = np.concatenate([t, mat_to_quat_np(R)])
            traj.write(f"{ts:.6f} " + " ".join(f"{v:.6f}" for v in p)
                       + "\n")
            traj.flush()
            if n == 0:
                t0 = time.time()
            n += 1
            if not args.quiet and n % 30 == 0:
                fps = (n - 1) / max(time.time() - t0, 1e-9)
                print(f"frame {n} stamp={ts:.3f} "
                      f"t=[{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}] "
                      f"({fps:.1f} fps)", flush=True)
            if args.render_every and n % args.render_every == 0:
                _render(args.render_dir, n, rgb, out, slam, cfg)

    if args.save_model and n:
        from supersurfel_fusion_tpu_torch.io.export import export_model

        st = slam.state
        export_model(args.save_model, st.model.surfels,
                     int(st.model.nb_supersurfels), cfg.conf_thresh)

    fps = (n - 1) / max(time.time() - t0, 1e-9) if n > 1 else 0.0
    print(json.dumps({"frames": n, "fps": round(fps, 2),
                      "trajectory": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

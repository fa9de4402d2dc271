"""Replay a TUM sequence into a watch directory as a live stream.

Port of the repository's `tools/stream_feeder.py` (the producer half of
the live runner's demo, "the camera driver"): copies the rgb/depth PNGs
into `target/rgb` and `target/depth` at a fixed rate, each by an atomic
rename, so the consumer (`apps/run_live.py --watch`) never sees a partial
file. It reads the sequence through the port's `io/tum.py`.

  python -m supersurfel_fusion_tpu_torch.tools.stream_feeder \\
      --dataset .../rgbd_dataset_freiburg1_xyz --target /tmp/live \\
      --fps 30 --max-frames 200
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

from supersurfel_fusion_tpu_torch.io.tum import TUMDataset


def feed(dataset: str, target: str, fps: float = 30.0, max_frames: int = 0,
         on_frame=None) -> int:
    """Copy the sequence's frames into `target` at `fps`; returns the
    number fed. `on_frame(i, stamp, t)`, if given, is called after frame
    i's pair is in place (t: `time.time()` then)."""
    rgb_dir = os.path.join(target, "rgb")
    depth_dir = os.path.join(target, "depth")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)

    ds = TUMDataset(dataset)
    n = len(ds) if not max_frames else min(max_frames, len(ds))
    dt = 1.0 / max(fps, 1e-6)

    def emit(src: str, dst_dir: str, stamp: float) -> None:
        dst = os.path.join(dst_dir, f"{stamp:.6f}.png")
        tmp = dst + ".tmp"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)  # atomic: the consumer never sees partial data

    t0 = time.time()
    for i in range(n):
        a = ds.associations[i]
        emit(os.path.join(ds.root, a.rgb_file), rgb_dir, a.rgb_ts)
        emit(os.path.join(ds.root, a.depth_file), depth_dir, a.depth_ts)
        if on_frame is not None:
            on_frame(i, a.rgb_ts, time.time())
        lag = t0 + (i + 1) * dt - time.time()
        if lag > 0:
            time.sleep(lag)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args(argv)
    n = feed(args.dataset, args.target, args.fps, args.max_frames)
    print(f"fed {n} frames at <= {args.fps} fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())

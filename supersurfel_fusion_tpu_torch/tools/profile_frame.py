"""Where the time of the default frame step goes, on one CUDA card.

    python -m supersurfel_fusion_tpu_torch.tools.profile_frame \\
        [--frames 6] [--warmup 4] [--trace PATH.json]

Drives the default `PipelineConfig` through `SupersurfelFusion` on the
synthetic clip, then prints:

* the card's name and power limit (nvidia-smi);
* the kernel launches per frame;
* ms/frame on the host clock, each frame ended by a device sync, without a
  profiler attached;
* under `torch.profiler` over `--frames` frames: for each pipeline stage
  (the "ssf.<stage>" ranges of `pipeline.process_frame`) its host time and
  the device time of the kernels the profiler links to it; the device time
  it links to no stage; the kernels with the most device time; the TPS
  kernels' device time and launches; and the device's busy share of the
  window (kernel time over wall time; the idle share is the rest).

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion


def _device_us(evt, self_only: bool) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    legacy = "self_cuda_time_total" if self_only else "cuda_time_total"
    return float(getattr(evt, name, getattr(evt, legacy, 0.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    cfg = PipelineConfig()
    n = args.warmup + 2 * args.frames
    clip = synthetic.frames(cfg.cam, n)
    slam = SupersurfelFusion(cfg, device="cuda")
    it = iter(enumerate(clip))

    def step():
        k, (rgb, depth, _) = next(it)
        slam.process(rgb, depth, timestamp=float(k))

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()

    host_ms = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"ms/frame (host clock, synced, no profiler): mean "
          f"{np.mean(host_ms):.2f} median {np.median(host_ms):.2f} "
          f"min {np.min(host_ms):.2f} over {args.frames} frames", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)

    ka = prof.key_averages()
    # each "ssf.*" range appears twice: as the host range (its device time
    # is that of the kernels it launched) and as a device-side annotation
    # span, which is not a kernel and is left out below
    stages = [e for e in ka if e.key.startswith("ssf.")
              and e.device_type == DeviceType.CPU]
    per = args.frames
    print(f"profiled window: {wall_us / per / 1e3:.2f} ms/frame wall")
    # "self": kernels linked to the range itself rather than to an op
    # inside it
    print(f"{'stage':<18}{'host ms/frame':>15}{'device ms/frame':>17}"
          f"{'self':>8}")
    for e in sorted(stages, key=lambda e: -e.cpu_time_total):
        print(f"{e.key:<18}{e.cpu_time_total / per / 1e3:>15.3f}"
              f"{_device_us(e, False) / per / 1e3:>17.3f}"
              f"{_device_us(e, True) / per / 1e3:>8.3f}")
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ssf.")]
    busy_us = sum(_device_us(e, True) for e in kernels)
    print(f"device busy {busy_us / per / 1e3:.3f} ms/frame = "
          f"{100 * busy_us / wall_us:.1f}% of the wall time "
          f"(idle {100 - 100 * busy_us / wall_us:.1f}%)")
    # kernels the profiler links to no stage: those launched between the
    # stages, and those launched outside PyTorch (the ctypes-bound TPS
    # kernels, if the profiler cannot link them to the enclosing range)
    staged_us = sum(_device_us(e, False) for e in stages)
    print(f"device time in no stage's column: "
          f"{(busy_us - staged_us) / per / 1e3:.3f} ms/frame")
    print("top kernels by device time (ms/frame, launches/frame):")
    for e in sorted(kernels, key=lambda e: -_device_us(e, True))[:15]:
        print(f"  {_device_us(e, True) / per / 1e3:9.3f} "
              f"{e.count / per:7.1f}  {e.key[:90]}")
    # the port's own kernels (csrc/tps.cu), whatever their rank
    tps = [e for e in kernels if "tps_" in e.key]
    print("TPS kernels (ms/frame, launches/frame):")
    for e in tps:
        print(f"  {_device_us(e, True) / per / 1e3:9.3f} "
              f"{e.count / per:7.1f}  {e.key[:90]}")
    n_launch = sum(e.count for e in kernels) / per
    print(json.dumps({"ms_per_frame_synced": float(np.mean(host_ms)),
                      "device_busy_ms_per_frame": busy_us / per / 1e3,
                      "device_busy_share": busy_us / wall_us,
                      "kernel_launches_per_frame": n_launch,
                      "device_ms_per_frame_in_no_stage":
                          (busy_us - staged_us) / per / 1e3,
                      "tps_kernels_ms_per_frame":
                          sum(_device_us(e, True) for e in tps) / per / 1e3}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

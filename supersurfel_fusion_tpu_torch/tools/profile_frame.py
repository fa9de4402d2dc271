"""Where the time of the frame step goes, on one CUDA card.

    python -m supersurfel_fusion_tpu_torch.tools.profile_frame \\
        [--mod | --lc | --train] [--frames 6] [--warmup 4] \\
        [--trace PATH.json]

Drives the default `PipelineConfig` through `SupersurfelFusion` on the
synthetic clip; with `--mod`, bench's fr3 MOD configuration (fr3
camera, moving-object detection with the person detector's committed
weights) on the synthetic dynamic clip; with `--lc`, the default
configuration with ferns and loop closure on (`lc_config`) on the revisit
clip, whose frames 0-16 hold no closure (the closure frame is timed by
`chip_smoke.py`); with `--train`, steps of the person detector's trainer
(`tools/train_person_detector.py`) on the committed labels
(`artifacts/mod_boxes_train.npz`, batch 8, the first epoch's batches;
its ranges are "ssf.train_*"), each step counted as a frame below, and
also timed as the trainer times it (CUDA events between unsynced steps).
Then it prints:

* the card's name and power limit (nvidia-smi);
* the kernel launches per frame;
* ms/frame on the host clock, each frame ended by a device sync, without a
  profiler attached;
* under `torch.profiler` over `--frames` frames: for each pipeline stage
  (the "ssf.<stage>" ranges of `pipeline.process_frame`) its host time and
  the device time of the kernels the profiler links to it; the device time
  it links to no stage; the kernels with the most device time; the TPS
  kernels' device time and launches; and the device's busy share of the
  window (kernel time over wall time; the idle share is the rest);
* kernel launches per frame for each stage (the CUDA launch calls the
  host makes inside the stage's range);
* over one more frame, the operations that made the host wait for the
  device (`torch.cuda.set_sync_debug_mode`).

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import subprocess
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.config import (
    CameraIntrinsics,
    FernsConfig,
    MODConfig,
    PipelineConfig,
)
from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion


def _device_us(evt, self_only: bool) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    legacy = "self_cuda_time_total" if self_only else "cuda_time_total"
    return float(getattr(evt, name, getattr(evt, legacy, 0.0)))


# names of the host-side CUDA API calls that launch a kernel
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                 "cudaLaunchCooperativeKernel")


def stage_launches(events, per: int):
    """(launches per frame inside each "ssf.*" range, all launches per
    frame): the CUDA launch calls the host made during a range, on the
    range's thread. Kernels launched outside PyTorch (the ctypes-bound
    TPS kernels) count too."""
    ranges = [(e.time_range.start, e.time_range.end, e.thread, e.name)
              for e in events if e.name.startswith("ssf.")
              and e.device_type == DeviceType.CPU]
    launches = sorted((e.time_range.start, e.thread) for e in events
                      if any(c in e.name for c in _LAUNCH_CALLS))
    starts = [t for t, _ in launches]
    out: dict = {}
    for t0, t1, thread, name in ranges:
        i = bisect.bisect_left(starts, t0)
        j = bisect.bisect_right(starts, t1)
        n = sum(1 for _, th in launches[i:j] if th == thread)
        out[name] = out.get(name, 0) + n
    return {k: v / per for k, v in out.items()}, len(launches) / per


def kernel_runs(prof, names) -> dict:
    """Runs on the card of the kernels whose names hold each of `names`,
    in a finished `torch.profiler.profile`: every kernel the CUDA trace
    holds, those a CUDA graph's replay runs included. Read from the raw
    trace events (a trace of many frames makes the profiler's own tables
    slow to build)."""
    runs = dict.fromkeys(names, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            for k in names:
                runs[k] += k in name
    return runs


def host_syncs(step) -> list:
    """Run step() once with CUDA sync debugging on; the port's source
    lines (innermost frame in the package) of the operations that made
    the host wait for the device, with counts."""
    pkg = str(Path(__file__).resolve().parents[1])
    where: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)
                and not f.filename.endswith("profile_frame.py")]
        key = (f"{Path(ours[-1].filename).name}:{ours[-1].lineno}" if ours
               else f"{Path(filename).name}:{lineno}")
        where[key] = where.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted(where.items(), key=lambda kv: -kv[1])


def mod_config() -> PipelineConfig:
    """bench.py's fr3 configuration: the fr3 camera and moving-object
    detection with the person detector's committed weights."""
    weights = Path(__file__).resolve().parents[2] / "weights" \
        / "person_detector.npz"
    return PipelineConfig(cam=CameraIntrinsics.tum_fr3(),
                          mod=MODConfig(enabled=True, use_yolo=True,
                                        weights_path=str(weights)))


def lc_config(min_frame_gap: int = 8) -> PipelineConfig:
    """The default configuration with ferns and loop closure on (500
    ferns, 512 keyframes), and the revisit test's `min_frame_gap`."""
    return PipelineConfig(enable_loop_closure=True,
                          ferns=FernsConfig(enabled=True,
                                            min_frame_gap=min_frame_gap))


def train_step():
    """step() running one training step of the person detector on the
    card: the committed labels, batch 8, the first epoch's batches in the
    trainer's order (repeated), from `init_params()`."""
    from supersurfel_fusion_tpu_torch.models.person_detector import (
        init_params,
    )
    from supersurfel_fusion_tpu_torch.tools import train_person_detector as tt

    data = Path(__file__).resolve().parents[2] / "artifacts" \
        / "mod_boxes_train.npz"
    g, d, b, c, _ = tt.load_labels(str(data))
    labels = tt.prepare(g, d, b, c, "cuda")
    trainer = tt.Trainer(init_params(), tt.schedule_steps(len(c), 8, 30),
                         3e-4, "cuda")
    order, plan = next(tt.epochs_plan(c, 8, 1, False))
    order = torch.from_numpy(order).cuda()
    it = itertools.cycle(plan)

    def step():
        k, flip = next(it)
        trainer.step(*labels.batch(order[k:k + 8], flip))

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--mod", action="store_true",
                      help="the fr3 MOD configuration on the dynamic clip")
    mode.add_argument("--lc", action="store_true",
                      help="ferns and loop closure on, on the revisit clip")
    mode.add_argument("--train", action="store_true",
                      help="the person detector's training steps")
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

    n = args.warmup + 2 * args.frames + 1
    if args.train:
        name, step = "detector training, batch 8", train_step()
    elif args.mod:
        name, cfg = "fr3 MOD, dynamic clip", mod_config()
        clip = synthetic.dynamic_frames(cfg.cam, n)
    elif args.lc:
        name, cfg = "loop closure, revisit clip", lc_config()
        clip = synthetic.revisit_frames(cfg.cam)[:n]
        if n > synthetic.REVISIT_OUT + 1:
            raise SystemExit(f"--lc profiles frames 0-{synthetic.REVISIT_OUT}"
                             f" (before the revisit); asked for {n}")
    else:
        name, cfg = "default", PipelineConfig()
        clip = synthetic.frames(cfg.cam, n)
    print(f"config: {name}", flush=True)
    if not args.train:
        slam = SupersurfelFusion(cfg, device="cuda")
        it = iter(enumerate(clip))

        def step():
            k, frame = next(it)
            slam.process(frame[0], frame[1], timestamp=float(k))

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
    event_ms = []
    if args.train:
        # the trainer's own timing: CUDA events between unsynced steps
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(args.frames + 1)]
        events[0].record()
        for e in events[1:]:
            step()
            e.record()
        torch.cuda.synchronize()
        event_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        print(f"ms/step between CUDA events, unsynced: median "
              f"{np.median(event_ms):.2f} p90 "
              f"{np.percentile(event_ms, 90):.2f}", flush=True)

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
    by_stage, n_calls = stage_launches(prof.events(), per)
    print(f"kernel launch calls per frame: {n_calls:.1f}; by stage:")
    for name, v in sorted(by_stage.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<18}{v:9.1f}")

    syncs = host_syncs(step)
    print(f"host waits on the device over one frame: "
          f"{sum(c for _, c in syncs)}")
    for where, count in syncs:
        print(f"  {count:5d}  {where}")

    mod = next((e for e in stages if e.key == "ssf.mod"), None)
    summary = {"config": ("fr3_mod" if args.mod
                          else "loop_closure" if args.lc
                          else "train" if args.train else "default"),
               "ms_per_frame_synced": float(np.mean(host_ms)),
               "ms_per_step_events_unsynced":
                   float(np.median(event_ms)) if event_ms else None,
               "device_busy_ms_per_frame": busy_us / per / 1e3,
               "device_busy_share": busy_us / wall_us,
               "kernel_launches_per_frame": n_launch,
               "launch_calls_per_frame": n_calls,
               "launch_calls_per_frame_by_stage": by_stage,
               "device_ms_per_frame_in_no_stage":
                   (busy_us - staged_us) / per / 1e3,
               "tps_kernels_ms_per_frame":
                   sum(_device_us(e, True) for e in tps) / per / 1e3,
               "host_syncs_per_frame": sum(c for _, c in syncs)}
    for key in ("ssf.ferns", "ssf.loop_closure"):
        e = next((e for e in stages if e.key == key), None)
        if e is not None:
            summary[f"{key[4:]}_launches_per_frame"] = by_stage.get(key, 0.0)
            summary[f"{key[4:]}_device_ms_per_frame"] = \
                _device_us(e, False) / per / 1e3
    if args.lc:
        summary["keyframe_store_mib"] = \
            slam.state.kf_store.nbytes() / 2**20
    if mod is not None:
        summary.update(mod_host_ms_per_frame=mod.cpu_time_total / per / 1e3,
                       mod_device_ms_per_frame=_device_us(mod, False)
                       / per / 1e3,
                       mod_launches_per_frame=by_stage.get("ssf.mod", 0.0))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Readings that the limits of `checks/<cell>.json` are set from.

    python -m slam_bench.calibrate --workload <cell> --seeds 1 2 3 \\
        [--frames 48] [--control] [--syncs] [--fault NAME] [--out FILE]

For each seed, in one process: the cell's set-up and a short window of
`--frames` frames at the cell's own load, the frames drawn for the check
as a run draws them (the blind sample and the event sample, `run.draw`),
then every number of `check.numbers` and of the cell's reference package
(worst and median over the frames) for the program against the
reference and, with `--control`, for the control (the reference with
TF32 on) against the reference, on the same frames. With `--syncs`, 4
more steps run under `torch.cuda.set_sync_debug_mode` and 4 under the
profiler, to hold `host_waits_per_frame` against the sync-debug count.
With `--fault`, the program runs with that fault of `faults.py` or
`fault_plants/` planted (the reference runs unchanged), and the line
says whether the cell's checks catch it; a fault whose NEEDS the cell's
configuration does not turn on is refused. One JSON line per
seed goes to standard output (and to `--out`). It needs a CUDA card; the
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from pathlib import Path

import numpy as np


def sync_count(step) -> int:
    """Host waits of one call of step(), counted by CUDA sync debugging
    (as `tools/profile_frame.py:host_syncs` counts them)."""
    import torch

    n = 0

    def record(message, *a, **k):
        nonlocal n
        if "synchroniz" in str(message):
            n += 1

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
    return n


def main(argv=None, *, root=None, data=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--syncs", action="store_true")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from contextlib import nullcontext

    from slam_bench import check, faults, manifest, run
    from slam_bench.scene import frame_index
    from slam_bench.trace import STEP, is_sync

    root = Path(root or os.getcwd()).resolve()
    run._cache_dirs(root)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            run.log("calibrate needs a CUDA card")
            return 2
        device = "cuda"
        run.log(f"card: {run.card_line()}")
    bench = manifest.Bench(root, data)
    cell = bench.cell(args.workload)
    checks = bench.checks(cell["name"])
    if args.fault:
        from supersurfel_fusion_tpu_torch.config import PipelineConfig

        missing = faults.unmet(args.fault, manifest.build_config(
            PipelineConfig, bench.config(cell["config"]), root), bench.data)
        if missing:
            run.log(f"fault {args.fault} needs {missing} on, which "
                    f"{cell['config']} does not turn on")
            return 2
    ref = None
    for seed in args.seeds:
        t0 = time.perf_counter()
        fault = faults.planted(args.fault, bench.data) if args.fault \
            else nullcontext()
        with fault:
            sf, frames, mix, cfg, first = run.setup(bench, cell, seed,
                                                    device)
            sampler = run.Sampler(seed, int(checks["every"]),
                                  int(checks["keep"]))
            events = run.Events.of(checks, seed)
            start = int(mix["warmup_frames"])
            rgb, depth = frames
            lat = []
            for j in range(args.frames):
                i = start + j
                pre = sf.state if sampler.wants(j) or events is not None \
                    else None
                t1 = time.perf_counter()
                out, _ = run.play(sf, rgb, depth, i)
                lat.append(time.perf_counter() - t1)
                run.draw(sampler, events, j, (frame_index(i, len(rgb)), pre,
                                              out, sf.state))
                del pre
        samples = run.samples(first, sampler, events)
        line = {"workload": cell["name"], "seed": seed,
                "frames": args.frames, "samples": len(samples),
                "drawn": [s[0] for s in samples],
                "frame_ms_median": 1e3 * float(np.median(lat))}
        if events is not None:
            line["event_frames"] = events.window
            line["event_frames_compared"] = len(events.kept)
        if args.syncs and device != "cpu":
            # the step alone, without the harness's pose read: by sync
            # debugging on 4 frames, then by the profiler on the next 4
            i = start + args.frames
            counts = []
            for f in range(4):
                k = frame_index(i + f, len(rgb))
                counts.append(sync_count(
                    lambda: sf.process(rgb[k], depth[k])))
            tr, _, _ = run.traced(sf, frames, i + 4, 4)
            names: dict = {}
            for n, s, _, th in tr.calls:
                if is_sync(n):
                    names[n] = names.get(n, 0) + 1
            line["host_waits_sync_debug"] = counts
            line["host_waits_profiler"] = tr.calls_in(STEP, is_sync) / 4
            line["sync_calls_in_stretch"] = names
        del sf
        if ref is None:
            ref = check.Reference(bench.config(cell["config"]), root, device)
        t2 = time.perf_counter()
        line["program"] = check.compare(samples, ref, frames)
        line["reference_s"] = time.perf_counter() - t2
        if args.fault:
            line["fault"] = args.fault
            line["caught"] = not check.verdict(line["program"],
                                               checks["numbers"])[0] \
                or (events is not None and not events.kept)
        if args.control:
            line["control"] = check.control(samples, ref, frames)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del samples, first, sampler, events
    return 0


if __name__ == "__main__":
    sys.exit(main())

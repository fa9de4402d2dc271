"""What the port's span recorder (`tracing.py`) costs the frame step, on
one CUDA card.

    python -m supersurfel_fusion_tpu_torch.tools.span_cost [--mod] \\
        [--pairs 6] [--seconds 10]

Drives bench's fr1 configuration (the default `PipelineConfig`) on the
synthetic clip or, with `--mod`, the fr3 MOD configuration on the dynamic
clip, one frame at a time, each pose read to the host before the next
frame is handed in (as the benchmark does). Two measurements:

* per span: 200 000 empty spans in frames of 50, recorder on and off,
  against an empty loop; and as many stages (`tracing.stage`, the
  recorder's span around the profiler range) against the bare
  `record_function("ssf.<stage>")` the stages opened before the recorder;
  us per call, the frame span's share included;
* per frame: `--pairs` pairs of `--seconds` windows with the recorder on
  and off (`tracing.enable`), the order alternating within each pair,
  ms per frame of each window, and the spans of a recorded frame.

Prints the card's name and power limit, then one JSON line. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import record_function

from supersurfel_fusion_tpu_torch import synthetic, tracing
from supersurfel_fusion_tpu_torch.config import PipelineConfig
from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion
from supersurfel_fusion_tpu_torch.tools.profile_frame import mod_config

N_SPANS = 200_000
PER_FRAME = 50      # about the spans of one frame step


def _per_call_us(body) -> float:
    """us per call of `body`'s loop of PER_FRAME calls, each loop inside
    a frame of the recorder, over N_SPANS calls."""
    t = time.perf_counter()
    for _ in range(N_SPANS // PER_FRAME):
        with tracing.frame():
            body(PER_FRAME)
    return 1e6 * (time.perf_counter() - t) / N_SPANS


def _empty(n):
    for _ in range(n):
        pass


def _spans(n):
    span = tracing.span
    for _ in range(n):
        with span("x"):
            pass


def _stages(n):
    stage = tracing.stage
    for _ in range(n):
        with stage("x"):
            pass


def _ranges(n):
    for _ in range(n):
        with record_function("ssf.x"):
            pass


def span_us() -> dict:
    """us per call of an empty span and stage, recorder on and off, in
    frames of PER_FRAME calls (the frame's own span included), against
    the empty loop and the bare profiler range."""
    out = {}
    for on in (True, False):
        tracing.enable(on)
        for name, body in (("empty_loop", _empty), ("span", _spans),
                           ("stage", _stages), ("record_function", _ranges)):
            out[f"{name}_{'on' if on else 'off'}"] = _per_call_us(body)
    tracing.enable(True)
    return out


def window(sf, clip, seconds: float) -> list:
    """Frames back to back for `seconds`; ms of each, pose on the host."""
    ms = []
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        rgb, depth = clip[i % len(clip)][:2]
        t = time.perf_counter()
        out = sf.process(rgb, depth)
        torch.cat([out.pose.R.reshape(9), out.pose.t]).cpu()
        ms.append(1e3 * (time.perf_counter() - t))
        i += 1
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mod", action="store_true")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_cost needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    cfg = mod_config() if args.mod else PipelineConfig()
    clip = (synthetic.dynamic_frames(cfg.cam, args.frames) if args.mod
            else synthetic.frames(cfg.cam, args.frames))
    # forward and back, so the motion has no jump
    clip = clip + clip[-2:0:-1]
    sf = SupersurfelFusion(cfg, device="cuda")
    for rgb, depth, *_ in clip[:8]:
        sf.process(rgb, depth)
    torch.cuda.synchronize()

    micro = span_us()
    first = tracing.RECORDER.count
    window(sf, clip, 2.0)
    spans = [len(f.spans) for f in tracing.frames(first)]
    on, off = [], []
    for p in range(args.pairs):
        for rec in ((True, False) if p % 2 == 0 else (False, True)):
            tracing.enable(rec)
            ms = window(sf, clip, args.seconds)
            (on if rec else off).append(float(np.mean(ms)))
    tracing.enable(True)
    diff = [a - b for a, b in zip(on, off)]
    res = {"config": "fr3_walking" if args.mod else "fr1_xyz",
           "card": smi, "spans_per_frame": statistics.median(spans),
           "us_per_call": micro,
           "frame_ms_on": on, "frame_ms_off": off,
           "on_minus_off_ms_median": statistics.median(diff)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

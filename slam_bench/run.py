"""The port's benchmark: one cell of BENCHMARK.json on one card.

    python -m slam_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up renders the cell's traffic from the seed on the card (the synthetic
room under a hand-held sway, with a sliding box in the walker mix), builds
`supersurfel_fusion_tpu_torch.pipeline.SupersurfelFusion` for the cell's
configuration and plays warm-up frames through it. The window then hands
frames to `SupersurfelFusion.process` one at a time, as host numpy arrays
(uint8 RGB, uint16 TUM depth), and reads each frame's pose to the host
before the next: a closed loop, as an offline replay or the reference's
benchmark node runs it. The K rendered poses play forward and back.

With `--trace 0` the last line of standard output carries the cell's
end-to-end metrics; with `--trace 1` a stretch of frames after the window
runs under `torch.profiler`, and the line carries the per-layer metrics,
the device's busy time and a breakdown. Every metric is read by its own
module under `metrics/`. After the window the reference (`check.py`)
follows sampled frames and decides `correct`; each number compared is
printed beside its limit, last on standard error and last in the line.

There is no CPU fallback: without a CUDA card the command exits 2 and
prints no result.
"""

import time

_T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

# modules that must not be loaded in the process that prints a result
# (compared by whole top-level name: the port's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "supersurfel_fusion_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches in fixed directories inside the checkout,
    whatever the environment says, so that only a checkout's first run
    builds and the two sides of a comparison share nothing."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def card_line() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Sampler:
    """Frames drawn for the check: one at a seeded offset in each block of
    `every` window frames, `keep` of them kept by reservoir sampling, so
    the sample is spread over the whole window however long it runs."""

    def __init__(self, seed: int, every: int, keep: int):
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                          int(seed) >> 32, 0x5EED])
        self.every, self.keep = every, keep
        self.offset = int(self.rng.integers(0, every))
        self.seen = 0
        self.kept: list = []

    def wants(self, i: int) -> bool:
        return i % self.every == self.offset

    def add(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.keep:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.keep:
                self.kept[j] = item

    def next_block(self, i: int) -> None:
        if i % self.every == self.every - 1:
            self.offset = int(self.rng.integers(0, self.every))


class Ctx:
    """What a metric's reader sees of a run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stages(self, layer: str) -> list[str]:
        """The `ssf.<stage>` names a layer owns (`layers/<layer>.json`)."""
        return self.bench.layer(layer)["stages"]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup(bench, cell: dict, seed: int, device: str):
    """Render the traffic, build the program and play the warm-up frames.
    Returns (program runner, frames, mix, program config, first-frame
    record for the check)."""
    import torch

    from slam_bench import manifest, scene
    from supersurfel_fusion_tpu_torch.config import PipelineConfig
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    cfg_doc = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    cfg = manifest.build_config(PipelineConfig, cfg_doc, bench.root)
    cam = cfg_doc["pipeline"]["cam"]
    rgb, depth, _ = scene.render_stream(cam, mix, seed, device)
    if device != "cpu":
        torch.cuda.synchronize()
    sf = SupersurfelFusion(cfg, device=device)
    first = None
    for i in range(int(mix["warmup_frames"])):
        pre = sf.state
        out, _ = play(sf, rgb, depth, i)
        if i == 0:
            first = (scene.frame_index(0, len(rgb)), None, out, sf.state)
        del pre
    if device != "cpu":
        torch.cuda.synchronize()
    return sf, (rgb, depth), mix, cfg, first


def play(sf, rgb, depth, i: int):
    """Frame i of the stream through the program, its pose read to the
    host. Returns (outputs, pose row (12,) float32)."""
    import torch
    from torch.profiler import record_function

    from slam_bench.scene import frame_index

    k = frame_index(i, len(rgb))
    with record_function("bench.step"):
        out = sf.process(rgb[k], depth[k])
    with record_function("bench.pose"):
        pose = torch.cat([out.pose.R.reshape(9), out.pose.t]).cpu().numpy()
    return out, pose


def window(sf, frames, start: int, seconds: float, sampler: Sampler):
    """Frames back to back for `seconds`; returns (latencies s, window s,
    next frame index, frames with a non-finite pose)."""
    from slam_bench.scene import frame_index

    rgb, depth = frames
    lat, bad = [], 0
    i = start
    t_start = time.perf_counter()
    while True:
        j = i - start
        pre = sf.state if sampler.wants(j) else None
        t0 = time.perf_counter()
        out, pose = play(sf, rgb, depth, i)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        bad += not np.all(np.isfinite(pose))
        if pre is not None:
            sampler.add((frame_index(i, len(rgb)), pre, out, sf.state))
        sampler.next_block(j)
        i += 1
        if t1 - t_start >= seconds:
            break
    return lat, t1 - t_start, i, bad


def traced(sf, frames, start: int, n: int):
    """n frames under torch.profiler; returns (Trace, labels of each
    frame, frames with a non-finite pose)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from slam_bench.trace import Trace

    rgb, depth = frames
    labels, bad = [], 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.stretch"):
            for i in range(start, start + n):
                out, pose = play(sf, rgb, depth, i)
                labels.append(out.labels)
                bad += not np.all(np.isfinite(pose))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    tr = Trace.from_profiler(prof, n)
    return tr, [x.cpu().numpy() for x in labels], bad


def main(argv=None, *, root=None, data=None, device=None) -> int:
    """Run one cell. `root` holds BENCHMARK.json (default: the working
    directory), `data` the benchmark's folder (default: this package's).
    `device` is for the tests alone: given, the look for a card is skipped
    and the run goes to that device."""
    args = parse(argv)
    root = Path(root or os.getcwd()).resolve()
    _cache_dirs(root)
    from slam_bench import manifest

    bench = manifest.Bench(root, data)
    cell = bench.cell(args.workload)
    checks = bench.checks(cell["name"])
    import torch

    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            log(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
            return 2
        device = "cuda"
        card = torch.cuda.get_device_name(0)
        log(f"card: {card_line()}")
    else:
        card = f"{device} (test run)"
    cuda = device != "cpu"

    sf, frames, mix, cfg, first = setup(bench, cell, args.seed, device)
    gc.collect()
    setup_s = time.perf_counter() - _T0
    log(f"set-up {setup_s:.3f} s ({len(frames[0])} poses, "
        f"{mix['warmup_frames']} warm-up frames)")

    sampler = Sampler(args.seed, int(checks["every"]), int(checks["keep"]))
    start = int(mix["warmup_frames"])
    lat, win_s, nxt, bad = window(sf, frames, start, args.seconds, sampler)
    q = np.percentile(1e3 * np.asarray(lat), [0, 10, 50, 90, 100])
    log(f"window {win_s:.3f} s, {len(lat)} frames, "
        f"{1e3 * win_s / len(lat):.3f} ms/frame; frame ms min/p10/median/"
        f"p90/max {' '.join(f'{x:.1f}' for x in q)}")
    log("frame ms: " + " ".join(f"{1e3 * x:.1f}" for x in lat))
    trace, labels = None, []
    if args.trace:
        trace, labels, bad_t = traced(sf, frames, nxt,
                                      int(mix["trace_frames"]))
        bad += bad_t
        log(f"traced {trace.frames} frames in {trace.window_s:.3f} s, "
            f"{len(trace.ops)} device operations "
            f"({trace.unlinked_ops} not linked to a call)")
    peak = torch.cuda.max_memory_allocated(0) if cuda else 0
    found = forbidden_modules()

    # the reference, once the program's live state is freed
    del sf
    gc.collect()
    from slam_bench import check

    ok, shown = False, {}
    try:
        ref = check.Reference(bench.config(cell["config"]), root, device)
        worst = check.compare([first] + sampler.kept, ref, frames)
        log(f"readings over {len(sampler.kept) + 1} frames: "
            f"{json.dumps(worst)}")
        ok, shown = check.verdict(worst, checks["numbers"])
    except Exception as e:  # the check's failure is a wrong answer
        log(f"the comparison with the reference failed: "
            f"{type(e).__name__}: {e}")
    ok = ok and bad == 0

    ctx = Ctx(bench=bench, cell=cell, cfg=cfg, card=card, setup_s=setup_s,
              latencies_s=lat, window_s=win_s, trace=trace, labels=labels)
    metrics = {}
    for m in bench.metrics_for(cell["name"], bool(args.trace)):
        v = bench.reader(m["name"])(ctx, m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device, "kind": card,
           "count": int(cell["chips"]) if cuda else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": len(lat) + (
        trace.frames if trace else 0), "failed": int(bad),
        "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = shown

    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        log(f"modules that must not be loaded are: {found}")
        return 3
    for name, v in shown.items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

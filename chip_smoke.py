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
   (`tps_iteration`, `tps_merge`) against its plain PyTorch version on the
   same inputs, and the kernel-backed TPS segmentation against the plain
   one, and times kernel, plain version, bound and library yardstick;
4. pipeline phase: drives the default `PipelineConfig` frame step through
   `SupersurfelFusion` on a synthetic clip with a known trajectory (its
   stages CUDA graphs from the second frame on), counts the TPS launchers'
   calls and the kernels' runs in a CUDA trace of the last frame, checks
   tracking, and holds the first frames against the plain CPU path;
5. detector phase: the person detector (committed weights) on the card
   against the plain CPU path on one rendered 640x480 frame;
6. motion phase: `detect_motion` on the card against the CPU on two
   consecutive frames of the dynamic clip, the same front end fed to both;
7. MOD pipeline phase: bench's fr3 MOD configuration over the 30-frame
   dynamic clip (a box sliding 2 cm per frame) through `SupersurfelFusion`:
   kernel launches, ms/frame, memory, tracking, mover recall and the
   false-dynamic share against the rendered mover mask, and the first
   frames against the plain CPU path;
8. loop-closure phase: the default configuration with ferns and loop
   closure on (500 ferns, 512 keyframes, 256 graph nodes, min_frame_gap
   8) over the 33-frame revisit clip through `SupersurfelFusion`:
   keyframes, the accepted closure, tracking and drift against limits set
   from CPU runs; ms/frame of ordinary and closure frames, the device time
   of `close_global_loop` and `optimise`, launches per frame and per
   fern/loop-closure stage, host waits, memory; then the closure frame on
   the plain CPU path from the card's state, and `optimise` on the CPU
   from the card's inputs;
9. runner phase: builds the port's native frame loader
   (`csrc/tum_loader.cpp`, g++, pthread only) and fails if it does not
   build; times decoding a (rgb, depth) 640x480 pair with it and with
   PIL on the same files (frames equal); then a TUM-format directory of
   synthetic frames through `apps.run_benchmark.main` on the card, with
   and without `--loop-closure`: the JSON line (which must say
   `"loader": "native"`), the fps with the prefetcher, the trajectory
   file, the ATE;
10. live phase: the port's feeder (a subprocess) writes the 30-frame
   static clip into a watch directory at 30 fps while `apps.run_live
   --watch` runs on the card: every frame once and in stamp order, the
   poses against the offline runner's on the same frames, fps, the
   latency from a frame's file to its pose line, the largest backlog;
   then a few frames through `--stdin`;
11. sharded phases: the sharded frame step (`parallel/`) on the
   loop-closure phase's clip and limits, then a few frames of the fr3
   MOD configuration, on 1 rank over NCCL and on 2 ranks sharing the
   card over gloo, each rank a spawned process: the ranks' bit-for-bit
   agreement on every frame, the closure, the poses against the
   single-device phase, ms per frame, collectives and bytes per frame,
   host waits, peak memory per rank;
12. options phase: the three default-off options through
   `SupersurfelFusion` on the card against the plain CPU path, 3 frames
   each: `fusion.freeze_on_tracking_loss` and `fusion.insert_requires_icp`
   on the static clip whose third frame has inverted colours, so that ICP
   is gate-rejected there (the model kept, nothing inserted), and
   `mod.temporal_heat` on the fr3 MOD configuration's dynamic clip;
13. nb_samples phase: the default configuration with a 32-hypothesis
   RANSAC plane table (`TPSConfig(nb_samples=32)`, drawn as JAX draws
   it) through `SupersurfelFusion`, 3 frames on the card against the
   plain CPU path: both TPS kernels launched, poses within 2 mm;
14. collect phase: the dynamic clip written as a TUM sequence through the
   trainer's `--collect` on the card: the label file's layout, the TPS
   launches, and the boxes against the mover's known image rectangle;
15. training phase: the person detector's trainer
   (`tools/train_person_detector.py`) at full width on the committed
   labels: the first steps on the card against the plain CPU path from
   `init_params()` (JAX's initial weights), then the committed weights' own command (716 frames
   at 640x480, batch 8, 30 epochs): ms per step, steps and frames per
   second, wall time, peak memory, the loss of every epoch against a band
   set from CPU runs, held-out recall and precision beside the committed
   weights'; then the detector phase again with the card-trained weights;
16. prints the kernel table as one JSON line (launcher calls summed over
   every pipeline phase and every rank; a graph's replay runs the kernels
   without them) and, last,
   {"ok": true, "device": {...}}.

Any failed check raises, and the script then exits non-zero without the
last line. It also exits non-zero when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

# Total wall-time budget of the run, cold build included (seconds).
BUDGET_S = 1000.0
N_FRAMES = 30         # pipeline phase frames
N_CPU_FRAMES = 3      # frames also run on the plain CPU path
# detect_motion, card vs CPU on the same inputs: float scatter-adds are
# atomic on the card and sequential on the CPU, so a superpixel's cluster
# statistics may round differently; at most 1% of decisions may differ
MOTION_SP_AGREE = 0.99
MOTION_KP_AGREE = 0.99
# the MOD pipeline phase's limits, set from free-running CPU runs of the
# same clip (tests/test_torch_clip_reference.py; PERF.md): the JAX package
# drifts at most 0.0142 m and the plain port 0.0305 m; both keep ICP valid
# on every frame, find 2012 of 4616 mover superpixel-frames (recall
# 0.4359) and mark none of 28 882 static ones dynamic. Rounding alone
# spreads the static clip's drift by 2.4x (0.0199 m JAX, 0.0235-0.0468 m
# port routes), so drift keeps that clip's 0.05 m limit; recall may fall
# by 0.136 (about a third), the false-dynamic share may reach 1%.
MOD_DRIFT_MAX = 0.05
MOD_ICP_MIN = 0.8
MOD_RECALL_MIN = 0.30
MOD_FALSE_MAX = 0.01
# the loop-closure phase's limits, set from free-running CPU runs of the
# revisit clip at 640x480 (tests/test_torch_clip_reference.py --clip
# revisit; PERF.md): both the JAX package and the plain port store 2
# keyframes, fire the gate on frame 25 and accept that closure, which
# takes the error from 0.0155 m (JAX) and 0.0161 m (port) to 0.0015 m;
# the max error over the clip is 0.0228 and 0.0227 m, ICP valid on every
# frame. The drift limit is the other clips' 0.05 m; the closure must
# bring the error under 0.01 m.
LC_KEYFRAMES_MIN = 2
LC_CLOSURE_ERR_MAX = 0.01
LC_DRIFT_MAX = 0.05
LC_ICP_MIN = 0.8
# the closure frame, card vs CPU from the same state: the deformed model's
# live positions in the scene (within LC_SCENE_M of the origin; the room's
# walls are 3.2 m away at most) within 1 cm everywhere and 1 mm on 99% of
# them; keyframe positions within 1 mm. Surfels the known fusion fault
# (ROADMAP Queue 3) threw far off the scene are counted, not compared: a
# node rotation's rounding moves a surfel 1e4 m away by millimetres. The
# graph solve (in f64 on both), from the same inputs: its error within
# 10%, the constraints' blended positions within 1e-4 m (its node
# transforms are weakly determined far from the constraints: reported)
LC_SCENE_M = 10.0
LC_CPU_MODEL_MAX = 1e-2
LC_CPU_MODEL_P99 = 1e-3
LC_CPU_KF_MAX = 1e-3
LC_OPT_ERR_REL = 0.1
LC_OPT_PRED_MAX = 1e-4
# the runner phase: frames of the static clip written as a TUM sequence;
# ATE limit as the static clip's drift limit
RUNNER_FRAMES = 10
RUNNER_ATE_MAX = 0.05
# the live phase: the static clip fed at 30 fps into a watch directory;
# the live runner's poses against the offline runner's on the same frames
LIVE_FRAMES = 30
LIVE_FPS = 30.0
LIVE_IDLE_S = 3.0
LIVE_POSE_MAX = 2e-3
LIVE_STDIN_FRAMES = 3
# the sharded phases: the loop-closure phase's clip and limits at 1 rank
# (NCCL) and 2 ranks sharing the card (gloo); the poses against the
# single-device loop-closure phase of the same call within limits set
# from CPU runs before the first chip run (the JAX package's own limits
# are 0.03 m and 0.1, tests/test_sharding.py)
SHARD_CLOSURE_FRAME = 25
SHARD_POSE_MAX = 0.03
SHARD_ROT_MAX = 0.1
SHARD_MOD_FRAMES = 4
# the options phase: each default-off option, 3 frames on the card and on
# the plain CPU path (poses within 2 mm); the fusion options on the static
# clip whose third frame has inverted colours (ICP is gate-rejected),
# temporal heat on the fr3 MOD configuration's dynamic clip
OPT_FRAMES = 3
OPT_POSE_MAX = 2e-3
# the nb_samples phase: the default configuration with a RANSAC plane
# table of 32 hypotheses (`TPSConfig.nb_samples`; the default draws 16),
# 3 frames through `SupersurfelFusion` on the card and on the plain CPU
# path (poses within 2 mm)
NB_SAMPLES = 32
NB_FRAMES = 3
NB_POSE_MAX = 2e-3
# the collect phase: the dynamic clip as a TUM sequence through the
# trainer's --collect (simple MOD path, fr3 camera) on the card; a label
# box hits the mover where its IoU with the mover's image rectangle
# exceeds 0.3. On the CPU every one of the clip's labelled frames has
# such a box (PERF.md); at least half must on the card
COLLECT_FRAMES = 30
COLLECT_HIT_SHARE = 0.5
# the training phase: the committed weights' own command
# (artifacts/run_exp5.sh: 716 fr3 frames at 640x480, batch 8, 30 epochs,
# lr 3e-4, no label filter, no augmentation); the card against the plain
# CPU path over the first steps from `init_params()` (cuDNN asked for
# deterministic algorithms): losses within 1e-4 relative, weights within
# 1e-4 (the port against JAX on the CPU: 1.4e-5 after 8 steps)
TRAIN_DATA = "artifacts/mod_boxes_train.npz"
EVAL_DATA = "artifacts/mod_boxes_eval.npz"
COMMITTED_WEIGHTS = "weights/person_detector.npz"
TRAIN_EPOCHS = 30
TRAIN_BATCH = 8
TRAIN_LR = 3e-4
TRAIN_CPU_STEPS = 5
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-4
# the last epoch's mean loss, from CPU runs of the same command made
# before the first chip run (PERF.md): JAX from its own init 2.8471
# (first epoch 4.2315), the port from the torch-drawn init it had before
# it drew JAX's 2.7742 (4.2091); the band is their range widened by 0.1
# (the epoch-to-epoch spread over the last ten epochs is about 0.06). The
# port now starts from JAX's init (`utils/prng.py`)
TRAIN_FINAL_LOSS = (2.67, 2.95)
H100_HBM_BPS = 3.35e12
H100_FP32_FLOPS = 67e12
# device time per call of the earlier kernels these replace (the per-phase
# design, on an NVIDIA H100 80GB HBM3, 700.00 W): an iteration was 4
# tps_phase launches
EARLIER_US = {"tps_iteration": 4 * 8.30, "tps_merge": 14.55}

_T0 = time.time()
# the card's name and power limit as nvidia-smi gives them (header())
CARD = "unknown card"


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
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

    # tps_iteration: exact agreement with four phases of the plain version
    # (same arithmetic, no fma)
    iter_err = 0.0
    for use_disp, tab in ((False, table), (True, table_d)):
        lk, ik = tps_cuda.tps_iteration(rgb_chw, disp, labels, inliers, tab,
                                        use_disp, tcfg)
        lp, ip = tps_cuda.iteration_reference(rgb_chw, disp, labels, inliers,
                                              tab, use_disp, tcfg)
        n_lab = int((lk != lp).sum())
        n_inl = int((ik != ip).sum())
        n_moved = int((lp != labels).sum())
        iter_err = max(iter_err, float((lk - lp).abs().max()),
                       float((ik - ip).abs().max()))
        log(f"  tps_iteration use_disp={use_disp}: {n_lab} label and "
            f"{n_inl} inlier mismatches ({n_moved} labels moved)")
        check(n_lab == 0 and n_inl == 0,
              f"tps_iteration ({use_disp}) equals four plain phases")

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
    def iter_k():
        tps_cuda.tps_iteration(rgb_chw, disp, labels, inliers, table_d, True,
                               tcfg)

    def iter_p():
        tps_cuda.iteration_reference(rgb_chw, disp, labels, inliers, table_d,
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

    ms_iter = graph_time_ms(iter_k, 100)
    ms_iter_plain = graph_time_ms(iter_p, 3)
    ms_merge = graph_time_ms(merge_k, 100)
    ms_merge_plain = graph_time_ms(merge_p, 10)
    ms_scatter = graph_time_ms(scatter, 100)
    eager_iter = cuda_time_ms(iter_k, 100)
    eager_merge = cuda_time_ms(merge_k, 100)
    ms_seg = cuda_time_ms(lambda: tps_cuda.segment(rgb, disp, tcfg), 5)
    ms_seg_plain = cuda_time_ms(
        lambda: tps_cuda.segment_reference(rgb, disp, tcfg), 3)

    # bounds from this run's shapes: each input read once, each output
    # written once; operations counted from the data where they depend on
    # it. The timed iteration is an RGBD one, which reads no inliers (each
    # pixel's inlier bit is the plane test of its final label): rgb, disp
    # and labels in, labels and inliers out, the table once.
    npx = H * W
    tab_bytes = 9 * gh * gw * 4
    iter_bytes = npx * (3 * 4 + 4 + 4) + tab_bytes + npx * (4 + 4)
    # each pixel is decided in one phase of the four: a 12-read stencil and
    # the inlier test, and on boundary pixels up to 5 energies of ~45 ops
    b = tps_ref.boundary_count(labels) > 0
    iter_ops = 22 * npx + 5 * 45 * int(b.sum())
    # the timed merge is an RGBD one: rgb, disp, labels and inliers in, the
    # whole table out; it reads no table (an RGB merge would read the
    # plane channels 6-8 to keep them)
    merge_bytes = npx * (3 * 4 + 4 + 4 + 4) + tab_bytes
    merge_ops = 35 * npx
    bound_iter = max(iter_bytes / H100_HBM_BPS,
                     iter_ops / H100_FP32_FLOPS) * 1e3
    bound_merge = max(merge_bytes / H100_HBM_BPS,
                      merge_ops / H100_FP32_FLOPS) * 1e3
    log(f"  tps_iteration {ms_iter * 1e3:.2f} us device (eager call "
        f"{eager_iter * 1e3:.2f} us; plain {ms_iter_plain * 1e3:.1f} us, "
        f"bound {bound_iter * 1e3:.2f} us, share of bound "
        f"{bound_iter / ms_iter:.1%}; earlier: 4 x tps_phase = "
        f"{EARLIER_US['tps_iteration']:.2f} us)")
    log(f"  tps_merge {ms_merge * 1e3:.2f} us device (eager call "
        f"{eager_merge * 1e3:.2f} us; plain {ms_merge_plain * 1e3:.1f} us, "
        f"bound {bound_merge * 1e3:.2f} us, share of bound "
        f"{bound_merge / ms_merge:.1%}; scatter_add_ "
        f"{ms_scatter * 1e3:.2f} us; earlier: "
        f"{EARLIER_US['tps_merge']:.2f} us)")
    log(f"  TPS segment: kernels {ms_seg:.3f} ms, plain {ms_seg_plain:.3f} ms")
    return {
        "tps_iteration": dict(max_abs_err=iter_err, ms=ms_iter,
                              plain_ms=ms_iter_plain, bound_ms=bound_iter,
                              bound_by="bytes" if iter_bytes / H100_HBM_BPS
                              >= iter_ops / H100_FP32_FLOPS
                              else "operations",
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
        if k == N_FRAMES - 1:    # under a CUDA trace, left out of the times
            out, runs = tps_runs(
                lambda: slam.process(rgb, depth, timestamp=float(k)))
        else:
            t1 = time.time()
            out = slam.process(rgb, depth, timestamp=float(k))
            torch.cuda.synchronize()
            frame_s.append(time.time() - t1)
        outs.append(out)
    launches = dict(tps_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    log(f"  launches {launches} over {N_FRAMES} frames, runs in the last "
        f"{runs}")
    check_tps(launches, runs)
    steady = frame_s[2:]
    log(f"  ms/frame: first {frame_s[0] * 1e3:.1f}, steady mean "
        f"{np.mean(steady) * 1e3:.2f} median {np.median(steady) * 1e3:.2f} "
        f"(frames 2..{N_FRAMES - 2}); peak memory "
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


def detector_phase(dev, weights=None):
    """The person detector on the card against the plain CPU path on one
    rendered 640x480 frame: heat map and valid boxes. `weights`: a
    checkpoint other than the committed one."""
    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.models.person_detector import (
        load_detector,
    )
    from supersurfel_fusion_tpu_torch.tools.profile_frame import mod_config
    from supersurfel_fusion_tpu_torch.utils.color import rgb_to_gray

    cfg = mod_config()
    weights = weights or cfg.mod.weights_path
    rgb, depth, _, _ = synthetic.dynamic_frames(cfg.cam, 4)[3]
    gray = rgb_to_gray(torch.from_numpy(rgb).float())
    d = torch.from_numpy(depth.astype(np.float32)) * cfg.depth_scale
    cpu = load_detector(weights, "cpu")
    card = load_detector(weights, dev)
    gray_d, d_d = gray.to(dev), d.to(dev)
    hc, _ = cpu.maps(gray, d)
    hg, _ = card.maps(gray_d, d_d)
    err = (hg.cpu() - hc).abs().max().item()
    log(f"  heat map {tuple(hg.shape)}: max |card - cpu| {err:.3e}, max "
        f"score {hc.max().item():.4f}")
    check(err <= 1e-5, "detector heat map: card vs CPU <= 1e-5")
    for thresh in (cfg.mod.person_score_thresh, None):
        if thresh is None:   # between the 3rd and 4th peaks: 3 valid boxes
            top = torch.sort(cpu(gray, d).scores, descending=True).values
            thresh = float(top[2] + top[3]) / 2
        dc = cpu(gray, d, score_thresh=thresh)
        dg = card(gray_d, d_d, score_thresh=thresh)
        v = dc.valid
        same = torch.equal(dg.valid.cpu(), v)
        box_err = ((dg.boxes.cpu()[v] - dc.boxes[v]).abs().max().item()
                   if v.any() else 0.0)
        log(f"  threshold {thresh:.4f}: {int(v.sum())} valid boxes, card "
            f"agrees {same}, box max |diff| {box_err:.3e} px")
        check(same and box_err <= 1e-2,
              f"detector boxes at threshold {thresh:.4f}: card == CPU")
    ms = cuda_time_ms(lambda: card(gray_d, d_d), 20)
    ms_maps = graph_time_ms(lambda: card.maps(gray_d, d_d), 20)
    log(f"  detector on the card: {ms:.3f} ms per eager call, convolutions "
        f"{ms_maps:.3f} ms device time (CUDA graph)")
    return {"heat_err": err, "ms": ms, "maps_ms": ms_maps}


def motion_phase(dev):
    """`detect_motion` on the card against the CPU on frames 4 and 5 of
    the dynamic clip: the front end, keypoints and previous context are
    computed once on the CPU and fed to both devices."""
    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.models.person_detector import (
        load_detector,
    )
    from supersurfel_fusion_tpu_torch.ops import motion
    from supersurfel_fusion_tpu_torch.ops.features import detect_and_describe
    from supersurfel_fusion_tpu_torch.pipeline import front_end
    from supersurfel_fusion_tpu_torch.tools.profile_frame import mod_config
    from supersurfel_fusion_tpu_torch.utils.color import rgb_to_gray

    def to(x):
        if isinstance(x, tuple):
            return type(x)(*(to(v) for v in x))
        return x.to(dev)

    cfg = mod_config()
    clip = synthetic.dynamic_frames(cfg.cam, 6)
    det_cpu = load_detector(cfg.mod.weights_path, "cpu")
    det_card = load_detector(cfg.mod.weights_path, dev)
    prev = None
    for k in (4, 5):
        rgb = torch.from_numpy(clip[k][0]).float()
        depth = torch.from_numpy(clip[k][1].astype(np.float32)) \
            * cfg.depth_scale
        fe = front_end(rgb, depth, cfg, torch.tensor(k, dtype=torch.int32))
        gray = rgb_to_gray(rgb)
        kp = detect_and_describe(gray, cfg.vo)
        if prev is None:
            prev = motion.init_prev(cfg.cam.height, cfg.cam.width,
                                    kp.capacity, device="cpu")
        args = (gray, fe.fdepth, prev, kp, fe.frame, fe.tps)
        sc, kc, prev_next = motion.detect_motion(
            *args, cfg.cam, cfg.tps, cfg.mod, detector=det_cpu)
        if k == 4:
            prev = prev_next
            continue
        args_d = tuple(to(a) for a in args)
        sg, kg, _ = motion.detect_motion(*args_d, cfg.cam, cfg.tps, cfg.mod,
                                         detector=det_card)
        torch.cuda.synchronize()
    sp_agree = (sg.cpu() == sc).float().mean().item()
    kp_agree = (kg.cpu() == kc).float().mean().item()
    s = synthetic.mover_scores(fe.tps.labels.numpy(), sc.numpy(), clip[5][3])
    log(f"  frame 5: CPU marks {int((~sc).sum())} superpixels dynamic "
        f"({s['mover_dynamic']}/{s['mover_sp']} on the mover), the card "
        f"{int((~sg).sum())}; static_sp agreement {sp_agree:.4f}, "
        f"static_kp agreement {kp_agree:.4f}")
    check(s["mover_dynamic"] > 0, "detect_motion finds the mover")
    check(sp_agree >= MOTION_SP_AGREE, f"static_sp: card vs CPU agree on "
          f">= {MOTION_SP_AGREE:.0%} of superpixels")
    check(kp_agree >= MOTION_KP_AGREE, f"static_kp: card vs CPU agree on "
          f">= {MOTION_KP_AGREE:.0%} of keypoints")
    ms = cuda_time_ms(lambda: motion.detect_motion(
        *args_d, cfg.cam, cfg.tps, cfg.mod, detector=det_card), 5)
    log(f"  detect_motion on the card: {ms:.2f} ms per call (eager, CUDA "
        f"events)")
    return {"sp_agree": sp_agree, "kp_agree": kp_agree, "ms": ms}


def mod_pipeline_phase(dev):
    """bench's fr3 MOD configuration over the dynamic clip through the
    user's entry point, on the card, then its first frames on the CPU."""
    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion
    from supersurfel_fusion_tpu_torch.tools.profile_frame import mod_config

    cfg = mod_config()
    t0 = time.time()
    clip = synthetic.dynamic_frames(cfg.cam, N_FRAMES)
    log(f"  rendered {N_FRAMES} dynamic frames in {time.time() - t0:.2f} s")

    slam = SupersurfelFusion(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tps_cuda.reset_launch_counts()
    outs, frame_s = [], []
    for k, (rgb, depth, _, _) in enumerate(clip):
        if k == N_FRAMES - 1:    # under a CUDA trace, left out of the times
            out, runs = tps_runs(
                lambda: slam.process(rgb, depth, timestamp=float(k)))
        else:
            t1 = time.time()
            out = slam.process(rgb, depth, timestamp=float(k))
            torch.cuda.synchronize()
            frame_s.append(time.time() - t1)
        outs.append(out)
    launches = dict(tps_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    log(f"  launches {launches} over {N_FRAMES} frames, runs in the last "
        f"{runs}")
    check_tps(launches, runs)
    steady = np.array(frame_s[2:]) * 1e3
    log(f"  ms/frame: first {frame_s[0] * 1e3:.1f}, mean (all) "
        f"{np.mean(frame_s) * 1e3:.2f}, median (all) "
        f"{np.median(frame_s) * 1e3:.2f}, steady mean {steady.mean():.2f} "
        f"median {np.median(steady):.2f} (frames 2..{N_FRAMES - 2}); peak "
        f"memory {peak / 2**20:.1f} MiB")

    traj = np.array(slam.trajectory)
    err = synthetic.translation_errors(traj)
    icp_ok = np.array([bool(o.icp_valid) for o in outs])
    nb = int(outs[-1].nb_supersurfels)
    scores = [synthetic.mover_scores(o.labels.cpu().numpy(),
                                     o.static_sp.cpu().numpy(), c[3])
              for o, c in zip(outs[2:], clip[2:])]
    mv = synthetic.mover_summary(scores)
    log(f"  icp valid {icp_ok[1:].mean():.3f}, nb_supersurfels {nb}")
    log(f"  translation error vs known trajectory: final {err[-1]:.4f} m, "
        f"max {err.max():.4f} m")
    log(f"  mover recall {mv['mover_recall']:.4f} ({mv['mover_dynamic']}/"
        f"{mv['mover_sp']}), false-dynamic share {mv['false_dynamic']:.4f} "
        f"({mv['static_dynamic']}/{mv['static_sp']}), frames 2..")
    check(nb > 0, "nb_supersurfels > 0")
    check(bool(np.isfinite(traj).all()), "all poses finite")
    check(icp_ok[1:].mean() >= MOD_ICP_MIN,
          f"ICP valid on >= {MOD_ICP_MIN:.0%} of frames after the first")
    check(err.max() < MOD_DRIFT_MAX,
          f"drift against the known trajectory < {MOD_DRIFT_MAX} m")
    check(mv["mover_recall"] >= MOD_RECALL_MIN,
          f"mover recall >= {MOD_RECALL_MIN}")
    check(mv["false_dynamic"] <= MOD_FALSE_MAX,
          f"false-dynamic share <= {MOD_FALSE_MAX}")

    ref = SupersurfelFusion(cfg, device="cpu")
    for k, (rgb, depth, _, _) in enumerate(clip[:N_CPU_FRAMES]):
        ref.process(rgb, depth, timestamp=float(k))
    d = np.abs(np.array(ref.trajectory)[:, :3] - traj[:N_CPU_FRAMES, :3]).max()
    log(f"  card vs plain CPU path, first {N_CPU_FRAMES} poses: max |dt| "
        f"{d:.2e} m")
    check(d < 2e-3, "card MOD pipeline agrees with the plain CPU path "
          "(|dt| < 2 mm)")
    return launches, {
        "ms_mean": float(np.mean(frame_s) * 1e3),
        "ms_median": float(np.median(frame_s) * 1e3),
        "ms_steady": float(steady.mean()), "peak_mib": peak / 2**20,
        "icp_valid": float(icp_ok[1:].mean()), "max_err": float(err.max()),
        "mover_recall": mv["mover_recall"],
        "false_dynamic": mv["false_dynamic"], "cpu_dt": float(d)}


def _to(x, dev):
    """Tensors, and NamedTuples or tuples of them, on `dev`."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [_to(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def device_ms(fn) -> float:
    """Device time of one fn() call: the kernels' self time under
    torch.profiler (the host's launch gaps left out)."""
    import torch
    from torch.autograd import DeviceType

    from supersurfel_fusion_tpu_torch.tools.profile_frame import _device_us

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_device_us(e, True) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ssf.")) / 1e3


def frame_launches(fn):
    """(launch calls by "ssf.*" stage, all launch calls) of one fn()."""
    import torch

    from supersurfel_fusion_tpu_torch.tools.profile_frame import (
        stage_launches,
    )

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return stage_launches(prof.events(), 1)


def tps_runs(fn):
    """(fn(), the TPS kernels' runs on the card during it by kernel), read
    from a CUDA trace of the call: a CUDA graph's replay runs them without
    calling their launchers, whose own counts (`tps_cuda.launch_counts`)
    see the op-by-op frames and the capture alone."""
    import torch

    from supersurfel_fusion_tpu_torch.tools.profile_frame import kernel_runs

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    runs = kernel_runs(prof, ["tps_iteration_kernel", "tps_merge_kernel"])
    return out, {k[:-len("_kernel")]: v for k, v in runs.items()}


def check_tps(launches: dict, runs: dict) -> None:
    """The TPS launchers called on a runner's op-by-op first frame and its
    capture frame alone (its stages replay as CUDA graphs after), and a
    replayed frame's trace running 10 iterations and 12 merges."""
    check(launches == {"tps_iteration": 20, "tps_merge": 24},
          "TPS launchers called on the first two frames alone")
    check(runs == {"tps_iteration": 10, "tps_merge": 12},
          "a replayed frame runs 10 tps_iteration and 12 tps_merge kernels")


def lc_pipeline_phase(dev):
    """Ferns and loop closure over the revisit clip through the user's
    entry point, on the card; then the closure frame and the graph solve
    on the plain CPU path from the card's inputs."""
    import torch

    from supersurfel_fusion_tpu_torch import convert, synthetic
    from supersurfel_fusion_tpu_torch.ops import deformation, loop_closure
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.pipeline import (
        SupersurfelFusion,
        process_frame,
    )
    from supersurfel_fusion_tpu_torch.tools.profile_frame import (
        host_syncs,
        lc_config,
    )

    cfg = lc_config()
    t0 = time.time()
    clip = synthetic.revisit_frames(cfg.cam)
    n = len(clip)
    log(f"  rendered {n} revisit frames in {time.time() - t0:.2f} s")

    # the inputs of every graph solve the run makes, kept for the CPU
    # comparison and the timings below
    solves = []
    orig_opt = deformation.optimise

    def keep_inputs(*a, **kw):
        solves.append(a)
        return orig_opt(*a, **kw)

    deformation.optimise = keep_inputs
    try:
        t1 = time.time()
        slam = SupersurfelFusion(cfg, device=dev)
        torch.cuda.synchronize()
        init_s = time.time() - t1
        solves.clear()                  # the start-up's warm-up solve
        torch.cuda.reset_peak_memory_stats()
        tps_cuda.reset_launch_counts()
        # the states before each gate frame and before the frame ahead
        # of it are kept for the replays below (two states more on the
        # card at the peak)
        outs, frame_s, kept, prev = [], [], {}, None
        for k, (rgb, depth, _) in enumerate(clip):
            before = slam.state
            if k == n - 1:   # under a CUDA trace, left out of the times
                out, runs = tps_runs(
                    lambda: slam.process(rgb, depth, timestamp=float(k)))
            else:
                t1 = time.time()
                out = slam.process(rgb, depth, timestamp=float(k))
                torch.cuda.synchronize()
                frame_s.append(time.time() - t1)
            outs.append(out)
            if out.lc_gate and not kept:
                kept = {k: before, k - 1: prev}
            prev = before
        launches = dict(tps_cuda.launch_counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        deformation.optimise = orig_opt

    log(f"  launches {launches} over {n} frames, runs in the last {runs}")
    check_tps(launches, runs)
    st = slam.state
    gates = [k for k, o in enumerate(outs) if o.lc_gate]
    accepted = [k for k, o in enumerate(outs)
                if o.lc_gate and bool(o.lc_accepted)]
    kf = int(st.kf_store.db.count)
    traj = np.array(slam.trajectory)
    err = synthetic.translation_errors(traj, synthetic.revisit_trajectory())
    icp_ok = np.array([bool(o.icp_valid) for o in outs])
    nb = int(st.model.nb_supersurfels)
    live = st.model.surfels.confidences[:nb] > 0
    model_ok = bool(torch.isfinite(st.model.surfels.positions[:nb][live])
                    .all())
    log(f"  keyframes {kf}, gate fired on frames {gates}, closures "
        f"accepted on {accepted}, lc_count {int(st.lc_count)}")
    log(f"  translation error vs known trajectory: max {err.max():.4f} m, "
        f"final {err[-1]:.4f} m" + (
            f", before the closure {err[accepted[0] - 1]:.4f} m, at it "
            f"{err[accepted[0]]:.4f} m" if accepted else ""))
    log(f"  icp valid {icp_ok[1:].mean():.3f}, nb_supersurfels {nb}")
    check(kf >= LC_KEYFRAMES_MIN, f"at least {LC_KEYFRAMES_MIN} keyframes")
    check(len(accepted) >= 1, "at least one closure accepted")
    check(bool(np.isfinite(traj).all()) and model_ok,
          "poses and the model finite")
    check(err[accepted[0]] < LC_CLOSURE_ERR_MAX,
          f"error at the closure frame < {LC_CLOSURE_ERR_MAX} m")
    check(err.max() < LC_DRIFT_MAX,
          f"drift against the known trajectory < {LC_DRIFT_MAX} m")
    check(icp_ok[1:].mean() >= LC_ICP_MIN,
          f"ICP valid on >= {LC_ICP_MIN:.0%} of frames after the first")

    kc = accepted[0]
    ordinary = [s for k, s in enumerate(frame_s) if k >= 2 and k not in gates]
    store_mib = st.kf_store.nbytes() / 2**20
    log(f"  ms/frame: ordinary frames (2.., no gate) mean "
        f"{np.mean(ordinary) * 1e3:.2f} median "
        f"{np.median(ordinary) * 1e3:.2f}; closure frame {kc} "
        f"{frame_s[kc] * 1e3:.2f}; first frame {frame_s[0] * 1e3:.1f}; "
        f"start-up (the graph solve's warm-up included) {init_s:.2f} s")
    log(f"  peak memory {peak / 2**20:.1f} MiB, keyframe store "
        f"{store_mib:.1f} MiB")

    # the first gate frame (the closure) and the frame ahead of it again,
    # from their states: launches by stage, host waits, and the branch's
    # device time
    check(gates[0] == kc, "the first gate frame is the accepted closure")
    before, st_o = kept[kc], kept[kc - 1]
    rgb, depth, _ = clip[kc]
    rgb_o, depth_o, _ = clip[kc - 1]

    def closure_frame():
        return process_frame(before, rgb, depth, cfg)

    t1 = time.time()
    closure_frame()
    torch.cuda.synchronize()
    ms_closure_again = (time.time() - t1) * 1e3
    log(f"  closure frame again, from its state: {ms_closure_again:.2f} ms "
        f"(the first time {frame_s[kc] * 1e3:.2f} ms)")

    def ordinary_frame():
        return process_frame(st_o, rgb_o, depth_o, cfg)

    ordinary_frame()
    closure_frame()
    lc_stage, lc_all = frame_launches(closure_frame)
    o_stage, o_all = frame_launches(ordinary_frame)
    waits_o = host_syncs(ordinary_frame)
    waits_c = host_syncs(closure_frame)
    log(f"  launch calls: ordinary frame {o_all:.0f} (ssf.ferns "
        f"{o_stage.get('ssf.ferns', 0):.0f}, ssf.loop_closure "
        f"{o_stage.get('ssf.loop_closure', 0):.0f}); closure frame "
        f"{lc_all:.0f} (ssf.ferns {lc_stage.get('ssf.ferns', 0):.0f}, "
        f"ssf.loop_closure {lc_stage.get('ssf.loop_closure', 0):.0f})")
    log(f"  host waits: ordinary frame {sum(c for _, c in waits_o)} "
        f"{waits_o}; closure frame {sum(c for _, c in waits_c)} {waits_c}")

    lc_args = None
    orig_lc = loop_closure.close_global_loop

    def keep_lc(*a, **kw):
        nonlocal lc_args
        lc_args = a
        return orig_lc(*a, **kw)

    loop_closure.close_global_loop = keep_lc
    try:
        closure_frame()
    finally:
        loop_closure.close_global_loop = orig_lc
    opt_args = solves[0]
    ms_lc_dev = device_ms(lambda: orig_lc(*lc_args))
    ms_opt_dev = device_ms(lambda: orig_opt(*opt_args))
    ms_lc = cuda_time_ms(lambda: orig_lc(*lc_args), 3, warmup=1)
    ms_opt = cuda_time_ms(lambda: orig_opt(*opt_args), 3, warmup=1)
    log(f"  close_global_loop: {ms_lc_dev:.3f} ms device, {ms_lc:.2f} ms "
        f"per eager call; optimise: {ms_opt_dev:.3f} ms device, "
        f"{ms_opt:.2f} ms per eager call")

    # the closure frame on the plain CPU path, from the card's state; the
    # deformed model is compared as `close_global_loop` returns it (the
    # fusion after it compacts the model, so a surfel kept on one device
    # and dropped on the other would shift every index after it)
    cpu_before = convert.state_from_numpy(convert.state_to_numpy(before),
                                          "cpu")
    t1 = time.time()
    cpu_st, cpu_out = process_frame(cpu_before, rgb, depth, cfg)
    cpu_s = time.time() - t1
    card_st, card_out = closure_frame()
    dt = float((card_out.pose.t.cpu() - cpu_out.pose.t).abs().max())
    k_kf = int(card_st.kf_store.db.count)
    d_kf = float((card_st.kf_store.db.poses_t[:k_kf].cpu()
                  - cpu_st.kf_store.db.poses_t[:k_kf]).abs().max())
    lg = orig_lc(*lc_args)
    lcpu = orig_lc(*_to(lc_args, "cpu"))
    nb0 = int(before.model.nb_supersurfels)
    p0 = before.model.surfels.positions[:nb0].cpu()
    live0 = (before.model.surfels.confidences[:nb0] > 0).cpu()
    in_scene = live0 & (p0.norm(dim=-1) < LC_SCENE_M)
    d = (lcpu.model.positions[:nb0]
         - lg.model.positions[:nb0].cpu()).norm(dim=-1)
    moved = (lg.model.positions[:nb0].cpu() - p0).norm(dim=-1)[in_scene]
    log(f"  closure: {int(in_scene.sum())} live surfels in the scene, "
        f"{int((live0 & ~in_scene).sum())} beyond {LC_SCENE_M} m (the "
        f"farthest {float(p0[live0].norm(dim=-1).max()):.3g} m); the "
        f"closure moved those in the scene by {float(moved.median()):.2e} m "
        f"(median), {float(moved.max()):.2e} m (max)")
    d_far = float(d[live0 & ~in_scene].max()) if (live0 & ~in_scene).any() \
        else 0.0
    d = d[in_scene]
    log(f"  closure frame on the CPU ({cpu_s:.1f} s): accepted "
        f"{bool(cpu_out.lc_accepted)} (card {bool(card_out.lc_accepted)}), "
        f"pose |dt| {dt:.2e} m, keyframe poses max |d| {d_kf:.2e} m, "
        f"nb_supersurfels {int(cpu_out.nb_supersurfels)} (card "
        f"{int(card_out.nb_supersurfels)}); close_global_loop's deformed "
        f"positions in the scene max |d| {float(d.max()):.2e} m, 99th "
        f"percentile {float(d.quantile(0.99)):.2e} m (beyond it max |d| "
        f"{d_far:.2e} m)")
    check(bool(cpu_out.lc_accepted) == bool(card_out.lc_accepted)
          == bool(lg.accepted) == bool(lcpu.accepted),
          "closure frame: card and CPU accept alike")
    check(dt < 2e-3, "closure frame: card pose within 2 mm of the CPU's")
    check(float(d.max()) < LC_CPU_MODEL_MAX
          and float(d.quantile(0.99)) < LC_CPU_MODEL_P99,
          f"closure frame: deformed model within {LC_CPU_MODEL_MAX} m "
          f"(99%: {LC_CPU_MODEL_P99} m) of the CPU's")
    check(d_kf < LC_CPU_KF_MAX,
          f"closure frame: keyframe poses within {LC_CPU_KF_MAX} m")

    # the graph solve on the CPU from the card's inputs. Nodes far in time
    # from both constraint sets are weakly determined even in f64, so the
    # node transforms are reported, and what the solve determines is held:
    # the error, the constraints' blended positions and their mean error
    rg = orig_opt(*opt_args)
    rc = orig_opt(*_to(opt_args, "cpu"))
    d_rot = float((rg[0].cpu() - rc[0]).abs().max())
    d_tr = float((rg[1].cpu() - rc[1]).abs().max())
    graph, binding, src = opt_args[0], opt_args[1], opt_args[2]
    pg = deformation.blend_positions(graph.positions, rg[0], rg[1], binding,
                                     src).cpu()
    pc = deformation.blend_positions(*_to((graph.positions, rc[0], rc[1],
                                           binding, src), "cpu"))
    d_pred = float((pg - pc).abs().max())
    e_rel = abs(float(rg[2]) - float(rc[2])) / max(float(rc[2]), 1e-12)
    log(f"  optimise card vs CPU: node rot max |d| {d_rot:.2e}, trans max "
        f"|d| {d_tr:.2e} m; error {float(rg[2]):.4e} vs {float(rc[2]):.4e} "
        f"({e_rel:.1%}), mean constraint error {float(rg[3]):.3e} vs "
        f"{float(rc[3]):.3e} m, blended constraint positions max |d| "
        f"{d_pred:.2e} m")
    check(e_rel < LC_OPT_ERR_REL and d_pred < LC_OPT_PRED_MAX
          and abs(float(rg[3]) - float(rc[3])) < 1e-6,
          f"optimise: card error within {LC_OPT_ERR_REL:.0%} of the CPU's, "
          f"constraint positions within {LC_OPT_PRED_MAX} m, mean "
          f"constraint error within 1e-6 m")
    return launches, {
        "keyframes": kf, "gates": gates, "accepted": accepted,
        "max_err": float(err.max()), "closure_err": float(err[kc]),
        "ms_ordinary": float(np.median(ordinary) * 1e3),
        "traj": traj,
        "ms_closure": frame_s[kc] * 1e3, "ms_closure_again": ms_closure_again,
        "init_s": init_s,
        "lc_device_ms": ms_lc_dev,
        "opt_device_ms": ms_opt_dev, "peak_mib": peak / 2**20,
        "store_mib": store_mib, "launches_ordinary": o_all,
        "launches_closure": lc_all,
        "waits_ordinary": sum(c for _, c in waits_o),
        "waits_closure": sum(c for _, c in waits_c)}


def runner_phase(dev):
    """A TUM-format directory of synthetic frames through the runner's
    `main`, on the card, with loop closure on and off."""
    import contextlib
    import io
    import os
    import tempfile

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.apps import run_benchmark
    from supersurfel_fusion_tpu_torch.config import PipelineConfig
    from supersurfel_fusion_tpu_torch.eval.trajectory import ate
    from supersurfel_fusion_tpu_torch.io import native_loader
    from supersurfel_fusion_tpu_torch.io.tum import read_trajectory_file
    from supersurfel_fusion_tpu_torch.ops import tps_cuda

    clip = synthetic.frames(PipelineConfig().cam, RUNNER_FRAMES)
    launches = {k: 0 for k in tps_cuda.launch_counts}
    t0 = time.time()
    try:
        lib = native_loader.build_library()
        built = True
        log(f"  native TUM loader built from "
            f"{os.path.relpath(native_loader.SOURCE)} in "
            f"{time.time() - t0:.2f} s: {lib.name}")
    except ImportError as e:
        built = False
        log(f"  native TUM loader build failed: {str(e).strip()[-300:]}")
    check(built, "the native TUM loader builds (g++, pthread only)")
    fps = {}
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "rgbd_dataset_freiburg1_synthetic")
        stamps = synthetic.write_tum_sequence(seq, clip)
        gt = read_trajectory_file(os.path.join(seq, "groundtruth.txt"))
        decode = decode_times(seq)
        for lc in (True, False):
            out = os.path.join(tmp, f"estimated_{int(lc)}.txt")
            argv = ["--dataset", seq, "--out", out, "--quiet"] \
                + (["--loop-closure"] if lc else [])
            buf = io.StringIO()
            tps_cuda.reset_launch_counts()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                rc = run_benchmark.main(argv)
            wall = time.time() - t0
            for k, v in tps_cuda.launch_counts.items():
                launches[k] += v
            line = buf.getvalue().strip().splitlines()[-1]
            log(f"  runner {' '.join(argv[4:])}: rc {rc} in {wall:.1f} s: "
                f"{line}")
            res = json.loads(line)
            est = read_trajectory_file(out)
            r = ate(est, gt)
            check(rc == 0 and res["frames"] == RUNNER_FRAMES
                  and res["device"].startswith("cuda"),
                  f"runner ran {RUNNER_FRAMES} frames on the card")
            check(sorted(est) == stamps, "runner: one trajectory row per "
                  "frame, at the frame's timestamp")
            check(abs(res["ate_rmse"] - r.rmse) < 1e-4
                  and r.rmse < RUNNER_ATE_MAX,
                  f"runner: ATE {r.rmse:.4f} m < {RUNNER_ATE_MAX} m, as "
                  f"its JSON line says")
            check(("lc_count" in res) == lc
                  and (not lc or res["keyframes"] >= 1),
                  "runner: loop-closure fields exactly with --loop-closure")
            check(res["loader"] == "native", "runner: frames decoded by the "
                  "native loader (\"loader\": \"native\")")
            fps["lc" if lc else "plain"] = res["fps"]
    check(launches == {"tps_iteration": 2 * 20, "tps_merge": 2 * 24},
          "runner: each run calls the TPS launchers on its first two frames "
          "alone (the stages replay as CUDA graphs after)")
    log(f"  runner fps with the native prefetcher ({CARD}): with "
        f"--loop-closure {fps['lc']}, without {fps['plain']}")
    return launches, dict(decode, fps_lc=fps["lc"], fps=fps["plain"])


def decode_times(seq: str) -> dict:
    """ms per (rgb, depth) pair of the 640x480 frames in the TUM directory
    `seq`: the native decoder against PIL (as `io/tum.py` decodes) on the
    same files, 3 passes each, median over pairs and passes; both decoders'
    frames bit for bit equal."""
    from PIL import Image

    from supersurfel_fusion_tpu_torch.io import native_loader
    from supersurfel_fusion_tpu_torch.io.tum import TUMDataset

    ds = TUMDataset(seq)
    pairs = [(os.path.join(seq, a.rgb_file), os.path.join(seq, a.depth_file))
             for a in ds.associations]
    ms = {"native": [], "pil": []}
    equal = True
    for _ in range(3):
        for rgb_path, depth_path in pairs:
            t0 = time.perf_counter()
            nat = native_loader.decode_pair(rgb_path, depth_path)
            t1 = time.perf_counter()
            pil = (np.asarray(Image.open(rgb_path), dtype=np.uint8),
                   np.asarray(Image.open(depth_path)))
            t2 = time.perf_counter()
            ms["native"].append((t1 - t0) * 1e3)
            ms["pil"].append((t2 - t1) * 1e3)
            equal &= (np.array_equal(nat[0], pil[0])
                      and np.array_equal(nat[1], pil[1]))
    out = {f"decode_{k}_ms": float(np.median(v)) for k, v in ms.items()}
    log(f"  decode per (rgb, depth) 640x480 pair ({CARD}; host CPU): native "
        f"median {out['decode_native_ms']:.3f} ms, PIL median "
        f"{out['decode_pil_ms']:.3f} ms ({len(pairs)} pairs x 3 passes)")
    check(equal, "native decode equals PIL's on every pair")
    return out



def _watch_lines(path, stop, seen):
    """Poll `path` every 10 ms until `stop` is set; record when each line
    appears (the file is read only when its size changed)."""
    import os

    n, size = 0, -1
    while True:
        done = stop.is_set()        # one more poll after the stop
        try:
            now_size = os.stat(path).st_size
        except OSError:
            now_size = -1
        if now_size != size:
            size = now_size
            with open(path) as f:
                m = sum(1 for _ in f)
            now = time.time()
            while n < m:
                seen.append(now)
                n += 1
        if done:
            return
        time.sleep(0.01)


def live_phase(dev):
    """The port's feeder writes the static clip into a watch directory at
    30 fps (a subprocess); `apps.run_live --watch` runs on the card. Every
    frame once, in stamp order, poses as the offline runner's; latency and
    backlog; then a few frames through `--stdin`."""
    import contextlib
    import io
    import os
    import tempfile
    import threading

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.apps import run_benchmark, run_live
    from supersurfel_fusion_tpu_torch.config import PipelineConfig
    from supersurfel_fusion_tpu_torch.io.tum import read_trajectory_file
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    clip = synthetic.frames(PipelineConfig().cam, LIVE_FRAMES)
    launches = {k: 0 for k in tps_cuda.launch_counts}
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "rgbd_dataset_freiburg1_synthetic")
        stamps = synthetic.write_tum_sequence(seq, clip)
        watch = os.path.join(tmp, "watch")
        live_out = os.path.join(tmp, "live.txt")
        stop = threading.Event()
        seen = []
        watcher = threading.Thread(target=_watch_lines,
                                   args=(live_out, stop, seen))
        tps_cuda.reset_launch_counts()
        feeder = subprocess.Popen(
            [sys.executable, "-m",
             "supersurfel_fusion_tpu_torch.tools.stream_feeder",
             "--dataset", seq, "--target", watch, "--fps", str(LIVE_FPS)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        buf = io.StringIO()
        # the runner starts once the camera does: the feeder's process
        # takes seconds to import the port, longer than the idle timeout
        first = os.path.join(watch, "depth", f"{stamps[0]:.6f}.png")
        t0 = time.time()
        while not os.path.exists(first) and feeder.poll() is None \
                and time.time() - t0 < 120:
            time.sleep(0.01)
        log(f"  feeder's first frame after {time.time() - t0:.1f} s")
        watcher.start()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                rc = run_live.main(["--watch", watch, "--out", live_out,
                                    "--idle-timeout", str(LIVE_IDLE_S),
                                    "--quiet"])
        finally:
            stop.set()
            watcher.join(timeout=10)
            try:
                fed = feeder.communicate(timeout=60)[0].strip()
            finally:
                if feeder.poll() is None:
                    feeder.kill()
                    feeder.wait()
        wall = time.time() - t0
        for k, v in tps_cuda.launch_counts.items():
            launches[k] += v
        line = buf.getvalue().strip().splitlines()[-1]
        res = json.loads(line)
        log(f"  feeder: {fed} (exit {feeder.returncode}); live runner rc "
            f"{rc} in {wall:.1f} s: {line}")
        # a frame appears when its depth file is renamed into place
        appear = [os.stat(os.path.join(watch, "depth", f"{ts:.6f}.png"))
                  .st_mtime for ts in stamps]
        live = read_trajectory_file(live_out)
        with open(live_out) as f:
            order = [float(ln.split()[0]) for ln in f if ln.strip()]
        check(rc == 0 and feeder.returncode == 0
              and res["frames"] == LIVE_FRAMES,
              f"live runner consumed {LIVE_FRAMES} frames on the card")
        check(order == stamps, "live runner: every fed frame once, in stamp "
              "order")
        check(len(seen) == LIVE_FRAMES, "every pose line was seen flushed")
        lat = np.array(seen) - np.array(appear)
        backlog = [int(sum(a <= t for a in appear)) - (k + 1)
                   for k, t in enumerate(seen)]
        log(f"  live: {res['fps']:.2f} fps; latency from a frame's file to "
            f"its pose line median {np.median(lat) * 1e3:.1f} ms, max "
            f"{lat.max() * 1e3:.1f} ms, first {lat[0] * 1e3:.1f} ms; largest "
            f"backlog {max(backlog)} frames; feed {appear[-1] - appear[0]:.2f} "
            f"s for {LIVE_FRAMES} frames")

        off_out = os.path.join(tmp, "offline.txt")
        tps_cuda.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_off = run_benchmark.main(["--dataset", seq, "--out", off_out,
                                         "--quiet"])
        for k, v in tps_cuda.launch_counts.items():
            launches[k] += v
        off_fps = json.loads(buf.getvalue().strip().splitlines()[-1])["fps"]
        off = read_trajectory_file(off_out)
        d = max(float(np.linalg.norm(np.asarray(live[ts][:3])
                                     - np.asarray(off[ts][:3])))
                for ts in stamps)
        log(f"  live vs offline runner, same frames: max |dt| {d:.2e} m; "
            f"offline runner {off_fps:.2f} fps")

        # the same feed once more without the line watcher: its polling
        # thread takes the interpreter lock from the host-bound step
        watch2 = os.path.join(tmp, "watch2")
        feeder = subprocess.Popen(
            [sys.executable, "-m",
             "supersurfel_fusion_tpu_torch.tools.stream_feeder",
             "--dataset", seq, "--target", watch2, "--fps", str(LIVE_FPS)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        first = os.path.join(watch2, "depth", f"{stamps[0]:.6f}.png")
        t0 = time.time()
        while not os.path.exists(first) and feeder.poll() is None \
                and time.time() - t0 < 120:
            time.sleep(0.01)
        buf = io.StringIO()
        tps_cuda.reset_launch_counts()
        # the host time of the runner's PNG decode and of the frame step's
        # call (which queues the frame's work), per frame
        split = {"decode": [], "process": []}
        orig_load = run_live._load_png_pair
        orig_process = SupersurfelFusion.process

        def timed(name, fn):
            def call(*a, **kw):
                t1 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    split[name].append(time.perf_counter() - t1)
            return call

        run_live._load_png_pair = timed("decode", orig_load)
        SupersurfelFusion.process = timed("process", orig_process)
        try:
            with contextlib.redirect_stdout(buf):
                rc = run_live.main(["--watch", watch2, "--out",
                                    os.path.join(tmp, "live2.txt"),
                                    "--idle-timeout", str(LIVE_IDLE_S),
                                    "--quiet"])
        finally:
            run_live._load_png_pair = orig_load
            SupersurfelFusion.process = orig_process
            try:
                feeder.wait(timeout=60)
            finally:
                if feeder.poll() is None:
                    feeder.kill()
                    feeder.wait()
        for k, v in tps_cuda.launch_counts.items():
            launches[k] += v
        res2 = json.loads(buf.getvalue().strip().splitlines()[-1])
        dec = np.median(split["decode"][1:]) * 1e3
        proc = np.median(split["process"][1:]) * 1e3
        log(f"  live runner without the line watcher: {res2['fps']:.2f} fps "
            f"({res2['frames']} frames; {1e3 / max(res2['fps'], 1e-9):.1f} "
            f"ms per frame: PNG decode median {dec:.1f} ms, the frame "
            f"step's call {proc:.1f} ms, the rest (the pose read, which "
            f"waits for the card, the line, the directory scan))")
        check(rc == 0 and res2["frames"] == LIVE_FRAMES,
              "live runner, second feed: every frame")
        check(rc_off == 0 and d < LIVE_POSE_MAX,
              f"live poses within {LIVE_POSE_MAX * 1e3:.0f} mm of the "
              f"offline runner's")

        lines = "".join(
            f"{os.path.join(seq, 'rgb', f'{ts:.6f}.png')} "
            f"{os.path.join(seq, 'depth', f'{ts:.6f}.png')} {ts:.6f}\n"
            for ts in stamps[:LIVE_STDIN_FRAMES])
        stdin_out = os.path.join(tmp, "stdin.txt")
        old_stdin, buf = sys.stdin, io.StringIO()
        sys.stdin = io.StringIO(lines)
        tps_cuda.reset_launch_counts()
        try:
            with contextlib.redirect_stdout(buf):
                rc = run_live.main(["--stdin", "--out", stdin_out,
                                    "--quiet"])
        finally:
            sys.stdin = old_stdin
        for k, v in tps_cuda.launch_counts.items():
            launches[k] += v
        got = read_trajectory_file(stdin_out)
        check(rc == 0 and sorted(got) == stamps[:LIVE_STDIN_FRAMES]
              and json.loads(buf.getvalue().strip().splitlines()[-1])
              ["frames"] == LIVE_STDIN_FRAMES,
              f"--stdin: {LIVE_STDIN_FRAMES} frames, one pose line each")
    check(launches == {"tps_iteration": 4 * 20, "tps_merge": 4 * 24},
          "live phase: each of the 4 runs calls the TPS launchers on its "
          "first two frames alone (the stages replay as CUDA graphs after)")
    return launches, {
        "fps": res["fps"], "fps_unwatched": res2["fps"],
        "decode_ms": float(dec), "process_ms": float(proc),
        "fps_offline": off_fps,
        "lat_median_ms": float(np.median(lat) * 1e3),
        "lat_max_ms": float(lat.max() * 1e3), "backlog_max": max(backlog),
        "vs_offline_m": d}


def _agree(out, state, mesh) -> bool:
    """Whether every rank holds the same pose bits and counts."""
    import torch

    from supersurfel_fusion_tpu_torch.parallel.mesh import all_gather

    bits = torch.cat([out.pose.R.reshape(-1), out.pose.t]).contiguous() \
        .view(torch.int32)
    cnt = torch.stack([out.nb_total, state.kf_store.db.count, state.lc_count,
                       state.nb_visible_total]).to(torch.int32)
    rows = all_gather(torch.cat([bits, cnt]), mesh)
    return bool((rows == rows[:1]).all())


def _sharded_rank(mesh, n_mod_frames: int) -> dict:
    """One rank of a sharded phase: the loop-closure configuration over
    the revisit clip, then a few frames of the fr3 MOD configuration on
    the dynamic clip. Per frame: the pose, totals, flags, ms (host clock
    around the step, synced), the step's collectives and bytes, and
    whether all ranks agree bit for bit. Then the host waits of an
    ordinary and of the closure frame, replayed from their states."""
    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.parallel.pipeline_sharded import (
        init_sharded_state,
        make_process_frame_sharded,
    )
    from supersurfel_fusion_tpu_torch.tools.profile_frame import (
        host_syncs,
        lc_config,
        mod_config,
    )

    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run(cfg, clip, keep_gate):
        t1 = time.time()
        state = init_sharded_state(cfg, mesh)
        step = make_process_frame_sharded(mesh, cfg)
        sync()
        init_s = time.time() - t1
        recs, kept, prev = [], {}, None
        for k, fr in enumerate(clip):
            before = state
            mesh.reset_counts()
            t1 = time.time()
            state, out = step(state, fr[0], fr[1])
            sync()
            ms = (time.time() - t1) * 1e3
            coll = dict(mesh.counts)
            recs.append({
                "R": out.pose.R.cpu().numpy(), "t": out.pose.t.cpu().numpy(),
                "nb_total": int(out.nb_total),
                "icp_valid": bool(out.icp_valid),
                "gate": bool(out.lc_gate), "accepted": bool(out.lc_accepted)
                if out.lc_accepted is not None else False, "ms": ms,
                "collectives": coll["collectives"], "bytes": coll["bytes"],
                "coll_ms": coll["seconds"] * 1e3,
                "agree": _agree(out, state, mesh)})
            if keep_gate and out.lc_gate and not kept:
                kept = {k: before, k - 1: prev}
            prev = before
        return state, step, recs, kept, init_s

    cfg = lc_config()
    clip = synthetic.revisit_frames(cfg.cam)
    tps_cuda.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state, step, recs, kept, init_s = run(cfg, clip, True)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = dict(tps_cuda.launch_counts)
    waits = {}
    for name, k in (("ordinary", min(kept) if kept else None),
                    ("closure", max(kept) if kept else None)):
        if k is not None and cuda:
            w = host_syncs(lambda: step(kept[k], clip[k][0], clip[k][1]))
            waits[name] = sum(c for _, c in w)
            waits[name + "_where"] = w
    # the replays above are not counted: the MOD frames' launches are
    mcfg = mod_config()
    mclip = synthetic.dynamic_frames(mcfg.cam, n_mod_frames)
    tps_cuda.reset_launch_counts()
    _, _, mrecs, _, _ = run(mcfg, mclip, False)
    for k, v in tps_cuda.launch_counts.items():
        launches[k] += v
    return {"lc": recs, "mod": mrecs, "keyframes": int(state.kf_store.db
                                                       .count),
            "nb_local": int(state.model.nb_local), "peak": peak,
            "init_s": init_s, "waits": waits, "launches": launches,
            "backend": mesh.backend}


def sharded_phase(d: int, backend: str, single_traj):
    """The sharded frame step on `d` ranks over `backend`, each rank its
    own process on the card, on the loop-closure phase's clip and limits;
    its poses against the single-device phase's of the same call."""
    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.eval.trajectory import quat_to_mat_np
    from supersurfel_fusion_tpu_torch.parallel.distributed import launch

    t0 = time.time()
    ranks = launch(_sharded_rank, d, backend, "cuda",
                   args=(SHARD_MOD_FRAMES,), threads=0, timeout_s=BUDGET_S)
    log(f"  {d} rank(s) over {backend}: {time.time() - t0:.1f} s (spawn, "
        f"start-up and both clips)")
    r0 = ranks[0]
    recs = r0["lc"]
    n = len(recs)
    traj = np.array([np.concatenate([r["t"], r["R"].reshape(-1)])
                     for r in recs])
    err = synthetic.translation_errors(
        np.array([r["t"] for r in recs]), synthetic.revisit_trajectory())
    gates = [k for k, r in enumerate(recs) if r["gate"]]
    accepted = [k for k, r in enumerate(recs) if r["accepted"]]
    icp = np.mean([r["icp_valid"] for r in recs[1:]])
    agree = all(r["agree"] for rk in ranks for r in rk["lc"] + rk["mod"])
    dt = np.linalg.norm(traj[:, :3] - single_traj[:, :3], axis=1)
    # the single-device phase's rows are TUM rows (t, quaternion)
    dR = np.array([np.linalg.norm(r["R"] - quat_to_mat_np(row[3:7]))
                   for r, row in zip(recs, single_traj)])
    ordinary = [r["ms"] for k, r in enumerate(recs)
                if k >= 2 and k not in gates]
    coll_o = [r["collectives"] for k, r in enumerate(recs)
              if k >= 1 and k not in gates]
    bytes_o = [r["bytes"] for k, r in enumerate(recs)
               if k >= 1 and k not in gates]
    coll_ms = [r["coll_ms"] for k, r in enumerate(recs)
               if k >= 2 and k not in gates]
    kc = accepted[0] if accepted else None
    log(f"  keyframes {r0['keyframes']}, gate fired on {gates}, accepted on "
        f"{accepted}; max error {err.max():.4f} m" + (
            f", at the closure {err[kc]:.4f} m" if kc is not None else "")
        + f"; ICP valid {icp:.3f}; local counts "
        f"{[rk['nb_local'] for rk in ranks]}, total {recs[-1]['nb_total']}")
    log(f"  vs the single-device step: max |dt| {dt.max():.4f} m, max "
        f"|dR|_F {dR.max():.4f}")
    log(f"  ms/frame: ordinary median {np.median(ordinary):.2f} mean "
        f"{np.mean(ordinary):.2f}; closure frame "
        + (f"{recs[kc]['ms']:.2f}" if kc is not None else "none")
        + f"; start-up {r0['init_s']:.2f} s; per rank peak memory "
        f"{[round(rk['peak'] / 2**20, 1) for rk in ranks]} MiB")
    log(f"  collectives per ordinary frame {sorted(set(coll_o))} "
        f"({int(np.median(bytes_o))} B; host time in them median "
        f"{np.median(coll_ms):.2f} ms, max {np.max(coll_ms):.2f} ms per "
        f"frame); closure frame "
        + (f"{recs[kc]['collectives']} ({recs[kc]['bytes']} B)"
           if kc is not None else "none")
        + f"; host waits (sync report, rank 0) {r0['waits']}")
    log(f"  fr3 MOD, {SHARD_MOD_FRAMES} frames: ms "
        f"{[round(r['ms'], 1) for r in r0['mod']]}, collectives "
        f"{[r['collectives'] for r in r0['mod']]}, t "
        f"{np.round(r0['mod'][-1]['t'], 4).tolist()}")
    check(agree, f"the {d} rank(s) agree bit for bit on the pose and the "
          "counts on every frame")
    check(r0["keyframes"] >= LC_KEYFRAMES_MIN,
          f"at least {LC_KEYFRAMES_MIN} keyframes")
    check(kc == SHARD_CLOSURE_FRAME,
          f"the closure accepted on frame {SHARD_CLOSURE_FRAME}")
    check(bool(np.isfinite(traj).all())
          and all(np.isfinite(r["t"]).all() for r in r0["mod"]),
          "poses finite")
    check(err[kc] < LC_CLOSURE_ERR_MAX,
          f"error at the closure frame < {LC_CLOSURE_ERR_MAX} m")
    check(err.max() < LC_DRIFT_MAX,
          f"drift against the known trajectory < {LC_DRIFT_MAX} m")
    check(icp >= LC_ICP_MIN,
          f"ICP valid on >= {LC_ICP_MIN:.0%} of frames after the first")
    check(dt.max() < SHARD_POSE_MAX and dR.max() < SHARD_ROT_MAX,
          f"poses within {SHARD_POSE_MAX} m / {SHARD_ROT_MAX} of the "
          "single-device step")
    check(sum(rk["nb_local"] for rk in ranks) == recs[-1]["nb_total"],
          "the ranks' local counts add up to the total")
    launches = {k: sum(rk["launches"][k] for rk in ranks)
                for k in r0["launches"]}
    n_mod = SHARD_MOD_FRAMES
    check(all(rk["launches"]["tps_iteration"] == 10 * (n + n_mod)
              and rk["launches"]["tps_merge"] == 12 * (n + n_mod)
              for rk in ranks),
          "every rank: 10 tps_iteration and 12 tps_merge launches per frame")
    return launches, {
        "traj": traj, "keyframes": r0["keyframes"], "gates": gates,
        "accepted": accepted, "ms_ordinary": float(np.median(ordinary)),
        "ms_closure": recs[kc]["ms"], "max_err": float(err.max()),
        "closure_err": float(err[kc]), "collectives": sorted(set(coll_o)),
        "closure_collectives": recs[kc]["collectives"],
        "peak_mib": [rk["peak"] / 2**20 for rk in ranks],
        "waits": r0["waits"], "dt_single": float(dt.max()),
        "coll_ms": float(np.median(coll_ms))}


def _inverted(clip):
    """The static clip's frames as (rgb, depth), the third with inverted
    colours: the geometry is unchanged, but no ICP correspondence passes
    the colour gate."""
    out = [(rgb, depth) for rgb, depth, _ in clip]
    out[2] = (255 - out[2][0], out[2][1])
    return out


def options_phase(dev):
    """The three default-off options through `SupersurfelFusion` on the
    card against the plain CPU path: the fusion options on a frame whose
    ICP is gate-rejected, temporal heat on the MOD configuration."""
    import dataclasses

    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.config import (
        FusionConfig,
        PipelineConfig,
    )
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion
    from supersurfel_fusion_tpu_torch.tools.profile_frame import mod_config

    static = _inverted(synthetic.frames(PipelineConfig().cam, OPT_FRAMES))
    mcfg = mod_config()
    mcfg = dataclasses.replace(mcfg, mod=dataclasses.replace(
        mcfg.mod, temporal_heat=True))
    dynamic = [(rgb, depth) for rgb, depth, _, _ in
               synthetic.dynamic_frames(mcfg.cam, OPT_FRAMES)]
    cases = {
        "freeze": (PipelineConfig(fusion=FusionConfig(
            freeze_on_tracking_loss=True)), static),
        "gate": (PipelineConfig(fusion=FusionConfig(
            insert_requires_icp=True)), static),
        "heat": (mcfg, dynamic),
    }
    launches = {k: 0 for k in tps_cuda.launch_counts}
    summary = {}
    for name, (cfg, clip) in cases.items():
        runs = {}
        for where in (dev, "cpu"):
            slam = SupersurfelFusion(cfg, device=where)
            if where != "cpu":
                torch.cuda.synchronize()
                tps_cuda.reset_launch_counts()
            outs, nbs = [], []
            for k, (rgb, depth) in enumerate(clip):
                outs.append(slam.process(rgb, depth, timestamp=float(k)))
                nbs.append(int(slam.state.model.nb_supersurfels))
            if where != "cpu":
                for k, v in tps_cuda.launch_counts.items():
                    launches[k] += v
            runs[str(where)] = (np.array(slam.trajectory), outs, nbs,
                                slam.state)
        (tg, og, ng, sg), (tc, oc, nc, sc) = runs[str(dev)], runs["cpu"]
        dt = np.abs(tg[:, :3] - tc[:, :3]).max()
        icp = [(bool(a.icp_valid), bool(b.icp_valid)) for a, b in zip(og, oc)]
        log(f"  {name}: nb_supersurfels card {ng}, CPU {nc}; icp valid "
            f"(card, CPU) {icp}; inserted on the last frame card "
            f"{int(og[-1].n_inserted)}, CPU {int(oc[-1].n_inserted)}; max "
            f"|dt| {dt:.2e} m")
        check(bool(np.isfinite(tg).all()) and dt < OPT_POSE_MAX,
              f"{name}: card agrees with the plain CPU path (|dt| < 2 mm)")
        if name == "heat":
            agree = float(np.mean([
                (a.static_sp.cpu() == b.static_sp).float().mean().item()
                for a, b in zip(og, oc)]))
            hg, hc = sg.mod_prev.heat.cpu(), sc.mod_prev.heat
            herr = (hg - hc).abs().max().item()
            log(f"  heat: static_sp agreement {agree:.4f}, heat max "
                f"{hg.max().item():.3f}, card vs CPU max |diff| {herr:.2e}")
            check(agree >= MOTION_SP_AGREE and bool(torch.isfinite(hg).all()),
                  "heat: MOD decisions agree with the CPU and the heat is "
                  "finite")
            summary[name] = {"agree": agree, "heat_err": herr,
                             "heat_max": hg.max().item(), "dt": float(dt)}
            continue
        for o, n in ((og, ng), (oc, nc)):
            rejected = not bool(o[-1].icp_valid) and bool(o[1].icp_valid)
            check(rejected and int(o[-1].n_inserted) == 0,
                  f"{name}: ICP rejects the inverted frame and nothing is "
                  "inserted")
            if name == "freeze":
                check(n[-1] == n[-2] and int(o[-1].n_fused) == 0,
                      "freeze: the model is kept on the rejected frame")
        summary[name] = {"nb": ng, "dt": float(dt)}
    return launches, summary


def nb_samples_phase(dev):
    """The default frame step with a 32-hypothesis RANSAC plane table
    (drawn as JAX's `jax.random.uniform(PRNGKey(1234), (32, 3, 2))`)
    through `SupersurfelFusion` on the card against the plain CPU path."""
    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.config import PipelineConfig, TPSConfig
    from supersurfel_fusion_tpu_torch.ops import tps, tps_cuda
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion

    cfg = PipelineConfig(tps=TPSConfig(nb_samples=NB_SAMPLES))
    cs = cfg.tps.cell_size
    clip = synthetic.frames(cfg.cam, NB_FRAMES)
    drawn = []
    draw = tps.ransac_offsets

    def spy(cell, n):
        drawn.append(n)
        return draw(cell, n)

    tps.ransac_offsets = spy
    runs = {}
    try:
        for where in (dev, "cpu"):
            slam = SupersurfelFusion(cfg, device=where)
            if where != "cpu":
                torch.cuda.synchronize()
                tps_cuda.reset_launch_counts()
            t0 = time.time()
            outs = [slam.process(rgb, depth, timestamp=float(k))
                    for k, (rgb, depth, _) in enumerate(clip)]
            if where != "cpu":
                torch.cuda.synchronize()
                launches = dict(tps_cuda.launch_counts)
            runs[str(where)] = (np.array(slam.trajectory), outs,
                                time.time() - t0)
    finally:
        tps.ransac_offsets = draw
    offs = draw(cs, NB_SAMPLES)
    (tg, og, sg), (tc, oc, sc) = runs[str(dev)], runs["cpu"]
    dt = float(np.abs(tg[:, :3] - tc[:, :3]).max())
    gt = synthetic.trajectory(NB_FRAMES)
    err = np.linalg.norm(tg[:, :3] - np.array([t for _, t in gt]), axis=1)
    icp = [(bool(a.icp_valid), bool(b.icp_valid)) for a, b in zip(og, oc)]
    log(f"  nb_samples {NB_SAMPLES}: tables drawn {drawn}, offsets in "
        f"[{offs.min():.4f}, {offs.max():.4f}]; launches {launches}; card "
        f"{sg:.2f} s, CPU {sc:.2f} s for {NB_FRAMES} frames; icp valid "
        f"(card, CPU) {icp}; max |dt| card vs CPU {dt:.2e} m, error vs the "
        f"known trajectory {err.max():.4f} m")
    check(offs.shape == (NB_SAMPLES, 3, 2) and drawn == [NB_SAMPLES] * 2
          and offs.min() >= -cs / 2 and offs.max() < cs / 2,
          f"nb_samples: the plane init reads a {NB_SAMPLES}-row table on "
          f"both devices")
    check(launches == {"tps_iteration": 20, "tps_merge": 24},
          "nb_samples: TPS launchers called on the first two frames alone")
    check(bool(np.isfinite(tg).all()) and dt < NB_POSE_MAX,
          "nb_samples: card agrees with the plain CPU path (|dt| < 2 mm)")
    return launches, {"dt": dt, "err_max": float(err.max())}


def _mover_rect(cam, pose, k):
    """The mover's image rectangle at frame k: its box corners
    (`synthetic.box_bounds`) projected through the camera pose."""
    from supersurfel_fusion_tpu_torch import synthetic

    R, t = pose
    lo, hi = synthetic.box_bounds(k)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    pc = (corners - t) @ R           # world -> camera (R maps camera to world)
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    return (max(u.min(), 0.0), max(v.min(), 0.0),
            min(u.max(), cam.width), min(v.max(), cam.height))


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-9)


def collect_phase(dev):
    """The trainer's `--collect` on the card over the dynamic clip written
    as a TUM sequence: the label file's layout, and its boxes against the
    mover's known image rectangle."""
    import tempfile

    import torch

    from supersurfel_fusion_tpu_torch import synthetic
    from supersurfel_fusion_tpu_torch.config import CameraIntrinsics
    from supersurfel_fusion_tpu_torch.ops import tps_cuda
    from supersurfel_fusion_tpu_torch.tools import train_person_detector

    cam = CameraIntrinsics.tum_fr3()
    clip = synthetic.dynamic_frames(cam, COLLECT_FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "rgbd_dataset_freiburg3_synthetic")
        synthetic.write_tum_sequence(seq, [c[:3] for c in clip])
        out = os.path.join(tmp, "labels.npz")
        torch.cuda.synchronize()
        tps_cuda.reset_launch_counts()
        t0 = time.time()
        rc = train_person_detector.main(["--collect", "--dataset", seq,
                                         "--out", out])
        wall = time.time() - t0
        launches = dict(tps_cuda.launch_counts)
        with np.load(out) as lab:
            gray, depth = lab["gray"], lab["depth"]
            boxes, counts = lab["boxes"], lab["counts"]
            start, end = int(lab["start"]), int(lab["end"])
    n = COLLECT_FRAMES - 2
    log(f"  collect: rc {rc} in {wall:.1f} s, {len(counts)} frames, "
        f"{int(counts.sum())} boxes, launches {launches}")
    check(rc == 0 and gray.shape == (n, cam.height, cam.width)
          and gray.dtype == np.uint8 and depth.dtype == np.uint16
          and (start, end) == (0, COLLECT_FRAMES) and len(counts) == n,
          "collect: the label file's layout (frames 2.. of the sequence)")
    check(launches == {"tps_iteration": 20, "tps_merge": 24},
          "collect: TPS launchers called on the first two frames alone")
    hits, per_frame = 0, []
    for i in range(n):
        k = i + 2
        rect = _mover_rect(cam, clip[k][2], k)
        bs = boxes[i, :counts[i]]
        best = max((_iou(b, rect) for b in bs), default=0.0)
        hits += best > 0.3
        per_frame.append(int(counts[i]))
    log(f"  collect: boxes per frame {per_frame}; frames with a box hitting "
        f"the mover (IoU > 0.3): {hits}/{n}")
    check(bool(np.isfinite(boxes).all()) and bool(
        (boxes[..., 2:] <= np.array([cam.width, cam.height])).all()),
          "collect: boxes finite and inside the image")
    check(hits >= COLLECT_HIT_SHARE * n,
          f"collect: a box hits the mover on >= {COLLECT_HIT_SHARE:.0%} of "
          "the labelled frames")
    return launches, {"hits": hits, "frames": n, "boxes": int(counts.sum()),
                      "wall_s": wall}


def training_phase(dev):
    """The trainer on the card at full width: the first steps against the
    plain CPU path, then the committed weights' own command through
    `train`, timed, evaluated against the committed weights on the
    held-out labels. Returns the trained checkpoint's path (in `tmp`)."""
    import tempfile

    import torch

    from supersurfel_fusion_tpu_torch.convert import to_params
    from supersurfel_fusion_tpu_torch.models.person_detector import (
        init_params,
        load_detector,
    )
    from supersurfel_fusion_tpu_torch.tools import train_person_detector as tt

    t0 = time.time()
    g, d, b, c, _ = tt.load_labels(TRAIN_DATA)
    log(f"  labels: {len(c)} frames {g.shape[1]}x{g.shape[2]}, "
        f"{int(c.sum())} boxes, loaded in {time.time() - t0:.2f} s")

    # the card against the plain CPU path from JAX's initial weights
    init = init_params()
    n_steps = tt.schedule_steps(len(c), TRAIN_BATCH, TRAIN_EPOCHS)
    first = {}
    torch.backends.cudnn.deterministic = True
    for where in ("cpu", dev):
        trainer = tt.Trainer(init, n_steps, TRAIN_LR, where)
        labels = tt.prepare(g, d, b, c, where)
        r = tt.fit(trainer, labels, c, TRAIN_BATCH, 1, False,
                   max_steps=TRAIN_CPU_STEPS)
        first[str(where)] = (np.array(r["step_loss"]),
                             to_params(trainer.det))
        del trainer, labels
    torch.backends.cudnn.deterministic = False
    (lc, pc), (lg, pg) = first["cpu"], first[str(dev)]
    lerr = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    perr = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc)
    log(f"  first {TRAIN_CPU_STEPS} steps: losses card {lg.tolist()}, CPU "
        f"{lc.tolist()}; max relative |diff| {lerr:.2e}, weights max "
        f"|diff| {perr:.2e}")
    check(lerr <= TRAIN_LOSS_RTOL and perr <= TRAIN_PARAM_ATOL,
          f"training: card agrees with the plain CPU path over the first "
          f"{TRAIN_CPU_STEPS} steps")
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "person_detector_card.npz")
    args = tt.parse_args(["--train", "--data", TRAIN_DATA, "--eval-data",
                          EVAL_DATA, "--out", out, "--epochs",
                          str(TRAIN_EPOCHS), "--batch", str(TRAIN_BATCH),
                          "--lr", str(TRAIN_LR)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = tt.train(args, timing=True)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = np.array(res["step_ms"])
    steps = len(ms)
    losses = res["epoch_loss"]
    log(f"  {len(losses)} epochs, {steps} steps ({res['n_steps']} in the "
        f"schedule): ms/step median {np.median(ms):.3f}, p90 "
        f"{np.percentile(ms, 90):.3f}, mean {ms.mean():.3f}; "
        f"{1e3 / ms.mean():.1f} steps/s, {TRAIN_BATCH * 1e3 / ms.mean():.1f}"
        f" frames/s; epochs {res['train_s']:.2f} s, whole command "
        f"{wall:.2f} s; peak memory {peak / 2**20:.1f} MiB")
    log(f"  epoch losses {[round(x, 4) for x in losses]}")
    committed = load_detector(COMMITTED_WEIGHTS, dev)
    eg, ed, eb, ec, _ = tt.load_labels(EVAL_DATA)
    ref = tt._eval_boxes(committed, "committed weights, HELD-OUT", eg, ed, eb,
                         ec)
    held = res["eval"]["held_out"]
    check(steps == TRAIN_EPOCHS * res["steps_per_epoch"]
          and len(losses) == TRAIN_EPOCHS, f"training: {TRAIN_EPOCHS} whole "
          f"epochs ({steps} steps)")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          "training: the last epoch's loss below the first's")
    lo, hi = TRAIN_FINAL_LOSS
    check(lo <= losses[-1] <= hi, f"training: the last epoch's loss "
          f"{losses[-1]:.4f} in [{lo}, {hi}] (CPU reference runs)")
    return out, {
        "ms_median": float(np.median(ms)),
        "ms_p90": float(np.percentile(ms, 90)),
        "steps_per_s": float(1e3 / ms.mean()),
        "frames_per_s": float(TRAIN_BATCH * 1e3 / ms.mean()),
        "epochs_s": res["train_s"], "wall_s": wall, "peak_mib": peak / 2**20,
        "epoch_loss": losses, "held_out": held._asdict(),
        "committed": ref._asdict(), "first_loss_err": lerr,
        "first_param_err": perr}


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

    t0 = time.time()
    detector_phase(dev)
    phase_done("detector", t0)

    t0 = time.time()
    motion_phase(dev)
    phase_done("motion", t0)

    t0 = time.time()
    mod_launches, mod = mod_pipeline_phase(dev)
    phase_done("MOD pipeline", t0)

    t0 = time.time()
    lc_launches, lc = lc_pipeline_phase(dev)
    phase_done("loop-closure pipeline", t0)

    t0 = time.time()
    run_launches, runner = runner_phase(dev)
    phase_done("runner", t0)

    t0 = time.time()
    live_launches, live = live_phase(dev)
    phase_done("live runner", t0)

    t0 = time.time()
    sh1_launches, sh1 = sharded_phase(1, "nccl", lc["traj"])
    phase_done("sharded, 1 rank (NCCL)", t0)

    t0 = time.time()
    sh2_launches, sh2 = sharded_phase(2, "gloo", lc["traj"])
    phase_done("sharded, 2 ranks on one card (gloo)", t0)
    d12 = np.abs(sh1["traj"][:, :3] - sh2["traj"][:, :3]).max()
    log(f"  D=2 vs D=1: keyframes {sh2['keyframes']} vs {sh1['keyframes']}, "
        f"closure frame {sh2['accepted'][0]} vs {sh1['accepted'][0]}, max "
        f"|dt| {d12:.2e} m")
    check(sh2["keyframes"] == sh1["keyframes"]
          and sh2["accepted"][0] == sh1["accepted"][0],
          "D=2 stores the keyframes and accepts the closure as D=1")

    t0 = time.time()
    opt_launches, opt = options_phase(dev)
    phase_done("options", t0)

    t0 = time.time()
    nb_launches, nbs = nb_samples_phase(dev)
    phase_done(f"nb_samples={NB_SAMPLES}", t0)

    t0 = time.time()
    col_launches, col = collect_phase(dev)
    phase_done("collect", t0)

    t0 = time.time()
    trained, tr = training_phase(dev)
    phase_done("training", t0)

    t0 = time.time()
    detector_phase(dev, weights=trained)
    shutil.rmtree(os.path.dirname(trained))
    phase_done("detector with the card-trained weights", t0)

    rows = []
    for name in ("tps_iteration", "tps_merge"):
        r = kern[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "supersurfel_fusion_tpu_torch/csrc/tps.cu",
            "replaces": "supersurfel_fusion_tpu/ops/tps_pallas.py:381",
            # every pipeline phase: the default, MOD and loop-closure
            # frame steps, the runner's and the live runner's runs, the
            # sharded steps, the options, nb_samples and collect phases
            "launches": (launches[name] + mod_launches[name]
                         + lc_launches[name] + run_launches[name]
                         + live_launches[name] + sh1_launches[name]
                         + sh2_launches[name] + opt_launches[name]
                         + nb_launches[name] + col_launches[name]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(f"pipeline: {ms_frame:.2f} ms/frame steady, peak "
        f"{peak / 2**20:.1f} MiB; MOD pipeline: {mod['ms_steady']:.2f} "
        f"ms/frame steady, peak {mod['peak_mib']:.1f} MiB; loop closure: "
        f"{lc['ms_ordinary']:.2f} ms/frame ordinary, closure frame "
        f"{lc['ms_closure']:.2f} ms, peak {lc['peak_mib']:.1f} MiB; runner "
        f"native loader {runner['fps']:.2f} fps (decode "
        f"{runner['decode_native_ms']:.2f} ms per pair, PIL "
        f"{runner['decode_pil_ms']:.2f}); live {live['fps']:.2f} fps, "
        f"latency median "
        f"{live['lat_median_ms']:.0f} ms, backlog {live['backlog_max']}; "
        f"sharded D=1 {sh1['ms_ordinary']:.2f} ms/frame (closure "
        f"{sh1['ms_closure']:.2f}), D=2 {sh2['ms_ordinary']:.2f} (closure "
        f"{sh2['ms_closure']:.2f}); collect {col['hits']}/{col['frames']} "
        f"frames hit the mover; training {tr['ms_median']:.3f} ms/step "
        f"median, {tr['frames_per_s']:.0f} frames/s, {tr['epochs_s']:.1f} s "
        f"for {TRAIN_EPOCHS} epochs, last epoch loss "
        f"{tr['epoch_loss'][-1]:.4f}, held-out recall "
        f"{tr['held_out']['recall']:.3f} precision "
        f"{tr['held_out']['precision']:.3f} (committed weights "
        f"{tr['committed']['recall']:.3f} / "
        f"{tr['committed']['precision']:.3f}); total "
        f"{time.time() - _T0:.1f} s")
    log("training " + json.dumps(tr))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

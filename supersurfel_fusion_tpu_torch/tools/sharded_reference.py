"""The sharded frame step on the CPU against the single-device step: the
640x480 revisit clip with loop closure (the configuration of
`chip_smoke.py`'s sharded phases), free-running at each rank count over
gloo, and the single-device `SupersurfelFusion` on the same frames.
Prints one JSON object: per rank count the largest pose differences from
the single-device step (translation in m, rotation as the Frobenius norm
of R - R1), the error against the known trajectory, the gate and
closure frames, the keyframes, and whether the ranks agreed bit for bit.

  python -m supersurfel_fusion_tpu_torch.tools.sharded_reference \\
      [--ranks 2 1] [--frames N] [--threads 4]

CPU times are not device figures; this sets and checks the limits the
card's runs are held to.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from supersurfel_fusion_tpu_torch import synthetic


def _run_rank(mesh, cfg, frames):
    """One rank: the sharded step over `frames` from an empty state."""
    from supersurfel_fusion_tpu_torch.parallel.pipeline_sharded import (
        init_sharded_state,
        make_process_frame_sharded,
    )

    state = init_sharded_state(cfg, mesh)
    step = make_process_frame_sharded(mesh, cfg)
    out = []
    for rgb, depth in frames:
        state, o = step(state, rgb, depth)
        out.append((o.pose.R.numpy().copy(), o.pose.t.numpy().copy(),
                    bool(o.lc_gate), bool(o.lc_accepted)))
    return {"frames": out, "keyframes": int(state.kf_store.db.count),
            "nb_total": int(o.nb_total)}


def main(argv=None) -> int:
    from supersurfel_fusion_tpu_torch.parallel.distributed import launch
    from supersurfel_fusion_tpu_torch.pipeline import SupersurfelFusion
    from supersurfel_fusion_tpu_torch.tools.profile_frame import lc_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 1])
    ap.add_argument("--frames", type=int, default=0,
                    help="the first N frames of the clip (0: all 33)")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    cfg = lc_config()
    clip = synthetic.revisit_frames(cfg.cam)
    if args.frames:
        clip = clip[:args.frames]
    frames = [(rgb, depth) for rgb, depth, _ in clip]
    gt = synthetic.revisit_trajectory()[:len(frames)]
    torch.set_num_threads(args.threads)
    slam = SupersurfelFusion(cfg, device="cpu")
    single = []
    for k, (rgb, depth) in enumerate(frames):
        o = slam.process(rgb, depth, float(k))
        single.append((o.pose.R.numpy().copy(), o.pose.t.numpy().copy()))
    report = {"single": {
        "max_err": float(max(np.linalg.norm(t - g[1])
                             for (_, t), g in zip(single, gt))),
        "keyframes": int(slam.state.kf_store.db.count)}}
    for d in args.ranks:
        ranks = launch(_run_rank, d, "gloo", "cpu", args=(cfg, frames),
                       threads=args.threads, timeout_s=7200)
        fr = ranks[0]["frames"]
        report[f"D={d}"] = {
            "max_dt": float(max(np.linalg.norm(f[1] - s[1])
                                for f, s in zip(fr, single))),
            "max_dR": float(max(np.linalg.norm(f[0] - s[0])
                                for f, s in zip(fr, single))),
            "max_err": float(max(np.linalg.norm(f[1] - g[1])
                                 for f, g in zip(fr, gt))),
            "gates": [k for k, f in enumerate(fr) if f[2]],
            "accepted": [k for k, f in enumerate(fr) if f[3]],
            "err_at_closure": [float(np.linalg.norm(f[1] - g[1]))
                               for f, g in zip(fr, gt) if f[3]],
            "keyframes": ranks[0]["keyframes"],
            "nb_total": ranks[0]["nb_total"],
            "ranks_bit_equal": all(
                np.array_equal(r["frames"][k][0], fr[k][0])
                and np.array_equal(r["frames"][k][1], fr[k][1])
                for r in ranks for k in range(len(fr)))}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

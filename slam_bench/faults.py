"""Faults planted in the program's timed path, to show that the comparison
with the reference catches them (`tests/test_bench_faults.py` on the CPU,
`calibrate.py --fault` at a cell's own size on the card).

Each fault patches a function of the program's modules while the block
runs; the reference (`slam_bench/reference`) imports nothing of the
program and runs unchanged. A cell's batch is one frame on one card, so
there is no half batch and no exchange between chips to leave out.
"""

from __future__ import annotations

from contextlib import contextmanager


def _state_unchanged(pipeline, ops):
    orig = pipeline.process_frame

    def step(state, rgb, depth, cfg):
        _, out = orig(state, rgb, depth, cfg)
        return state, out
    return pipeline, "process_frame", step


def _pose_altered(pipeline, ops):
    from supersurfel_fusion_tpu_torch.types import Pose

    orig = pipeline.process_frame

    def step(state, rgb, depth, cfg):
        # the pose moved by 3 mm per axis where the step produces it
        new, out = orig(state, rgb, depth, cfg)
        pose = Pose(out.pose.R, out.pose.t + 0.003)
        return new._replace(pose=pose), out._replace(pose=pose)
    return pipeline, "process_frame", step


def _labels_altered(pipeline, ops):
    import torch

    orig = pipeline._segment

    def segment(rgb, disp, cfg):
        # every superpixel shifted by 3 px, over the whole frame
        res = orig(rgb, disp, cfg)
        return res._replace(labels=torch.roll(res.labels, 3, 1))
    return pipeline, "_segment", segment


def _labels_patch(pipeline, ops):
    import torch

    orig = pipeline._segment

    def segment(rgb, disp, cfg):
        # the superpixels shifted by 3 px in one block of a sixteenth of
        # the frame, at its centre
        res = orig(rgb, disp, cfg)
        lab = res.labels.clone()
        h, w = lab.shape
        r0, r1, c0, c1 = 3 * h // 8, 5 * h // 8, 3 * w // 8, 5 * w // 8
        lab[r0:r1, c0:c1] = torch.roll(lab[r0:r1, c0:c1], 3, 1)
        return res._replace(labels=lab)
    return pipeline, "_segment", segment


def _mod_all_static(pipeline, ops):
    import torch

    orig = ops.motion.detect_motion

    def detect(*args, **kw):
        # MOD's decision dropped: every superpixel and keypoint static, so
        # a mover enters VO, ICP, the local map and the fused model
        is_static_sp, _, new_prev = orig(*args, **kw)
        kp = args[3] if len(args) > 3 else kw["kp"]
        return torch.ones_like(is_static_sp), kp.valid, new_prev
    return ops.motion, "detect_motion", detect


FAULTS = {
    "state_unchanged": _state_unchanged,
    "pose_altered": _pose_altered,
    "labels_altered": _labels_altered,
    "labels_patch": _labels_patch,
    "mod_all_static": _mod_all_static,
}
# faults that only a cell with MOD on can have
MOD_FAULTS = ("mod_all_static",)


@contextmanager
def planted(name: str):
    """The program with fault `name` planted while the block runs."""
    from supersurfel_fusion_tpu_torch import ops, pipeline
    from supersurfel_fusion_tpu_torch.ops import motion  # noqa: F401

    mod, attr, fn = FAULTS[name](pipeline, ops)
    old = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, old)

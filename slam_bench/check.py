"""The comparison that decides `correct`.

The frame step carries its state from frame to frame, and rounding moves a
free-running trajectory (the TPS route alone moves a 30-frame drift by
centimetres), so the reference follows the program one step at a time:
for each frame drawn for the check it takes the program's state before
that frame (the tensors; the person detector it loads itself from the
weights file), runs its own frame step on the same frame, and compares
what the program's step produced (`numbers`): the fused model, slot order
aside (`model_nn`, `model_far`: segmentation, supersurfels, MOD's
exclusions and fusion all end there), the pose after ICP, the VO local
map, the superpixel labels and MOD's static/dynamic decision for each
superpixel. The first frame is also run from the reference's own initial state,
which checks the start that following the program skips. (The second
frame is not compared: the first fusion into the bootstrapped model is
ill-conditioned, and the rounding of the TPS kernels' plane fits alone
moves most of its surfels by metres; PERF.md, Open questions.) A cell's
checks file names the numbers compared and their limits.

The reference is `slam_bench/reference`, a frozen copy of the port's
plain path that imports nothing of the program, run on the same device
after the measured window. Its independence from the program rests on
the repo's parity tests (`tests/test_torch_*.py`), which hold the port
the copy was taken from against the JAX package on the CPU: a fault of
that port which they miss, the reference shares. Its control
(`control`) is the same reference computed with TF32 on for matmuls and
cuDNN, the precision below the float32 the configurations state.

A configuration file may name another reference package under the
benchmark's folder with a top-level key "reference" (imported as
`slam_bench.<name>`, with the same `config.PipelineConfig`,
`pipeline.init_state` and `pipeline.process_frame`); such a package may
add numbers of its own (`numbers(p_out, p_post, r_out, r_post) ->
dict`), which are merged into the shared ones.
"""

from __future__ import annotations

import importlib
import math
import re
from contextlib import contextmanager

import numpy as np
import torch

Tensor = torch.Tensor
DEFAULT_REFERENCE = "reference"
# a package path under slam_bench/: dotted identifiers, nothing that leads
# out of the folder
PACKAGE = re.compile(r"^[A-Za-z_]\w*(\.[A-Za-z_]\w*)*$", re.ASCII)


def reference_package(cfg_doc: dict) -> str:
    """The module name of the reference package that a configuration
    document names (its top-level "reference", by default
    `slam_bench.reference`)."""
    name = cfg_doc.get("reference", DEFAULT_REFERENCE)
    if not isinstance(name, str) or not PACKAGE.match(name):
        raise ValueError(f"reference {name!r}: not a package name under "
                         f"slam_bench/")
    return f"slam_bench.{name}"


class StateMismatch(RuntimeError):
    """The program's state does not have the shape the reference needs."""


def adopt(tmpl, prog, path: str = "state"):
    """The reference's state with the program's tensors: walk the
    reference's template `tmpl` by field name, taking each tensor from the
    program's state `prog` (cloned). Fields that are not tensors or named
    tuples (the person detector) keep the reference's own."""
    if isinstance(tmpl, Tensor):
        if not isinstance(prog, Tensor) or prog.shape != tmpl.shape \
                or prog.dtype != tmpl.dtype:
            raise StateMismatch(
                f"{path}: the reference needs {tmpl.dtype} "
                f"{tuple(tmpl.shape)}, the program has "
                f"{getattr(prog, 'dtype', type(prog).__name__)} "
                f"{tuple(getattr(prog, 'shape', ()))}")
        return prog.detach().clone()
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        if prog is None:
            raise StateMismatch(f"{path}: missing in the program's state")
        return type(tmpl)(**{f: adopt(getattr(tmpl, f),
                                      getattr(prog, f, None), f"{path}.{f}")
                             for f in tmpl._fields})
    return tmpl


@contextmanager
def tf32(on: bool):
    """TF32 for matmuls and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _np(t) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _nn_dist(a: Tensor, b: Tensor, block: int = 256) -> Tensor:
    """For each row of a (N, 3), the distance to the nearest row of b
    (M, 3), in float64 from coordinate differences (no matmul)."""
    out = []
    for i in range(0, a.shape[0], block):
        d = ((a[i:i + block, None, :] - b[None, :, :]) ** 2).sum(-1)
        out.append(d.min(dim=1).values.sqrt())
    return torch.cat(out) if out else a.new_zeros((0,))


def model_gaps(p_pos: Tensor, r_pos: Tensor) -> tuple[float, float]:
    """How far the program's live surfels lie from the reference's, slot
    order aside, over each side's live surfels with a finite position and
    the distance to the other side's nearest one, the worse of the two
    sides: (the median distance (m), the share farther than 0.1 mm). The
    median passes over the surfels whose fused position is ill-conditioned
    and moves far on rounding (5-11% of them); the share counts them, and
    every surfel that a fault in one part of the frame moves."""
    a, b = p_pos.to(torch.float64), r_pos.to(torch.float64)
    a, b = a[torch.isfinite(a).all(-1)], b[torch.isfinite(b).all(-1)]
    if a.shape[0] == 0 or b.shape[0] == 0:
        same = a.shape[0] == b.shape[0]
        return (0.0, 0.0) if same else (math.inf, 1.0)
    med, far = 0.0, 0.0
    for d in (_nn_dist(a, b), _nn_dist(b, a)):
        med = max(med, float(d.median()))
        far = max(far, float((d > 1e-4).double().mean()))
    return med, far


def numbers(p_out, p_post, r_out, r_post) -> dict:
    """The numbers of one frame: the program's outputs and new state (p_*)
    against the reference's (r_*). Each but `dynamic_sp` is 0 where they
    agree and grows with the disagreement: `labels` the share of pixels
    whose superpixel differs, `static_sp` the share of superpixels whose
    MOD decision differs. The cells' checks files compare some of them;
    the rest are read to set those (`calibrate.py`)."""
    out = {"labels": float(np.mean(_np(p_out.labels) != _np(r_out.labels)))}
    dp, dr = _np(p_out.plane_depth), _np(r_out.plane_depth)
    fin = np.isfinite(dp) & np.isfinite(dr)
    gap = np.abs(np.where(fin, dp, 0.0) - np.where(fin, dr, 0.0))
    out["plane_depth"] = float(np.mean(
        (np.isfinite(dp) != np.isfinite(dr)) | (gap > 1e-4)))
    Rp, Rr = _np(p_out.pose.R), _np(r_out.pose.R)
    tp, tr = _np(p_out.pose.t), _np(r_out.pose.t)
    out["pose_t"] = float(np.linalg.norm(tp.astype(np.float64) - tr))
    out["pose_r"] = float(np.max(np.abs(Rp.astype(np.float64) - Rr)))
    sp, sr = p_post.model.surfels, r_post.model.surfels
    vp, vr = sp.confidences > 0, sr.confidences > 0
    out["model_count"] = float(abs(int(vp.sum()) - int(vr.sum())))
    out["model_nn"], out["model_far"] = model_gaps(sp.positions[vp],
                                                   sr.positions[vr])
    lp, lr = p_post.local_map, r_post.local_map
    lv = _np(lp.valid) | _np(lr.valid)
    ldiff = np.linalg.norm(_np(lp.positions).astype(np.float64)
                           - _np(lr.positions), axis=-1)
    out["local_map"] = float(np.max(np.where(
        lv, np.nan_to_num(ldiff, nan=np.inf), 0.0), initial=0.0))
    out["vo_matches"] = float(abs(int(_np(p_out.vo_matches))
                                  - int(_np(r_out.vo_matches))))
    out["static_sp"] = float(np.mean(_np(p_out.static_sp)
                                     != _np(r_out.static_sp)))
    # not a gap: how many superpixels MOD marks dynamic on the program's
    # side, to show that it flags the mover
    out["dynamic_sp"] = float((~_np(p_out.static_sp)).sum())
    return out


def _names(nums: dict) -> set:
    """The names that `aggregate` makes of a frame's numbers."""
    return set(nums) | {f"{k}_med" for k in nums}


class Reference:
    """The reference's frame step for one configuration document on one
    device: its own config, initial state (template) and detector, from
    the package that the document names (`reference_package`)."""

    def __init__(self, cfg_doc: dict, root, device):
        from slam_bench import manifest

        name = reference_package(cfg_doc)
        pkg = importlib.import_module(name)
        rconfig = importlib.import_module(f"{name}.config")
        rpipe = importlib.import_module(f"{name}.pipeline")
        self.name = name
        self.own_numbers = getattr(pkg, "numbers", None)
        self.pipe = rpipe
        self.cfg = manifest.build_config(rconfig.PipelineConfig, cfg_doc,
                                         root)
        self.device = torch.device(device)
        self.template = rpipe.init_state(self.cfg, self.device)

    def step(self, prog_pre, rgb, depth, control: bool = False):
        """(new state, outputs) of the reference's step from the program's
        state before the frame; with `control`, computed with TF32 on."""
        state = adopt(self.template, prog_pre)
        with torch.no_grad(), tf32(control):
            return self.pipe.process_frame(state, rgb, depth, self.cfg)

    def first(self, rgb, depth, control: bool = False):
        """The first frame from the reference's own initial state."""
        with torch.no_grad(), tf32(control):
            return self.pipe.process_frame(self.template, rgb, depth,
                                           self.cfg)

    def numbers(self, p_out, p_post, r_out, r_post) -> dict:
        """`numbers` of one frame, with the package's own merged in; a
        name of the package's that `aggregate` would make twice raises."""
        out = numbers(p_out, p_post, r_out, r_post)
        if self.own_numbers is None:
            return out
        more = self.own_numbers(p_out, p_post, r_out, r_post)
        clash = sorted(_names(out) & _names(more))
        if clash:
            raise ValueError(f"{self.name}.numbers gives "
                             f"{clash}, which the shared numbers give")
        out.update(more)
        return out


def compare(samples, ref: Reference, frames) -> dict:
    """Each number over the samples: its worst (the largest) under its own
    name, and its median over the frames under `<name>_med`. `samples`
    holds, for each frame drawn, (frame index in the rendered stream, the
    program's state before it or None for the first frame, its outputs,
    its new state); `frames` is (rgb, depth) of the rendered stream."""
    per: dict = {}
    for idx, pre, p_out, p_post in samples:
        rgb, depth = frames[0][idx], frames[1][idx]
        if pre is None:
            r_post, r_out = ref.first(rgb, depth)
        else:
            r_post, r_out = ref.step(pre, rgb, depth)
        for k, v in ref.numbers(p_out, p_post, r_out, r_post).items():
            per.setdefault(k, []).append(v)
    return aggregate(per)


def control(samples, ref: Reference, frames) -> dict:
    """The control's readings on the same samples: the reference with TF32
    on, put in the program's place, against the reference."""
    per: dict = {}
    rgb, depth = frames
    for idx, pre, _, _ in samples:
        if pre is None:
            r_post, r_out = ref.first(rgb[idx], depth[idx])
            c_post, c_out = ref.first(rgb[idx], depth[idx], True)
        else:
            r_post, r_out = ref.step(pre, rgb[idx], depth[idx])
            c_post, c_out = ref.step(pre, rgb[idx], depth[idx], True)
        for k, v in ref.numbers(c_out, c_post, r_out, r_post).items():
            per.setdefault(k, []).append(v)
    return aggregate(per)


def aggregate(per: dict) -> dict:
    """{name: [value per frame]} -> worst and median of each."""
    out = {}
    for k, vs in per.items():
        out[k] = max(vs)
        out[f"{k}_med"] = float(np.median(vs))
    return out


def verdict(worst: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers the cell's
    checks file compares; a number that is missing or not finite fails."""
    shown, ok = {}, True
    for name, spec in limits.items():
        v = worst.get(name, math.inf)
        if not math.isfinite(v):
            v = math.inf
        good = v <= spec["limit"]
        ok &= good
        shown[name] = {"value": v if math.isfinite(v) else "inf",
                       "limit": spec["limit"]}
    return ok, shown

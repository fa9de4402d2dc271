"""The plain reference of the loop-closure cell (`fr1_room_lc-revisit`).

Plain PyTorch: it imports neither JAX nor anything of the program under
test. It is the frozen reference (`slam_bench/reference`, the program's
plain path at 37bce59) with fern place recognition and global loop
closure added: `config` (the frozen dataclasses), `pipeline` (the frozen
step with the program's steps 10-14 as at 193edc4), `ops/ferns.py` and
`ops/loop_closure.py` (copies at 193edc4) and `ops/deformation.py`,
written from the published method with a hand-written Jacobian, so that
the graph solve does not share the program's automatic differentiation.

`numbers` adds seven numbers to the benchmark's shared ones
(`slam_bench/check.py`), each 0 where the program and the reference
agree. On a frame where both sides' gates fired:

* `lc_decision`: 1 where they differ on whether the gate fired or on
  whether the closure was accepted, or where the reference's closure on
  the program's closure inputs (below) gives another verdict;
* `lc_pose_t`, `lc_pose_r`: the gap between the two sides' poses after
  the closure (m; the largest entry of the rotations' difference), each
  side from its own closure inputs;
* `lc_model`: the largest distance between a live surfel of the
  program's deformed map (`FrameOutput.lc_model`) and the same slot of
  the map that the reference's closure makes from the program's closure
  inputs (`FrameOutput.lc_inputs`), in metres;
* `lc_kf_t`: likewise, the largest distance between the program's
  translation of a keyframe in its new state and that closure's.

On a frame where neither fired, these read 0, and `model_nn_no_lc`,
`model_far_no_lc` read the shared `model_nn`, `model_far` of the fused
model (`check.model_gaps`), which 0 stands for on a closure's frame. Where
one side alone fired, `lc_decision` reads 1 and the other four infinite;
where the program handed out no closure inputs, `lc_model` and `lc_kf_t`
read infinite.

Why the map is compared on the program's own closure inputs: the graph
solve's nodes that no constraint holds are held by the regularisation
and the damping (1e-4) alone, so the solve amplifies a difference of its
inputs at the float32 rounding to metres in the map: on an H100 a pose
1e-7 m off moves single surfels by up to 964 m and the median one by up
to 4 mm (ROADMAP Queue A item 6, PERF.md section 2). The two sides' front
ends differ by that much, so their maps do not compare. Fed the same
inputs, the reference's closure makes the program's map and keyframe
poses bit for bit there, and the front end that made those inputs is
compared on its own, frame by frame, by the shared numbers and
`lc_pose_*`.
"""

from __future__ import annotations

import math

import torch

from slam_bench import check
from slam_bench.reference_lc.ops import loop_closure as lc_ops
from slam_bench.reference_lc.pipeline import LC_INPUTS

CLOSURE = ("lc_pose_t", "lc_pose_r", "lc_model", "lc_kf_t")
NO_CLOSURE = ("model_nn_no_lc", "model_far_no_lc")


def _fired(out) -> bool:
    return bool(out.lc_gate) if out.lc_gate is not None else False


def _accepted(out) -> bool:
    return _fired(out) and bool(out.lc_accepted)


def _largest(d: torch.Tensor) -> float:
    """The largest of the distances d, a distance that is not finite
    counting as infinite; 0 over none."""
    if d.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(d, nan=math.inf).max())


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a.to(torch.float64)
                                    - b.to(torch.float64), dim=-1)


def replay(p_out, r_out):
    """The reference's `close_global_loop` on the program's closure inputs
    (`p_out.lc_inputs`, taken into the reference's types by the
    reference's own inputs, `r_out.lc_inputs`). Returns (its result, the
    inputs)."""
    r_in = r_out.lc_inputs
    args = [check.adopt(r_in[k], p_out.lc_inputs.get(k), f"lc_inputs.{k}")
            for k in LC_INPUTS]
    with torch.no_grad():
        res = lc_ops.close_global_loop(*args, r_in["cam"], r_in["icp_cfg"])
    return res, dict(zip(LC_INPUTS, args))


def numbers(p_out, p_post, r_out, r_post) -> dict:
    """The reference's numbers of one frame (module docstring): the
    program's outputs and new state (p_*) against the reference's
    (r_*)."""
    p_fire, r_fire = _fired(p_out), _fired(r_out)
    decision = (p_fire != r_fire or _accepted(p_out) != _accepted(r_out))
    out = dict.fromkeys(CLOSURE, 0.0)
    out.update(dict.fromkeys(NO_CLOSURE, 0.0))
    if not p_fire and not r_fire:
        sp, sr = p_post.model.surfels, r_post.model.surfels
        vp, vr = sp.confidences > 0, sr.confidences > 0
        out["model_nn_no_lc"], out["model_far_no_lc"] = check.model_gaps(
            sp.positions[vp], sr.positions[vr])
        return {"lc_decision": 0.0, **out}
    out.update(dict.fromkeys(CLOSURE, math.inf))
    if p_fire and r_fire:
        out["lc_pose_t"] = _largest(_gap(p_out.pose.t, r_out.pose.t))
        out["lc_pose_r"] = float((p_out.pose.R.to(torch.float64)
                                  - r_out.pose.R).abs().max())
        if getattr(p_out, "lc_inputs", None) is not None \
                and getattr(p_out, "lc_model", None) is not None:
            res, inp = replay(p_out, r_out)
            decision |= bool(res.accepted) != _accepted(p_out)
            model = inp["model"]
            ids = torch.arange(model.capacity, device=model.positions.device)
            live = (ids < inp["nb_supersurfels"]) & (model.confidences > 0)
            out["lc_model"] = _largest(
                _gap(p_out.lc_model, res.model.positions)[live])
            n = int(inp["store"].db.count)
            out["lc_kf_t"] = _largest(_gap(p_post.kf_store.db.poses_t[:n],
                                           res.kf_poses_t[:n]))
    return {"lc_decision": float(decision), **out}

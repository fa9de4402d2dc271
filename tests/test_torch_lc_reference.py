"""The port against the loop-closure cell's plain reference
(`slam_bench/reference_lc`, which imports nothing of the port): fern codes
and their lookup, the deformation graph's Gauss-Newton against the
reference's hand-written Jacobian, `close_global_loop`, and one frame
step whose gate fires, with the recorder's closure spans and counter.

The gate frame is `slam_bench/tests/lc_gate.py:lc_gate_frame`: the
revisit clip at 320x240, stamps moved on so that the gate fires after
three frames, and the keyframe's pose moved 3 cm, so that the accepted
closure deforms the map. The port's step runs once under the profiler
and the reference's once from the port's state before it; both hand
their `close_global_loop` and graph solve to a recorder, so each is
compared on the inputs the other side was given."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from slam_bench import check
from slam_bench import reference_lc
from slam_bench.reference_lc import config as rcfg
from slam_bench.reference_lc import pipeline as rpipe
from slam_bench.reference_lc.ops import deformation as rdefo
from slam_bench.reference_lc.ops import ferns as rferns
from slam_bench.reference_lc.ops import loop_closure as rlc
from slam_bench.tests.lc_gate import lc_config, lc_gate_frame
from supersurfel_fusion_tpu_torch import config as tcfg
from supersurfel_fusion_tpu_torch import pipeline as tpipe
from supersurfel_fusion_tpu_torch import synthetic, tracing
from supersurfel_fusion_tpu_torch.ops import deformation as tdefo
from supersurfel_fusion_tpu_torch.ops import ferns as tferns
from supersurfel_fusion_tpu_torch.ops import loop_closure as tlc

torch.set_num_threads(1)

LC_NUMBERS = ("lc_decision", *reference_lc.CLOSURE, *reference_lc.NO_CLOSURE)


def leaves(x):
    """The tensors of a nest of named tuples and tuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def recording(mp, module, name, calls):
    """module.name, recording (args, result) of each call into `calls`."""
    orig = getattr(module, name)

    def fn(*args):
        res = orig(*args)
        calls.append((args, res))
        return res
    mp.setattr(module, name, fn)


@pytest.fixture(scope="module")
def gate():
    """The gate frame through both steps: a dict of the state before it,
    each side's new state and outputs, the recorder's frame, the
    profiler's `ssf.*` ranges and the recorded calls."""
    cfg, rc = lc_config(tcfg), lc_config(rcfg)
    pre, rgb, depth = lc_gate_frame(cfg)
    calls = {k: [] for k in ("p_lc", "p_opt", "r_lc", "r_opt")}
    with pytest.MonkeyPatch.context() as mp:
        recording(mp, tlc, "close_global_loop", calls["p_lc"])
        recording(mp, tdefo, "optimise", calls["p_opt"])
        recording(mp, rlc, "close_global_loop", calls["r_lc"])
        recording(mp, rdefo, "optimise", calls["r_opt"])
        first = tracing.RECORDER.count
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.stretch"):
                p_post, p_out = tpipe.process_frame(pre, rgb, depth, cfg)
        ranges = sorted(((ev.name(), ev.start_ns(), ev.end_ns())
                         for ev in prof.profiler.kineto_results.events()
                         if ev.name().startswith(("ssf.", "lc."))),
                        key=lambda r: r[1])
        ref_pre = check.adopt(rpipe.init_state(rc, "cpu"), pre)
        with torch.no_grad():
            r_post, r_out = rpipe.process_frame(ref_pre, rgb, depth, rc)
    return dict(pre=pre, p_post=p_post, p_out=p_out, r_post=r_post,
                r_out=r_out, frame=tracing.frames(first)[0], ranges=ranges,
                **calls)


def test_fern_codes_and_lookup_match_the_reference():
    """At 160x120: each frame's 500 codes, and the lookup of each frame
    among the keyframes stored before it (best id, dissimilarity and the
    new-keyframe flag), exactly."""
    cam = dict(fx=131.25, fy=131.25, cx=79.5, cy=59.5, width=160,
               height=120)
    fc = tcfg.FernsConfig(enabled=True)
    rfc = rcfg.FernsConfig(enabled=True)
    ttab = tferns.make_fern_table(fc, 160, 120, 5.0, "cpu")
    rtab = rferns.make_fern_table(rfc, 160, 120, 5.0, "cpu")
    for a, b in zip(ttab, rtab):
        assert torch.equal(a, b)
    tdb, rdb = tferns.FernDB.empty(4, 500, "cpu"), rferns.FernDB.empty(
        4, 500, "cpu")
    n_new = 0
    for k, (R, t) in enumerate(synthetic.revisit_trajectory()[::4]):
        rgb, depth = synthetic.render(tcfg.CameraIntrinsics(**cam), R, t)
        rgb = torch.from_numpy(rgb).float()
        depth = torch.from_numpy(depth).float() * 2e-4
        codes = tferns.compute_codes(rgb, depth, *ttab, fc.pyramid_level)
        assert torch.equal(codes, rferns.compute_codes(
            rgb, depth, *rtab, rfc.pyramid_level)), k
        tq = tferns.query(tdb, codes, fc.new_frame_thresh)
        rq = rferns.query(rdb, codes, rfc.new_frame_thresh)
        for a, b in zip(tq, rq):
            assert torch.equal(a, b), k
        n_new += bool(tq[2])
        pose = (torch.eye(3), torch.zeros(3), torch.tensor(k))
        tdb = tferns.add_keyframe(tdb, codes, *pose, when=tq[2])
        rdb = rferns.add_keyframe(rdb, codes, *pose, when=rq[2])
        for a, b in zip(tdb, rdb):
            assert torch.equal(a, b), k
    # the frames out are new, the way back finds them again
    assert 2 <= n_new < len(synthetic.revisit_trajectory()[::4])


def test_graph_solve_matches_the_hand_written_jacobian(gate):
    """The port's `optimise` (the Jacobian from `torch.func.jacfwd`)
    against the reference's (rows written out) on the same graph,
    bindings and constraints. Every hand-written row is the one product
    that jacfwd's tangent forms, so the two solve the same float64
    normal equations: the node transforms are held within 1e-6 (a few
    float32 roundings of unit-size values), the residual and the mean
    constraint gap within 1e-6 relative. Rows that rounded otherwise
    would move the nodes that no constraint determines, by up to 1e-2 m
    (ROADMAP, deformation.optimise), and fail this."""
    (p_args, p_res), = gate["p_opt"]
    (r_args, r_res), = gate["r_opt"]
    for a, b in zip(leaves(p_args), leaves(r_args)):
        assert torch.equal(a, b)
    rot, trans, err, cerr = r_res
    torch.testing.assert_close(p_res[0], rot, rtol=0, atol=1e-6)
    torch.testing.assert_close(p_res[1], trans, rtol=0, atol=1e-6)
    torch.testing.assert_close(p_res[2], err, rtol=1e-6, atol=0)
    torch.testing.assert_close(p_res[3], cerr, rtol=1e-6, atol=0)
    # the solve moved the graph: the comparison is not of the identity
    assert float(trans.abs().max()) > 1e-3
    assert float(cerr) < 3e-4


def test_close_global_loop_matches_the_reference(gate):
    """`close_global_loop` on the same inputs: `accepted` equal; the pose
    within 1e-6; the deformed model's positions within 1e-6 relative
    (some ill-conditioned surfels lie kilometres out), its other fields
    and the keyframe poses within 1e-6."""
    (p_args, p_res), = gate["p_lc"]
    (r_args, r_res), = gate["r_lc"]
    for a, b in zip(leaves(p_args), leaves(r_args)):
        assert torch.equal(a, b)
    assert bool(p_res.accepted) and bool(r_res.accepted)
    for a, b in zip(leaves(p_res.pose), leaves(r_res.pose)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    torch.testing.assert_close(p_res.model.positions, r_res.model.positions,
                               rtol=1e-6, atol=1e-6)
    for f in ("orientations", "shapes", "colors", "confidences"):
        torch.testing.assert_close(getattr(p_res.model, f),
                                   getattr(r_res.model, f), rtol=1e-6,
                                   atol=1e-6)
    for f in ("kf_poses_R", "kf_poses_t"):
        torch.testing.assert_close(getattr(p_res, f), getattr(r_res, f),
                                   rtol=0, atol=1e-6)


def test_gate_frame_step_matches_the_reference(gate):
    """The whole step on the gate frame: both fire and accept; every
    number of the benchmark's check (the shared ones and the reference's
    `lc_*`) reads 0 or within float32 rounding; `lc_model` is the model
    the closure returned, and `lc_inputs` the arguments it was given."""
    p_out, r_out = gate["p_out"], gate["r_out"]
    assert p_out.lc_gate is True and r_out.lc_gate is True
    assert bool(p_out.lc_accepted) and bool(r_out.lc_accepted)
    (p_args, p_res), = gate["p_lc"]
    assert p_out.lc_model is p_res.model.positions
    assert tuple(p_out.lc_inputs) == tpipe.LC_INPUTS == rpipe.LC_INPUTS
    for a, b in zip(p_out.lc_inputs.values(), p_args):
        assert a is b
    shared = check.numbers(p_out, gate["p_post"], r_out, gate["r_post"])
    for k in ("labels", "plane_depth", "model_count", "model_far",
              "vo_matches", "static_sp"):
        assert shared[k] == 0.0, k
    for k in ("pose_t", "pose_r", "model_nn", "local_map"):
        assert shared[k] <= 1e-6, k
    own = reference_lc.numbers(p_out, gate["p_post"], r_out, gate["r_post"])
    assert own == dict.fromkeys(LC_NUMBERS, 0.0)
    assert int(gate["p_post"].lc_count) == int(gate["pre"].lc_count) + 1


def test_reference_numbers_see_a_closure_left_out(gate):
    """The reference's numbers against outputs that differ as a fault
    would. On the program's own closure inputs the reference's closure
    moves the map; a model handed out undeformed, or deformed the wrong
    way, reads `lc_model` as far as the closure moved the farthest
    surfel, or twice that; a keyframe or the pose off by 1 mm reads
    `lc_kf_t` or `lc_pose_t`; a closure without
    its inputs reads `lc_model` infinite; a gate that fired on one side
    alone reads `lc_decision` 1 and the others infinite."""
    p_out, r_out = gate["p_out"], gate["r_out"]
    p_post, r_post = gate["p_post"], gate["r_post"]
    before = gate["pre"].model.surfels.positions
    n = int(gate["pre"].model.nb_supersurfels)
    moved = float((p_out.lc_model[:n] - before[:n]).norm(dim=-1).max())
    assert moved > 1e-3

    def nums(out=p_out, post=p_post):
        return reference_lc.numbers(out, post, r_out, r_post)

    undeformed = nums(p_out._replace(lc_model=before))
    assert undeformed["lc_model"] == pytest.approx(moved, rel=1e-6)
    flipped = nums(p_out._replace(lc_model=2 * before - p_out.lc_model))
    assert flipped["lc_model"] == pytest.approx(2 * moved, rel=1e-5)
    db = p_post.kf_store.db
    n_kf = int(gate["pre"].kf_store.db.count)
    assert n_kf >= 1
    shifted_t = db.poses_t.clone()
    shifted_t[n_kf - 1, 1] += 1e-3
    shifted = nums(post=p_post._replace(kf_store=p_post.kf_store._replace(
        db=db._replace(poses_t=shifted_t))))
    assert shifted["lc_kf_t"] == pytest.approx(1e-3, rel=1e-3)
    off = nums(p_out._replace(pose=p_out.pose._replace(
        t=p_out.pose.t + torch.tensor([1e-3, 0.0, 0.0]))))
    assert off["lc_pose_t"] == pytest.approx(1e-3, rel=1e-3)
    assert nums(p_out._replace(lc_inputs=None))["lc_model"] == np.inf
    alone = nums(p_out._replace(lc_gate=False, lc_model=None,
                                lc_inputs=None))
    assert alone == {"lc_decision": 1.0,
                     **dict.fromkeys(reference_lc.CLOSURE, np.inf),
                     **dict.fromkeys(reference_lc.NO_CLOSURE, 0.0)}


def test_reference_numbers_hold_the_fused_model_without_a_closure(gate):
    """On a frame where neither gate fired, the closure's numbers read 0
    and the fused models are compared as `check.model_gaps` compares
    them: the two steps' models agree, and one surfel in ten moved 1 mm
    is seen as that share."""
    p_out, r_out = gate["p_out"], gate["r_out"]
    p_post, r_post = gate["p_post"], gate["r_post"]
    p_calm = p_out._replace(lc_gate=False, lc_model=None, lc_inputs=None)
    r_calm = r_out._replace(lc_gate=False, lc_model=None, lc_inputs=None)
    calm = reference_lc.numbers(p_calm, p_post, r_calm, r_post)
    assert calm == dict.fromkeys(LC_NUMBERS, 0.0)
    surfels = p_post.model.surfels
    live = torch.nonzero(surfels.confidences > 0)[:, 0]
    moved = live[::10]
    pos = surfels.positions.clone()
    pos[moved, 2] += 1e-3
    shifted = p_post._replace(model=p_post.model._replace(
        surfels=surfels._replace(positions=pos)))
    far = reference_lc.numbers(p_calm, shifted, r_calm, r_post)
    assert far["model_far_no_lc"] == pytest.approx(
        len(moved) / len(live), abs=0.02)


def test_closure_parts_nest_under_the_loop_closure_stage(gate):
    """The recorder: the gate frame counts `lc.gate` once; `lc.relocalise`,
    `lc.align` and `lc.deform` lie in that order inside `ssf.loop_closure`.
    The profiler sees the stage ranges alone, none inside another, and no
    `lc.*` part."""
    f = gate["frame"]
    assert f.counts == {"lc.gate": 1}
    spans = f.spans
    parts = [(n, spans[p][0], s, e) for n, p, s, e in spans
             if n.startswith("lc.")]
    assert [p[0] for p in parts] == ["lc.relocalise", "lc.align",
                                     "lc.deform"]
    (stage,) = [s for s in spans if s[0] == "ssf.loop_closure"]
    for name, parent, s, e in parts:
        assert parent == "ssf.loop_closure", name
        assert stage[2] <= s <= e <= stage[3], name
    for a, b in zip(parts, parts[1:]):
        assert a[3] <= b[2]
    ranges = gate["ranges"]
    assert not any(n.startswith("lc.") for n, *_ in ranges)
    assert [n for n, *_ in ranges].count("ssf.loop_closure") == 1
    for a, b in zip(ranges, ranges[1:]):
        assert a[2] <= b[1], (a, b)

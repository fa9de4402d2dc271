"""The hooks through which a cell brings its own parts as files: a
configuration's "reference" package and its numbers, a checks file's
event frames (compared in every run, and reached by the traced stretch),
and faults planted from `fault_plants/<name>.py` with their NEEDS."""

from __future__ import annotations

import json
import shutil

import pytest

from slam_bench import calibrate, check, faults, run, scene
from slam_bench.tests.conftest import run_cell

STUB = "tests.stub_reference"
# lc_gate on every 7th frame (stamps 3, 10, ...: the window's first frame
# after the tiny mix's 3 warm-up frames, never the run's first frame) and
# the pose moved by 3 mm per axis on those frames alone
EVERY7 = '''
NEEDS = []


def plant(pipeline, ops):
    from supersurfel_fusion_tpu_torch.types import Pose

    orig = pipeline.process_frame

    def step(state, rgb, depth, cfg):
        new, out = orig(state, rgb, depth, cfg)
        if int(state.stamp) % 7 != 3:
            return new, out
        pose = Pose(out.pose.R, out.pose.t + 0.003)
        return new._replace(pose=pose), out._replace(pose=pose,
                                                     lc_gate=True)
    return pipeline, "process_frame", step
'''
# lc_gate on the 4th frame run under the profiler, on no other frame
TRACED4 = '''
NEEDS = []


def plant(pipeline, ops):
    import torch

    orig = pipeline.process_frame
    profiled = []

    def step(state, rgb, depth, cfg):
        new, out = orig(state, rgb, depth, cfg)
        if torch.autograd._profiler_enabled():
            profiled.append(int(state.stamp))
            if len(profiled) == 4:
                out = out._replace(lc_gate=True)
        return new, out
    return pipeline, "process_frame", step
'''
STRETCH = '''
def read(ctx, name):
    """stretch.frames / stretch.events / stretch.last_event: the traced
    stretch's frames, its event frames and the last one's position."""
    tr, ev = ctx.trace, ctx.traced_event_frames
    if tr is None:
        return None
    part = name.split(".", 1)[1]
    if part == "frames":
        return float(tr.frames)
    if part == "events":
        return float(len(ev))
    return float(ev[-1]) if ev else None
'''


def _cell(tiny, tmp_path, name, *, reference=None, events=None,
          numbers=None, traffic=None):
    """A copy of the tiny data with cell `name`-sway: the tiny fr1
    configuration (with `reference`), the tiny sway (updated by
    `traffic`), tiny-sway's checks (with `events` and more `numbers`)."""
    root = tmp_path / "d"
    if not root.exists():
        shutil.copytree(tiny, root)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    if reference is not None:
        cfg["reference"] = reference
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "tiny_sway.json").read_text())
    mix.update(traffic or {})
    (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    ch = json.loads((root / "checks" / "tiny-sway.json").read_text())
    ch["numbers"].update(numbers or {})
    if events is not None:
        ch["events"] = events
    cell = f"{name}-sway"
    (root / "checks" / f"{cell}.json").write_text(json.dumps(ch))
    doc["configs"].append({"name": name, "source": "test",
                           "file": f"configs/{name}.json", "reduced": [],
                           "why": "test"})
    doc["workloads"].append({"name": cell, "config": name, "traffic": name,
                             "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root, cell


def _plant(root, name, text):
    (root / "fault_plants").mkdir(exist_ok=True)
    (root / "fault_plants" / f"{name}.py").write_text(text)


def test_config_names_its_reference(tiny, tmp_path, capsys):
    from slam_bench.tests.stub_reference import pipeline as stub

    root, cell = _cell(tiny, tmp_path, "stub", reference=STUB,
                       numbers={"stub_pose_tz": {"limit": 1e-3}})
    stub.STAMPS.clear()
    res = run_cell(root, cell, seconds=1.0, capsys=capsys)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["stub_pose_tz"]["limit"] == 1e-3
    assert 0 <= res["checks"]["stub_pose_tz"]["value"] <= 1e-3
    # the first frame and the window frames drawn, stepped by the stub
    assert stub.STAMPS and stub.STAMPS[0] == 0


@pytest.mark.parametrize("name", ["pose_t", "labels_med"])
def test_colliding_number_raises(tiny, name):
    doc = json.loads((tiny / "configs" / "tiny.json").read_text())
    doc["reference"] = STUB
    ref = check.Reference(doc, tiny, "cpu")
    mix = json.loads((tiny / "traffic" / "tiny_sway.json").read_text())
    rgb, depth, _ = scene.render_stream(doc["pipeline"]["cam"], mix, 3,
                                        "cpu")
    r_post, r_out = ref.first(rgb[0], depth[0])
    nums = ref.numbers(r_out, r_post, r_out, r_post)
    assert nums["stub_pose_tz"] == 0.0 and "pose_t" in nums
    ref.own_numbers = lambda *a: {name: 0.0}
    with pytest.raises(ValueError, match=name):
        ref.numbers(r_out, r_post, r_out, r_post)


@pytest.mark.parametrize("seed", [2**31 + 5, 2**40 + 17, 77])
def test_event_frames_catch_a_fault_that_fires_on_them(tiny, tmp_path,
                                                       capsys, seed):
    root, cell = _cell(tiny, tmp_path, "ev7",
                       events={"output": "lc_gate", "keep": 2},
                       numbers={"pose_t": {"limit": 1e-3}})
    _plant(root, "every7", EVERY7)
    with faults.planted("every7", root):
        res = run_cell(root, cell, seed=seed, seconds=2.0, capsys=capsys)
    assert res["checks"]["event_frames"]["value"] >= 1, res["checks"]
    assert res["checks"]["pose_t"]["value"] > 1e-3
    assert res["correct"] is False
    # the sound program passes the same limit
    res = run_cell(root, cell, seed=seed, seconds=1.0, capsys=capsys)
    assert res["checks"]["pose_t"]["value"] <= 1e-3


def test_events_named_but_never_fired_fail(tiny, tmp_path, capsys):
    # the tiny configuration runs no loop closure: lc_gate is None
    root, cell = _cell(tiny, tmp_path, "never",
                       events={"output": "lc_gate", "keep": 2})
    rc = run.main(["--workload", cell, "--seed", "9", "--seconds", "1.0",
                   "--trace", "0"], root=root, data=root, device="cpu")
    captured = capsys.readouterr()
    res = json.loads(captured.out.strip().splitlines()[-1])
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["event_frames"]["value"] == 0
    assert "event frames compared: 0 of 0" in captured.err
    # the numbers themselves pass: only the missing event fails the run
    assert all(v["value"] <= v["limit"] for k, v in res["checks"].items()
               if k != "event_frames")


class _Out:
    def __init__(self, flag):
        self.lc_gate = flag


# the window positions that the first benchmark's `Sampler` kept over 500
# frames (every 16, keep 6), by seed
FIRST_DRAWS = {0: [48, 109, 129, 227, 446, 459],
               5: [43, 75, 169, 248, 274, 444],
               2**33 + 1: [151, 190, 195, 256, 324, 456]}


@pytest.mark.parametrize("seed", list(FIRST_DRAWS))
def test_blind_draws_are_the_samplers_alone(seed):
    """Without events the harness draws what `Sampler` alone drew before
    events existed, and with them the blind sample is unchanged; the
    event sample keeps `keep` of the frames that fired."""
    n, every, keep = 500, 16, 6
    fired = {j for j in range(n) if j % 37 == 5}
    for events in (None, run.Events(seed, "lc_gate", 2)):
        sampler = run.Sampler(seed, every, keep)
        for j in range(n):
            run.draw(sampler, events, j, (j, None, _Out(j in fired), None))
        assert sorted(s[0] for s in sampler.kept) == FIRST_DRAWS[seed]
    assert events.window == sorted(fired)
    assert len(events.kept) == 2 and {e[0] for e in events.kept} <= fired
    got = run.samples(("first",), sampler, events)
    assert got[0] == ("first",) and len(got) == 1 + keep + len(
        [e for e in events.kept if e not in sampler.kept])


def test_default_reference_and_package_names(tiny):
    doc = json.loads((tiny / "configs" / "tiny.json").read_text())
    assert "reference" not in doc
    from slam_bench.reference import pipeline as default

    assert check.Reference(doc, tiny, "cpu").pipe is default
    assert check.reference_package({"reference": STUB}) == \
        "slam_bench.tests.stub_reference"
    for bad in ("../reference", "a/b", "", ".x", 3):
        with pytest.raises(ValueError):
            check.reference_package({"reference": bad})


def test_traced_stretch_reaches_an_event_within_its_cap(tiny, tmp_path,
                                                        capsys):
    root, cell = _cell(tiny, tmp_path, "st",
                       events={"output": "lc_gate", "keep": 1},
                       traffic={"trace_frames": 2, "trace_frames_max": 9})
    (root / "metrics" / "stretch.py").write_text(STRETCH)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for part in ("frames", "events", "last_event"):
        doc["per_layer"].append({
            "name": f"stretch.{part}", "unit": "frames", "better": "lower",
            "source": "program_counter", "layer": "test",
            "moves": "frame_ms", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    def stretch(res):
        return {k.split(".")[1]: v["value"]
                for k, v in res["metrics"].items()
                if k.startswith("stretch.")}

    # fires on the 4th traced frame alone: the stretch goes on past its 2
    # frames and stops there
    _plant(root, "traced4", TRACED4)
    with faults.planted("traced4", root):
        res = run_cell(root, cell, seconds=1.0, trace=1, capsys=capsys)
    assert stretch(res) == {"frames": 4, "events": 1, "last_event": 3}
    # nothing fires: the stretch runs to its cap and no further, and the
    # run is not correct
    res = run_cell(root, cell, seconds=1.0, trace=1, capsys=capsys)
    assert stretch(res) == {"frames": 9, "events": 0}
    assert res["correct"] is False


def test_fault_plants_by_name_with_their_needs(tiny, tmp_path, capsys):
    root, cell = _cell(tiny, tmp_path, "nd")
    _plant(root, "needs_ferns", EVERY7.replace(
        "NEEDS = []", 'NEEDS = ["ferns.enabled", "enable_loop_closure"]'))
    from slam_bench import manifest
    from supersurfel_fusion_tpu_torch.config import PipelineConfig

    cfg = manifest.build_config(PipelineConfig, json.loads(
        (root / "configs" / "nd.json").read_text()), root)
    assert faults.unmet("needs_ferns", cfg, root) == [
        "ferns.enabled", "enable_loop_closure"]
    assert faults.unmet("mod_all_static", cfg, root) == ["mod.enabled"]
    assert faults.unmet("state_unchanged", cfg, root) == []
    with pytest.raises(KeyError):
        faults.lookup("no_such_fault", root)
    with pytest.raises(KeyError):
        faults.lookup("../faults", root)
    for name in ("needs_ferns", "mod_all_static"):
        rc = calibrate.main(["--workload", cell, "--seeds", "1", "--fault",
                             name], root=root, data=root, device="cpu")
        assert rc == 2
        assert "does not turn on" in capsys.readouterr().err
    assert set(faults.FAULTS) == {"state_unchanged", "pose_altered",
                                  "labels_altered", "labels_patch",
                                  "mod_all_static"}
    assert all(callable(faults.lookup(f)[0]) for f in faults.FAULTS)

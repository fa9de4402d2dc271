"""The loop-closure cell's planted fault (`fault_plants/lc_no_deform.py`)
on a frame whose gate fires (`lc_gate.lc_gate_frame`, 320x240): the
reference (`reference_lc`) follows the program from its state before the
frame, as a run does on an event frame, and the numbers are held to the
cell's own limits (`checks/fr1_room_lc-revisit.json`)."""

from __future__ import annotations

import json
from contextlib import nullcontext

from slam_bench import check, faults, manifest
from slam_bench.tests.conftest import BENCH, REPO
from slam_bench.tests.lc_gate import lc_config, lc_gate_frame

LC_CELL = "fr1_room_lc-revisit"


def test_loop_closure_fault_is_caught(tiny):
    """The sound step passes; with the fault planted the closure is still
    accepted, and `lc_model` reads above its limit. The fault needs loop
    closure on, which the tiny cells do not turn on."""
    from supersurfel_fusion_tpu_torch import config as tcfg
    from supersurfel_fusion_tpu_torch import pipeline

    doc = json.loads((BENCH / "configs" / "fr1_room_lc.json").read_text())
    cfg = lc_config(tcfg)
    for key in ("cam", "tps", "icp", "fusion", "vo", "ferns"):
        doc["pipeline"][key].update(
            {k: getattr(getattr(cfg, key), k)
             for k in doc["pipeline"][key]})
    doc["pipeline"]["max_frames"] = cfg.max_frames
    limits = json.loads((BENCH / "checks" / f"{LC_CELL}.json")
                        .read_text())["numbers"]
    pre, rgb, depth = lc_gate_frame(cfg)
    assert manifest.build_config(tcfg.PipelineConfig, doc, REPO) == cfg
    ref = check.Reference(doc, REPO, "cpu")
    r_post, r_out = ref.step(pre, rgb, depth)
    assert r_out.lc_gate and bool(r_out.lc_accepted)
    verdicts = {}
    for fault in ("", "lc_no_deform"):
        with faults.planted(fault) if fault else nullcontext():
            p_post, p_out = pipeline.process_frame(pre, rgb, depth, cfg)
        assert p_out.lc_gate and bool(p_out.lc_accepted)
        nums = ref.numbers(p_out, p_post, r_out, r_post)
        verdicts[fault] = check.verdict(
            check.aggregate({k: [v] for k, v in nums.items()}), limits)
    assert verdicts[""][0] is True, verdicts[""][1]
    ok, shown = verdicts["lc_no_deform"]
    assert ok is False
    assert shown["lc_model"]["value"] > limits["lc_model"]["limit"]
    assert shown["lc_decision"]["value"] == 0.0
    tiny_cfg = manifest.build_config(
        tcfg.PipelineConfig, json.loads((tiny / "configs" / "tiny.json")
                                        .read_text()), tiny)
    assert faults.unmet("lc_no_deform", tiny_cfg) == ["enable_loop_closure"]

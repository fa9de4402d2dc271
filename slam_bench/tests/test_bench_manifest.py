"""BENCHMARK.json against the contract's shape, and the files it names."""

from __future__ import annotations

import json

import pytest

from slam_bench import manifest
from slam_bench.tests.conftest import BENCH, REPO

DOC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert manifest.check_names(DOC) == []
    assert DOC["paths"] == ["slam_bench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    entry_keys = {"configs": {"name", "source", "file", "reduced", "why"},
                  "workloads": {"name", "config", "traffic", "chips",
                                "why"}}
    for group, keys in entry_keys.items():
        for e in DOC[group]:
            assert set(e) == keys, e
    for e in DOC["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    names = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in names
    for e in DOC["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert e["moves"] in names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in DOC[group]]
        assert len(ns) == len(set(ns)), group
    for e in DOC["configs"] + DOC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in DOC["per_layer"]:
        assert 1 <= len(e["layer"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_files(cell):
    """Each cell's configuration, traffic and checks files exist, and every
    metric it reports has a reader; the configuration builds both the
    program's and the reference's PipelineConfig."""
    from slam_bench.reference.config import PipelineConfig as RefConfig
    from supersurfel_fusion_tpu_torch.config import PipelineConfig

    bench = manifest.Bench(REPO)
    w = bench.cell(cell)
    assert w["chips"] == 1
    doc = bench.config(w["config"])
    assert manifest.build_config(PipelineConfig, doc, REPO) is not None
    assert manifest.build_config(RefConfig, doc, REPO) is not None
    for k in bench.config_entry(w["config"])["reduced"]:
        assert k in doc["reduced"]
    assert bench.traffic(w["traffic"])["poses"] >= 2
    checks = bench.checks(cell)
    assert checks["numbers"]
    for trace in (False, True):
        for m in bench.metrics_for(cell, trace):
            assert callable(bench.reader(m["name"]))
    for m in DOC["per_layer"]:
        if "." in m["name"] and m["name"].split(".")[0] in ("host_ms",
                                                             "dev_ms"):
            layer = m["name"].split(".", 1)[1]
            assert bench.layer(layer)["stages"]


def test_every_config_is_used():
    used = {w["config"] for w in DOC["workloads"]}
    assert used == {c["name"] for c in DOC["configs"]}
    assert all((REPO / c["file"]).is_relative_to(BENCH)
               for c in DOC["configs"])

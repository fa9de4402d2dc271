"""A cell, a configuration and a metric added as data alone: files in a
data directory and entries in its BENCHMARK.json, no code edited."""

from __future__ import annotations

import json

from slam_bench.tests.conftest import run_cell

READER = '''
def read(ctx, name):
    """frames_seen.<x>: frames the window completed (a test metric)."""
    return float(len(ctx.latencies_s))
'''


def test_new_cell_config_and_metric(tiny, tmp_path, capsys):
    import shutil

    root = tmp_path / "d"
    shutil.copytree(tiny, root)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    cfg["pipeline"]["tps"]["nb_iters"] = 6
    (root / "configs" / "tiny6.json").write_text(json.dumps(cfg))
    doc["configs"].append({"name": "tiny6", "source": "test",
                           "file": "configs/tiny6.json",
                           "reduced": ["tps"], "why": "test"})
    doc["workloads"].append({"name": "tiny6-sway", "config": "tiny6",
                             "traffic": "tiny_sway", "chips": 1,
                             "why": "test"})
    (root / "checks" / "tiny6-sway.json").write_text(
        (root / "checks" / "tiny-sway.json").read_text())
    (root / "metrics" / "frames_seen.py").write_text(READER)
    doc["end_to_end"].append({"name": "frames_seen.window", "unit": "frames",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["tiny6-sway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    res = run_cell(root, "tiny6-sway", seconds=1.5, capsys=capsys)
    m = res["metrics"]
    assert m["frames_seen.window"]["value"] == res["attempted"] >= 1
    assert m["frames_seen.window"]["unit"] == "frames"
    assert {"frame_ms", "setup_s"} <= set(m)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"

"""A tiny copy of the benchmark's data for CPU runs of the harness: the
two configurations at 160x128 (fr1) and 320x240 (fr3, MOD on), short
traffic, the cells' own checks."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "slam_bench"
TINY_CAM = {"fx": 525.0 / 4, "fy": 525.0 / 4, "cx": 319.5 / 4,
            "cy": 239.5 / 4, "width": 160, "height": 128}
# MOD needs the box over a few cells to mark it: at 160x128 it marks none
MOD_CAM = {"fx": 535.4 / 2, "fy": 539.2 / 2, "cx": 320.1 / 2,
           "cy": 247.6 / 2, "width": 320, "height": 240}


def make_tiny(root: Path) -> Path:
    """BENCHMARK.json and the benchmark's data under `root`, with cells
    `tiny-sway` and `tiny_mod-walker` on 160x128 and 320x240 copies of
    the two configurations."""
    for d in ("metrics", "layers", "traffic", "checks"):
        shutil.copytree(BENCH / d, root / d, dirs_exist_ok=True)
    (root / "configs").mkdir(exist_ok=True)
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    pairs = (("tiny", "fr1_xyz", "sway", "fr1_xyz-sway", TINY_CAM),
             ("tiny_mod", "fr3_walking", "walker", "fr3_walking-walker",
              MOD_CAM))
    for name, src, mix, real, cam in pairs:
        c = json.loads((BENCH / "configs" / f"{src}.json").read_text())
        c["pipeline"]["cam"] = dict(cam)
        w = c["pipeline"]["mod"].get("weights_path")
        if w:
            c["pipeline"]["mod"]["weights_path"] = str(REPO / w)
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
        doc["configs"].append({"name": name, "source": "test",
                               "file": f"configs/{name}.json",
                               "reduced": [], "why": "test"})
        m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        m.update(poses=8, warmup_frames=3, trace_frames=2)
        (root / "traffic" / f"tiny_{mix}.json").write_text(json.dumps(m))
        cell = f"{name}-{mix}"
        ch = json.loads((BENCH / "checks" / f"{real}.json").read_text())
        ch.update(every=2, keep=2)
        (root / "checks" / f"{cell}.json").write_text(json.dumps(ch))
        doc["workloads"].append({"name": cell, "config": name,
                                 "traffic": f"tiny_{mix}", "chips": 1,
                                 "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


def run_cell(root: Path, cell: str, seed: int = 5, seconds: float = 2.0,
             trace: int = 0, capsys=None) -> dict:
    """main() on the CPU for a tiny cell; the result line as a dict."""
    from slam_bench import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  data=root, device="cpu")
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])

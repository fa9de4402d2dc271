"""The benchmark's data, found by name.

`BENCHMARK.json` at the root names the cells, the configurations, the
traffic mixes and the metrics. Everything that belongs to one of them sits
in a file of its own under the benchmark's folder:

* a configuration: `configs/<config>.json` (the `file` its entry names);
* a traffic mix: `traffic/<mix>.json`, read by `scene.render_stream`;
* a metric: `metrics/<name>.py`, or `metrics/<prefix>.py` for a name
  `<prefix>.<suffix>`, a module with `read(ctx, name)`;
* a layer that a metric's suffix names: `layers/<layer>.json`, the
  `ssf.<stage>` ranges it owns;
* a cell's comparison: `checks/<cell>.json`, the numbers compared with the
  reference and their limits, and optionally the event frames compared
  in every run (`run.Events`);
* a configuration's reference, where it is not `slam_bench/reference`:
  the package `slam_bench/<name>/` that the configuration file's
  "reference" key names (`check.reference_package`), with numbers of its
  own if it defines `numbers`;
* a fault planted to show that a cell's comparison catches it:
  `fault_plants/<name>.py` (`faults.lookup`).

So a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Bench:
    """BENCHMARK.json under `root`, with the benchmark's folder `data`
    (by default this package's folder) holding the files it names."""

    def __init__(self, root: Path, data: Path | None = None):
        self.root = Path(root)
        self.data = Path(data) if data is not None else HERE
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.config_entry(name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.data / "traffic" / f"{name}.json")
                          .read_text())

    def checks(self, cell: str) -> dict:
        return json.loads((self.data / "checks" / f"{cell}.json")
                          .read_text())

    def layer(self, name: str) -> dict:
        return json.loads((self.data / "layers" / f"{name}.json")
                          .read_text())

    def metrics_for(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: the end-to-end ones with
        `--trace 0`, the per-layer ones with `--trace 1`, each kept where
        its `workloads` list (if any) names the cell."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """The `read` function of the metric's module: metrics/<name>.py,
        else metrics/<prefix>.py for `<prefix>.<suffix>`."""
        base = self.data / "metrics"
        for stem in (metric, metric.split(".", 1)[0]):
            path = base / f"{stem}.py"
            if path.exists():
                spec = importlib.util.spec_from_file_location(
                    f"slam_bench_metric_{stem.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise KeyError(f"no reader for metric {metric!r} under {base}")


def build_config(cls, doc: dict, root: Path):
    """A `PipelineConfig` (the program's or the reference's class `cls`)
    from the configuration file's "pipeline" object: every key given
    replaces the default, nested objects build nested dataclasses, and an
    unknown key raises. `mod.weights_path` is taken relative to `root`."""

    def build(kind, d: dict, path: str):
        inst = kind()
        vals = {}
        names = {f.name for f in dataclasses.fields(kind)}
        for key, v in d.items():
            if key not in names:
                raise KeyError(f"{path}.{key}: not a field of {kind.__name__}")
            cur = getattr(inst, key)
            if dataclasses.is_dataclass(cur):
                vals[key] = build(type(cur), v, f"{path}.{key}")
            else:
                vals[key] = v
        return dataclasses.replace(inst, **vals)

    d = json.loads(json.dumps(doc["pipeline"]))
    mod = d.get("mod", {})
    if mod.get("weights_path"):
        mod["weights_path"] = str(Path(root) / mod["weights_path"])
    return build(cls, d, "pipeline")


def check_names(doc: dict) -> list[str]:
    """Every name and unit of a BENCHMARK.json document against the
    characters the contract allows; returns the offending entries."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in doc.get(key, []):
            if not NAME.match(e["name"]):
                bad.append(f"{key}: name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(f"{key}: unit {e['unit']!r}")
            for k in ("config", "traffic"):
                if k in e and not NAME.match(e[k]):
                    bad.append(f"{key}: {k} {e[k]!r}")
            for k in e.get("reduced", []):
                if not NAME.match(k):
                    bad.append(f"{key}: reduced {k!r}")
    return bad

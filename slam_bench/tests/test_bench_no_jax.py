"""Nothing the harness runs imports JAX or the JAX package, compared by
whole top-level module names."""

from __future__ import annotations

import subprocess
import sys

from slam_bench.tests.conftest import REPO

PROBE = """
import sys
import slam_bench.run, slam_bench.check, slam_bench.trace, slam_bench.scene
import slam_bench.calibrate, slam_bench.roofline, slam_bench.manifest
import slam_bench.reference.pipeline
import supersurfel_fusion_tpu_torch.pipeline
from slam_bench import manifest
b = manifest.Bench(manifest.HERE.parent)
for group in ("end_to_end", "per_layer"):
    for m in b.doc[group]:
        b.reader(m["name"])
from slam_bench.run import forbidden_modules
print(forbidden_modules())
"""


def _run(code: str) -> str:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_harness_imports_no_jax():
    assert _run(PROBE) == "[]"


def test_forbidden_compares_whole_top_level_names():
    code = ("import sys, types\n"
            "sys.modules['supersurfel_fusion_tpu_torch'] = types.ModuleType('x')\n"
            "sys.modules['jaxtyping'] = types.ModuleType('y')\n"
            "from slam_bench.run import forbidden_modules\n"
            "a = forbidden_modules()\n"
            "sys.modules['supersurfel_fusion_tpu.ops'] = types.ModuleType('z')\n"
            "sys.modules['jax'] = types.ModuleType('j')\n"
            "print([a, forbidden_modules()])")
    assert _run(code) == "[[], ['jax', 'supersurfel_fusion_tpu']]"

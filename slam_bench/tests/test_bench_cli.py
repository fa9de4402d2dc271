"""The command without a card, and in a directory that holds only the
benchmark's own files: a non-zero exit and no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

from slam_bench.tests.conftest import REPO

ARGS = ["-m", "slam_bench.run", "--workload", "fr1_xyz-sway", "--seed",
        str(2**31 + 17), "--seconds", "1", "--trace", "0"]


def _run(cwd, tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path), "BENCH_RUN": "x"}
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_without_result(tmp_path):
    import torch

    assert not torch.cuda.is_available()
    proc = _run(REPO, tmp_path)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_benchmark_files_alone_fail(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", alone)
    shutil.copytree(REPO / "slam_bench", alone / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(alone, tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""

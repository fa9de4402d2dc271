"""The control on the card at each cell's own size: the reference with
TF32 on, put in the program's place, fails the cell's limits, while the
program passes them on the same frames. Needs a CUDA card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        slam_bench/tests/test_bench_control_cuda.py
"""

from __future__ import annotations

import pytest

from slam_bench.tests.conftest import REPO

CELLS = ["fr1_xyz-sway", "fr3_walking-walker"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 exists only there)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    from slam_bench import check, manifest, run
    from slam_bench.scene import frame_index

    bench = manifest.Bench(REPO)
    w = bench.cell(cell)
    checks = bench.checks(cell)
    seed = 2**31 + 99
    sf, frames, mix, _, first = run.setup(bench, w, seed, card)
    sampler = run.Sampler(seed, int(checks["every"]), int(checks["keep"]))
    start = int(mix["warmup_frames"])
    for j in range(2 * int(checks["every"])):
        pre = sf.state if sampler.wants(j) else None
        out, _ = run.play(sf, *frames, start + j)
        if pre is not None:
            sampler.add((frame_index(start + j, len(frames[0])), pre, out,
                         sf.state))
        sampler.next_block(j)
    del sf
    ref = check.Reference(bench.config(w["config"]), REPO, card)
    samples = [first] + sampler.kept
    ok, shown = check.verdict(check.compare(samples, ref, frames),
                              checks["numbers"])
    assert ok, shown
    worst = check.control(samples, ref, frames)
    ok_c, shown_c = check.verdict(worst, checks["numbers"])
    assert not ok_c, shown_c

"""The ORB detector's CPU path and the kernel's build and binding, without
a card: the plain functions `features.detect_cells` runs on CPU tensors
equal the plain composition the kernel replaced (the benchmark's frozen
copy of the features), and the kernel's library is built for sm_90a
without fma contraction. Imports no JAX."""

import subprocess

import numpy as np
import pytest
import torch

from slam_bench.reference.config import VOConfig as RefVOConfig
from slam_bench.reference.ops import features as ref_features
from supersurfel_fusion_tpu_torch.config import VOConfig
from supersurfel_fusion_tpu_torch.ops import features, orb_cuda, tps_cuda

torch.set_num_threads(1)

BORDER = features._PATCH_R + 1


def textured(seed, H=480, W=640):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0) \
        + rng.uniform(0, 40, (H, W))
    return torch.from_numpy(img.astype(np.float32))


@pytest.mark.parametrize("seed,harris", [(3, True), (4, False)])
def test_cpu_path_matches_plain_composition(seed, harris):
    """Per level: `detect_cells` then `_top_cells` against the reference's
    FAST, Harris and `_select_level_keypoints`; then the whole
    `detect_and_describe`, bit for bit."""
    gray = textured(seed)
    cfg = VOConfig(harris_rank=harris)
    rcfg = RefVOConfig(harris_rank=harris)
    H, W = gray.shape
    levels = [gray] + [features.resize_bilinear(
        gray, *features._level_shape(H, W, lvl, cfg.scale_factor))
        for lvl in range(1, cfg.nb_levels)]
    picks = features.detect_cells(levels, cfg, BORDER)
    assert [p[0].shape[0] for p in picks] == orb_cuda.cell_counts(
        [tuple(img.shape) for img in levels], cfg.detect_cell)
    budgets = features._level_budgets(cfg.nb_features, cfg.nb_levels,
                                      cfg.scale_factor)
    for img, pick, budget in zip(levels, picks, budgets):
        hi, lo, score = ref_features.fast_scores(img, 15.0, 5.0)
        h = ref_features.harris_response(img) if harris else score
        want = ref_features._select_level_keypoints(
            hi, lo, score, h, budget, border=BORDER, cell=32)
        got = features._top_cells(*pick, img.shape[1], budget, 32)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    kt = features.detect_and_describe(gray, cfg)
    kr = ref_features.detect_and_describe(gray, rcfg)
    for name in kt._fields:
        assert torch.equal(getattr(kt, name), getattr(kr, name)), name
    assert int(kt.valid.sum()) > 300


def test_library_build_command(monkeypatch, tmp_path):
    """The kernel's source goes to nvcc with the port's flags (sm_90a, no
    fma contraction, as the bit-exact arithmetic needs) through
    `tps_cuda.build_library`, into a library keyed by source and flags."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(tps_cuda, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(tps_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tps_cuda.subprocess, "run", fake_run)
    path, _ = orb_cuda.build_library()
    assert orb_cuda.SOURCE.exists() and orb_cuda.SOURCE.name == "orb.cu"
    (cmd,) = calls
    assert cmd[0] == "nvcc" and cmd[-1] == str(orb_cuda.SOURCE)
    assert "--fmad=false" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert path.parent == tmp_path and path.name.startswith("liborb_")
    assert path.exists()
    # built once: the second call finds the library
    assert orb_cuda.build_library()[0] == path and len(calls) == 1


def test_binding_refuses_what_the_kernel_does_not_take():
    img = torch.zeros((64, 96))
    before = dict(orb_cuda.launch_counts)
    args = (BORDER, True, 15.0, 5.0)
    with pytest.raises(ValueError, match="detect_cell"):
        orb_cuda.detect([img], 33, *args)
    with pytest.raises(ValueError, match="levels"):
        orb_cuda.detect([img] * (orb_cuda.MAX_LEVELS + 1), 32, *args)
    with pytest.raises(ValueError, match="CUDA"):
        orb_cuda.detect([img], 32, *args)
    assert orb_cuda.launch_counts == before

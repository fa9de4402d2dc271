"""The ORB detection kernel (`csrc/orb.cu`) against its plain PyTorch
version, on a card. Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_orb_cuda.py

Without a CUDA device these tests skip (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from slam_bench.reference.config import VOConfig as RefVOConfig
from slam_bench.reference.ops import features as ref_features
from supersurfel_fusion_tpu_torch.config import VOConfig
from supersurfel_fusion_tpu_torch.ops import features, orb_cuda

BORDER = features._PATCH_R + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ORB kernel has no CPU mode")
    return torch.device("cuda")


def textured(seed, H=480, W=640):
    """A seeded textured image with a flat square: level 0's 32 px cells
    (4, 4) to (5, 5) lie inside it with a margin, so they hold no corner."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0) \
        + rng.uniform(0, 40, (H, W))
    img[96:224, 96:224] = 90.0
    return torch.from_numpy(img.astype(np.float32))


def pyramid(gray, cfg):
    H, W = gray.shape
    return [gray] + [features.resize_bilinear(
        gray, *features._level_shape(H, W, lvl, cfg.scale_factor))
        for lvl in range(1, cfg.nb_levels)]


@pytest.mark.cuda
@pytest.mark.parametrize("harris,cell,seed", [(True, 32, 3), (False, 32, 4),
                                              (True, 16, 5)])
def test_kernel_matches_plain_functions(cuda, harris, cell, seed):
    """Every level of the 640x480 pyramid: FAST hi/lo, the score, Harris,
    both keys on every pixel, and each cell's pick, bit for bit."""
    cfg = VOConfig(harris_rank=harris, detect_cell=cell)
    levels = pyramid(textured(seed).to(cuda), cfg)
    picks, maps = orb_cuda.detect(
        levels, cell, BORDER, harris, float(cfg.ini_th_fast),
        float(cfg.min_th_fast), maps=True)
    for img, m, got in zip(levels, maps, picks):
        hi, lo, score = features.fast_scores(img, float(cfg.ini_th_fast),
                                             float(cfg.min_th_fast))
        h = features.harris_response(img) if harris else score
        key_hi, key_lo = features._level_keys(hi, lo, score, h, BORDER)
        for k, plain in enumerate((hi.float(), lo.float(), score, h, key_hi,
                                   key_lo)):
            assert torch.equal(m[k], plain), (tuple(img.shape), k)
        for a, b in zip(got, features._cell_picks(key_hi, key_lo, cell)):
            assert torch.equal(a, b), tuple(img.shape)
    idx, val, rank = (torch.cat(t) for t in zip(*picks))
    assert int((rank >= 1000).sum()) > 100 and int((val > 0).sum()) > 200
    if cell == 32:
        # the flat square's cells: nothing, index 0
        flat = torch.tensor([4 * 20 + 4, 4 * 20 + 5, 5 * 20 + 4, 5 * 20 + 5],
                            device=cuda)
        assert torch.equal(idx[flat], torch.zeros_like(idx[flat]))
        assert torch.equal(val[flat], torch.zeros_like(val[flat]))


@pytest.mark.cuda
def test_detect_and_describe_card_matches_plain(cuda):
    """The card's keypoints equal the plain composition's on the card (the
    benchmark's frozen copy of the features) in every field, bit for bit.
    Against the CPU, positions, levels and validity are equal on every
    level, and scores and descriptors on level 0; the pyramid's matmuls
    (levels >= 1, up to 3.1e-5 apart on a 0-255 image) and the orientation
    moments' matmuls round differently on the card than on the CPU, with
    or without the kernel."""
    gray = textured(6)
    cfg = VOConfig()
    kc = features.detect_and_describe(gray.to(cuda), cfg)
    kr = ref_features.detect_and_describe(gray.to(cuda), RefVOConfig())
    for name in kc._fields:
        assert torch.equal(getattr(kc, name), getattr(kr, name)), name
    kcpu = features.detect_and_describe(gray, cfg)
    for name in ("xy", "valid", "level"):
        assert torch.equal(getattr(kc, name).cpu(), getattr(kcpu, name)), name
    top = kcpu.level == 0
    for name in ("score", "desc"):
        assert torch.equal(getattr(kc, name).cpu()[top],
                           getattr(kcpu, name)[top]), name
    torch.testing.assert_close(kc.score.cpu(), kcpu.score, rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(kc.angle.cpu(), kcpu.angle, rtol=0, atol=1e-4)
    assert int(kc.valid.sum()) > 300 and int(top.sum()) > 50


@pytest.mark.cuda
def test_one_launch_a_frame(cuda):
    cfg = VOConfig()
    orb_cuda.reset_launch_counts()
    for seed in (7, 8, 9):
        features.detect_and_describe(textured(seed).to(cuda), cfg)
        assert orb_cuda.launch_counts["orb_detect"] == seed - 6
    features.detect_and_describe(textured(7), cfg)     # the plain version
    assert orb_cuda.launch_counts == {"orb_detect": 3}


@pytest.mark.cuda
def test_wrapper_refuses_bad_input(cuda):
    gray = textured(3).to(cuda)
    args = (BORDER, True, 15.0, 5.0)
    with pytest.raises(ValueError, match="float32"):
        orb_cuda.detect([gray.double()], 32, *args)
    with pytest.raises(ValueError, match="contiguous"):
        orb_cuda.detect([gray.t()], 32, *args)
    with pytest.raises(ValueError, match="detect_cell"):
        features.detect_and_describe(gray, VOConfig(detect_cell=64))

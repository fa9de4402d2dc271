"""The sharded frame step on a CUDA card against the plain CPU path: one
rank over NCCL, two ranks sharing the card over gloo, and (on a host with
four cards) four ranks over NCCL, one card each, on the first frames of
the 640x480 revisit clip with ferns and loop closure on. Skipped without
a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

(imports no JAX, so it runs where JAX is not installed)."""

import os

import numpy as np
import pytest
import torch

from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.parallel.distributed import launch
from supersurfel_fusion_tpu_torch.tools.profile_frame import lc_config

from torch_parallel_ranks import pipeline_steps

N_FRAMES = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(cfg):
    return [(rgb, depth) for rgb, depth, _ in
            synthetic.revisit_frames(cfg.cam)[:N_FRAMES]]


def _check_against_cpu(card_ranks, cpu_ranks):
    """Every rank's pose within 2 mm of the CPU run's (the bound of
    chip_smoke.py's card-vs-CPU checks), the ranks bit-equal, the model's
    total within 1%."""
    for k in range(N_FRAMES):
        outs = [r["free"][k] for r in card_ranks]
        for o in outs[1:]:
            np.testing.assert_array_equal(o["R"], outs[0]["R"])
            np.testing.assert_array_equal(o["t"], outs[0]["t"])
            assert o["nb_total"] == outs[0]["nb_total"]
        ref = cpu_ranks[0]["free"][k]
        assert np.abs(outs[0]["t"] - ref["t"]).max() < 2e-3, k
        assert abs(outs[0]["nb_total"] - ref["nb_total"]) \
            <= 0.01 * ref["nb_total"], k


@pytest.mark.cuda
def test_one_nccl_rank_matches_cpu(cuda):
    cfg = lc_config()
    frames = _frames(cfg)
    card = launch(pipeline_steps, 1, "nccl", "cuda", args=(cfg, frames, None))
    cpu = launch(pipeline_steps, 1, "gloo", "cpu", args=(cfg, frames, None),
                 threads=0)
    _check_against_cpu(card, cpu)
    assert card[0]["keyframes"] == cpu[0]["keyframes"] >= 1


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_cpu(cuda):
    cfg = lc_config()
    frames = _frames(cfg)
    card = launch(pipeline_steps, 2, "gloo", "cuda", args=(cfg, frames, None))
    cpu = launch(pipeline_steps, 2, "gloo", "cpu", args=(cfg, frames, None),
                 threads=0)
    _check_against_cpu(card, cpu)
    assert sum(r["nb_local"] for r in card) == card[0]["free"][-1]["nb_total"]


@pytest.mark.cuda
def test_four_nccl_ranks_on_four_cards_match_cpu(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    cfg = lc_config()
    frames = _frames(cfg)
    card = launch(pipeline_steps, 4, "nccl", "cuda", args=(cfg, frames, None),
                  timeout_s=240)
    # a quarter of the host's cores per CPU rank
    cpu = launch(pipeline_steps, 4, "gloo", "cpu", args=(cfg, frames, None),
                 threads=max(1, (os.cpu_count() or 4) // 4), timeout_s=240)
    _check_against_cpu(card, cpu)
    assert sum(r["nb_local"] for r in card) == card[0]["free"][-1]["nb_total"]

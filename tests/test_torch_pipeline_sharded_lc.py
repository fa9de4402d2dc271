"""The sharded frame step of test_torch_pipeline_sharded.py in the JAX
tests' configuration with MOD, ferns and loop closure (128x96, 16
keyframes, min_frame_gap 1): the port on 2 gloo ranks against JAX's 2
devices from carried-over state, and the port on 1 rank against 2."""

import pytest
import torch

from test_torch_pipeline_sharded import (
    check_matches_jax,
    check_rank_counts,
    run_all,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return run_all(True)


def test_sharded_full_step_matches_jax(runs):
    check_matches_jax(runs)


def test_sharded_full_step_agrees_across_rank_counts(runs):
    check_rank_counts(runs)

"""The stub's frame step: `slam_bench.reference`'s, with the stamps of
the frames it ran in `STAMPS`, so that a test sees which package ran."""

from __future__ import annotations

from slam_bench.reference import pipeline as _reference
from slam_bench.reference.pipeline import init_state  # noqa: F401

STAMPS: list = []


def process_frame(state, rgb, depth, cfg):
    STAMPS.append(int(state.stamp))
    return _reference.process_frame(state, rgb, depth, cfg)

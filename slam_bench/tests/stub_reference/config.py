"""The stub's configuration: `slam_bench.reference`'s."""

from slam_bench.reference.config import PipelineConfig  # noqa: F401

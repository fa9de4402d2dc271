"""The configuration of the loop-closure cell's plain reference: the frozen
reference's dataclasses (`slam_bench/reference/config.py`), which hold
every field of the program's `PipelineConfig`, ferns and loop closure
included."""

from slam_bench.reference.config import (  # noqa: F401
    CameraIntrinsics,
    FernsConfig,
    FusionConfig,
    GenerationConfig,
    ICPConfig,
    MODConfig,
    PipelineConfig,
    TPSConfig,
    VOConfig,
)

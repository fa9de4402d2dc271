# Frozen copy of supersurfel_fusion_tpu_torch/__init__.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test. Its independence from the
# program rests on the repo's parity tests (tests/test_torch_*.py), which
# hold the port at that commit against the JAX package on the CPU.
"""PyTorch/CUDA port of the JAX package `supersurfel_fusion_tpu/`.

The same dense RGB-D SLAM frame step (TPS superpixels, supersurfels, sparse
VO, symmetric ICP, surfel fusion) in PyTorch, with the TPS iteration loop as
hand-written CUDA kernels for Hopper (`csrc/tps.cu`, bound in
`ops/tps_cuda.py`). Entry points take a `device` argument that defaults to
"cuda"; CPU runs must ask for `device="cpu"`.
"""

import torch

# Full-f32 contractions are load-bearing: plane-fit moments, ICP/PnP normal
# equations and orientation moments contract pixel-scale values, and reduced
# precision wrecks the trajectory (bf16 took TUM fr1 ATE from 0.02 m to
# 0.11 m in the JAX package). TF32 keeps about three decimal digits, so it is
# pinned off for both matmuls and cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from slam_bench.reference.config import (  # noqa: E402
    CameraIntrinsics,
    FusionConfig,
    ICPConfig,
    PipelineConfig,
    TPSConfig,
)

__all__ = [
    "CameraIntrinsics",
    "TPSConfig",
    "ICPConfig",
    "FusionConfig",
    "PipelineConfig",
]

# Frozen copy of supersurfel_fusion_tpu_torch/device.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. There is no silent CPU fallback:
    asking for CUDA on a machine without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev

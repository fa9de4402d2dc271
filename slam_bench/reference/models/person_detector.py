# Frozen copy of supersurfel_fusion_tpu_torch/models/person_detector.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Person detector for the semantics-assisted MOD.

Port of `supersurfel_fusion_tpu/models/person_detector.py`: a small
anchor-free fully-convolutional detector (CenterNet-style: stride-16 heat
map plus box size) on grey + depth. Four stride-2 3x3 convolutions with
ReLU, then a heat head and a size head; 3x3 non-maximum suppression and the
top `max_det` peaks give the boxes.

The convolutions run through `torch.nn.functional.conv2d` (the JAX package
computes them with XLA, outside any Pallas kernel). JAX's "SAME" padding
is asymmetric: for stride s, kernel k and size n the total pad is
max((ceil(n/s) - 1) * s + k - n, 0) and the low side gets total // 2, so
it is applied explicitly. The weights come from the committed `.npz`
(HWIO, turned into OIHW). `init_params` gives the JAX package's randomly
initialised training parameters (HWIO numpy arrays, its `jax.random`
draws made by `utils/prng.py`), and
`PersonDetector.forward_maps` the batched forward the trainer
(`tools/train_person_detector.py`) differentiates.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slam_bench.reference.device import resolve_device
from slam_bench.reference.utils import prng

Tensor = torch.Tensor

# (out_channels, stride) per stage; the input is grey + depth (2 channels)
_STAGES = [(16, 2), (32, 2), (64, 2), (96, 2)]
_HEAD_CH = 96


def init_params(key=None, in_ch: int = 2) -> dict:
    """The randomly initialised parameter dict (numpy arrays, HWIO): the
    JAX package's `init_params(key, in_ch)`, draw for draw (`utils/prng.py`).
    `key` defaults to `PRNGKey(0)`; each stage splits it once and draws its
    He-normal weights (std sqrt(2 / (9 c_in))) from the new subkey; the
    heads split it in three and draw at 0.01. The heat bias is -4 (a low
    prior), the other biases zero."""
    key = prng.PRNGKey(0) if key is None else np.asarray(key, np.uint32)
    params = {}
    c_in = in_ch
    for i, (c_out, _) in enumerate(_STAGES):
        key, k1 = prng.split(key)
        params[f"conv{i}_w"] = (prng.normal(k1, (3, 3, c_in, c_out))
                                * np.float32(np.sqrt(2.0 / (9 * c_in))))
        params[f"conv{i}_b"] = np.zeros((c_out,), np.float32)
        c_in = c_out
    key, k1, k2 = prng.split(key, 3)
    params["heat_w"] = prng.normal(k1, (3, 3, _HEAD_CH, 1)) * np.float32(0.01)
    params["heat_b"] = np.full((1,), -4.0, np.float32)
    params["size_w"] = prng.normal(k2, (3, 3, _HEAD_CH, 2)) * np.float32(0.01)
    params["size_b"] = np.zeros((2,), np.float32)
    return params


class Detections(NamedTuple):
    boxes: Tensor    # (K, 4) x0, y0, x1, y1 (pixels)
    scores: Tensor   # (K,)
    valid: Tensor    # (K,) bool


def _same_pad(x: Tensor, stride: int, k: int = 3) -> Tensor:
    """Pad (N, C, H, W) as XLA's "SAME" does for this stride and kernel."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):          # F.pad order: W, then H
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class PersonDetector(nn.Module):
    """Grey + depth -> up to `max_det` person boxes."""

    def __init__(self, in_ch: int = 2):
        super().__init__()
        convs = []
        c_in = in_ch
        for c_out, _ in _STAGES:
            convs.append(nn.Conv2d(c_in, c_out, 3))
            c_in = c_out
        self.stages = nn.ModuleList(convs)
        self.heat = nn.Conv2d(_HEAD_CH, 1, 3)
        self.size = nn.Conv2d(_HEAD_CH, 2, 3)
        # inference only: no autograd graph on the frame step (the trainer
        # switches gradients on for its own copy)
        self.requires_grad_(False)

    @staticmethod
    def from_params(params: dict) -> "PersonDetector":
        """Build from the JAX parameter dict (numpy arrays: `conv{i}_w`
        HWIO, `conv{i}_b`, `heat_w`/`heat_b`, `size_w`/`size_b`)."""
        det = PersonDetector(in_ch=np.shape(params["conv0_w"])[2])

        def load(conv: nn.Conv2d, name: str):
            w = np.asarray(params[f"{name}_w"], dtype=np.float32)
            b = np.asarray(params[f"{name}_b"], dtype=np.float32)
            conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(b.copy()))

        for i, conv in enumerate(det.stages):
            load(conv, f"conv{i}")
        load(det.heat, "heat")
        load(det.size, "size")
        return det

    def forward_maps(self, gray: Tensor, depth: Tensor):
        """Batched maps on the stride-16 grid: gray and depth (B, H, W) ->
        (heat logits (B, h, w), size (B, h, w, 2))."""
        x = torch.stack([gray / 255.0, torch.clamp(depth, 0, 5.0) / 5.0],
                        dim=1)
        for conv, (_, s) in zip(self.stages, _STAGES):
            x = F.relu(F.conv2d(_same_pad(x, s), conv.weight, conv.bias,
                                stride=s))
        x = _same_pad(x, 1)
        logits = F.conv2d(x, self.heat.weight, self.heat.bias)
        size = F.conv2d(x, self.size.weight, self.size.bias)
        return logits[:, 0], size.permute(0, 2, 3, 1)

    def maps(self, gray: Tensor, depth: Tensor):
        """(heat (h, w), size (h, w, 2)) on the stride-16 grid."""
        logits, size = self.forward_maps(gray[None], depth[None])
        return torch.sigmoid(logits[0]), size[0]

    def forward(self, gray: Tensor, depth: Tensor, max_det: int = 8,
                score_thresh: float = 0.3) -> Detections:
        H = gray.shape[0]
        heat, size = self.maps(gray, depth)
        hh, ww = heat.shape
        # 3x3 non-maximum suppression (zero outside) + top-k peaks
        p = F.pad(heat, (1, 1, 1, 1))
        is_peak = torch.ones_like(heat, dtype=torch.bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                is_peak &= heat >= p[1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]
        scores = torch.where(is_peak, heat, torch.zeros_like(heat))
        top_s, top_i = torch.topk(scores.reshape(-1), max_det)
        cy = torch.div(top_i, ww, rounding_mode="floor").to(torch.float32)
        cx = (top_i % ww).to(torch.float32)
        stride = H / hh
        wh = torch.abs(size.reshape(-1, 2)[top_i]) * stride
        bw, bh = wh[:, 0], wh[:, 1]
        x0 = cx * stride - bw / 2
        y0 = cy * stride - bh / 2
        boxes = torch.stack([x0, y0, x0 + bw, y0 + bh], dim=-1)
        return Detections(boxes=boxes, scores=top_s,
                          valid=top_s > score_thresh)


def load_params(path: str | Path) -> dict:
    """The checkpoint's network parameters as numpy arrays; `label_*` keys
    are training-label provenance, not parameters. A missing file raises."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"person detector weights not found: {path}")
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files
                if not k.startswith("label_")}


def load_detector(path: str | Path,
                  device: str | torch.device = "cuda") -> PersonDetector:
    """`PersonDetector` with the weights of the `.npz` at `path`, on the
    card unless `device` asks for the CPU (`device.resolve_device`)."""
    return PersonDetector.from_params(load_params(path)).to(
        resolve_device(device))

"""TUM RGB-D dataset loading: timestamp association and frame decoding.

A numpy-only copy of `supersurfel_fusion_tpu/io/tum.py` (the TUM tool
`associate.py` and the benchmark node's file loop of the reference). Pure
host-side Python/numpy: decodes 8-bit RGB and 16-bit depth PNGs with PIL
and yields numpy frames ready to ship to the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def read_trajectory_file(path: str) -> dict:
    """Read a TUM-format file `t tx ty tz qx qy qz qw` -> {t: 7-vector}."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.replace(",", " ").split()
            out[float(vals[0])] = np.array([float(v) for v in vals[1:8]])
    return out


def associate(ts_a: Sequence[float], ts_b: Sequence[float],
              offset: float = 0.0, max_difference: float = 0.02
              ) -> List[Tuple[float, float]]:
    """Greedy closest-timestamp matching (same contract as TUM associate.py)."""
    potential = [
        (abs(a - (b + offset)), a, b)
        for a in ts_a
        for b in ts_b
        if abs(a - (b + offset)) < max_difference
    ]
    potential.sort()
    used_a, used_b, matches = set(), set(), []
    for _, a, b in potential:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            matches.append((a, b))
    matches.sort()
    return matches


@dataclass
class TUMFrame:
    index: int
    timestamp: float          # rgb timestamp (trajectory is stamped with this)
    rgb: np.ndarray           # (H, W, 3) uint8
    depth: np.ndarray         # (H, W) float32 metres (0 = invalid)
    gt_pose: Optional[np.ndarray] = None  # (7,) tx ty tz qx qy qz qw


@dataclass
class TUMAssociation:
    rgb_ts: float
    rgb_file: str
    depth_ts: float
    depth_file: str
    gt: Optional[np.ndarray] = None  # (7,)


class TUMDataset:
    """Synchronous TUM RGB-D sequence reader.

    Prefers `associations_with_gt.txt` (format: `rgb_t rgb_f depth_t depth_f
    gt_t tx ty tz qx qy qz qw`, as consumed by the reference benchmark node),
    falls back to `associations.txt` or to associating rgb.txt/depth.txt.
    """

    def __init__(self, root: str, depth_scale: float = 1.0 / 5000.0):
        self.root = root
        self.depth_scale = depth_scale
        self.associations = self._load_associations()

    def _load_associations(self) -> List[TUMAssociation]:
        awg = os.path.join(self.root, "associations_with_gt.txt")
        assoc = os.path.join(self.root, "associations.txt")
        out: List[TUMAssociation] = []
        if os.path.exists(awg):
            with open(awg) as f:
                for line in f:
                    p = line.split()
                    if len(p) < 4:
                        continue
                    gt = np.array([float(v) for v in p[5:12]]) if len(p) >= 12 else None
                    out.append(TUMAssociation(float(p[0]), p[1], float(p[2]), p[3], gt))
        elif os.path.exists(assoc):
            with open(assoc) as f:
                for line in f:
                    p = line.split()
                    if len(p) >= 4:
                        out.append(TUMAssociation(float(p[0]), p[1], float(p[2]), p[3]))
        else:
            rgb = self._read_file_list(os.path.join(self.root, "rgb.txt"))
            depth = self._read_file_list(os.path.join(self.root, "depth.txt"))
            for a, b in associate(list(rgb), list(depth)):
                out.append(TUMAssociation(a, rgb[a], b, depth[b]))
        return out

    @staticmethod
    def _read_file_list(path: str) -> dict:
        out = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                out[float(p[0])] = p[1]
        return out

    def __len__(self) -> int:
        return len(self.associations)

    def load_frame(self, i: int) -> TUMFrame:
        if Image is None:  # pragma: no cover
            raise RuntimeError("PIL is required to decode TUM PNG frames")
        a = self.associations[i]
        rgb = np.asarray(Image.open(os.path.join(self.root, a.rgb_file)), dtype=np.uint8)
        depth_raw = np.asarray(Image.open(os.path.join(self.root, a.depth_file)))
        depth = depth_raw.astype(np.float32) * self.depth_scale
        return TUMFrame(i, a.rgb_ts, rgb[..., :3], depth, a.gt)

    def load_frame_raw(self, i: int) -> TUMFrame:
        """Like `load_frame` but keeps depth as raw uint16 counts — the
        pipeline converts on device (depth_scale applied in-graph), so only
        ~1.5 MB/frame crosses the host->device link instead of ~4.9 MB."""
        if Image is None:  # pragma: no cover
            raise RuntimeError("PIL is required to decode TUM PNG frames")
        a = self.associations[i]
        rgb = np.asarray(Image.open(os.path.join(self.root, a.rgb_file)), dtype=np.uint8)
        depth_raw = np.asarray(Image.open(os.path.join(self.root, a.depth_file)))
        return TUMFrame(i, a.rgb_ts, rgb[..., :3],
                        np.ascontiguousarray(depth_raw.astype(np.uint16)), a.gt)

    def frames(self, start: int = 0, stop: Optional[int] = None,
               step: int = 1) -> Iterator[TUMFrame]:
        stop = len(self) if stop is None else min(stop, len(self))
        for i in range(start, stop, step):
            yield self.load_frame(i)


def write_trajectory(path: str, stamps: Sequence[float],
                     poses: Sequence[np.ndarray]) -> None:
    """Write TUM format `t tx ty tz qx qy qz qw` (one pose per processed frame,
    like `supersurfel_fusion_rgbd_benchmark_node.cpp:727-729`)."""
    with open(path, "w") as f:
        for t, p in zip(stamps, poses):
            f.write(
                f"{t:.6f} " + " ".join(f"{v:.6f}" for v in np.asarray(p).ravel()) + "\n"
            )

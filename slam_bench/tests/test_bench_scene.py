"""The harness's torch renderer against the port's numpy scene."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import scene
from supersurfel_fusion_tpu_torch import synthetic
from supersurfel_fusion_tpu_torch.config import CameraIntrinsics

SWAY = {"fps": 30.0, "t_amp": [0.08, 0.04, 0.06], "t_freq": [2.1, 1.3, 1.7],
        "rot_axis": [0.3, 1.0, 0.1], "rot_amp": 0.03, "rot_freq": 1.9,
        "phase_frames": 600}
CAM = CameraIntrinsics(535.4 / 4, 539.2 / 4, 320.1 / 4, 247.6 / 4, 160, 120)
CAMD = {"fx": CAM.fx, "fy": CAM.fy, "cx": CAM.cx, "cy": CAM.cy,
        "width": CAM.width, "height": CAM.height}


def test_sway_is_synthetic_trajectory():
    for (Ra, ta), (Rb, tb) in zip(scene.sway_poses({"sway": SWAY}, 40),
                                  synthetic.trajectory(40)):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("k", [0, 7, 23])
@pytest.mark.parametrize("box", [False, True])
def test_render_within_one_count(k, box):
    R, t = synthetic.trajectory(k + 1)[k]
    if box:
        lo, hi = synthetic.box_bounds(k)
        want_rgb, want_d, _ = synthetic.render_dynamic(CAM, R, t, lo, hi)
        lo_t = torch.tensor(lo[None])
        hi_t = torch.tensor(hi[None])
    else:
        want_rgb, want_d = synthetic.render(CAM, R, t)
        lo_t = hi_t = None
    d, c = scene._cast(CAMD, torch.tensor(R[None]), torch.tensor(t[None]),
                       lo_t, hi_t, 0)
    rgb, depth = scene._encode(d, c)
    dd = np.abs(depth[0].numpy().astype(np.int64) - want_d.astype(np.int64))
    dc = np.abs(rgb[0].numpy().astype(np.int64) - want_rgb.astype(np.int64))
    assert dd.max() <= 1 and dc.max() <= 1


def test_box_triangle_wave_and_stream():
    box = {"size": [0.5, 1.2, 0.3], "z": 2.2, "floor_y": 0.9,
           "x_centre": 0.0, "amplitude": 0.6, "step": 0.02}
    xs = [0.5 * sum(scene.box_bounds(box, k)[i][0] for i in (0, 1))
          for k in range(130)]
    steps = np.abs(np.diff(xs))
    np.testing.assert_allclose(steps, 0.02, atol=1e-9)
    assert max(xs) == pytest.approx(0.6) and min(xs) == pytest.approx(-0.6)
    mix = {"poses": 5, "sway": SWAY, "box": box}
    a = scene.render_stream(CAMD, mix, 2**40 + 3, "cpu", batch=2)
    b = scene.render_stream(CAMD, mix, 2**40 + 3, "cpu", batch=4)
    c = scene.render_stream(CAMD, mix, 2**40 + 4, "cpu")
    assert a[0].dtype == np.uint8 and a[1].dtype == np.uint16
    assert a[0].shape == (5, 120, 160, 3) and a[1].shape == (5, 120, 160)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    assert [scene.frame_index(i, 4) for i in range(9)] == \
        [0, 1, 2, 3, 2, 1, 0, 1, 2]

"""The metric readers on a hand-made trace and a hand-made window."""

from __future__ import annotations

import statistics

import numpy as np
import pytest

from slam_bench import manifest, roofline
from slam_bench.run import Ctx
from slam_bench.tests.conftest import REPO
from slam_bench.trace import Trace

CARD = "NVIDIA H100 80GB HBM3"


def _trace() -> Trace:
    """Two frames on thread 1, 0.0-0.2 s: stages depth, tps, features,
    mod, icp, fusion; device operations linked to them, one overlapping
    another, and one linked to no stage."""
    ranges, calls, ops = [], [], []
    for f in range(2):
        b = 0.1 * f
        ranges.append(("bench.step", b, b + 0.09, 1))
        ranges.append(("bench.pose", b + 0.09, b + 0.1, 1))
        for name, s, e in (("depth", 0.00, 0.01), ("tps", 0.01, 0.03),
                           ("features", 0.03, 0.05), ("mod", 0.05, 0.06),
                           ("icp", 0.06, 0.08), ("fusion", 0.08, 0.09)):
            ranges.append((f"ssf.{name}", b + s, b + e, 1))
            # three launches per stage, one wait in mod
            for k in range(3):
                calls.append(("cudaLaunchKernel", b + s + 0.001 * (k + 1),
                              b + s + 0.001 * (k + 1) + 1e-5, 1))
        calls.append(("cudaStreamSynchronize", b + 0.055, b + 0.056, 1))
        # a launch on another thread inside a stage's time is not counted
        calls.append(("cudaLaunchKernel", b + 0.02, b + 0.0201, 2))
        # the pose read's copy and wait are the harness's
        calls.append(("cudaStreamSynchronize", b + 0.095, b + 0.096, 1))
        ops += [("k_depth", b + 0.002, b + 0.004, "ssf.depth"),
                ("tps_iteration", b + 0.012, b + 0.013, "ssf.tps"),
                ("k_plane", b + 0.0125, b + 0.014, "ssf.tps"),
                ("k_feat", b + 0.031, b + 0.041, "ssf.features"),
                ("k_mod", b + 0.051, b + 0.052, "ssf.mod"),
                ("k_icp", b + 0.061, b + 0.063, "ssf.icp"),
                ("k_fuse", b + 0.081, b + 0.082, "ssf.fusion"),
                ("cat", b + 0.091, b + 0.0915, None)]
    return Trace(ranges=ranges, calls=calls, ops=ops, frames=2, t0=0.0,
                 t1=0.2)


def _ctx(trace=None, lat=None, window_s=None, labels=()):
    from supersurfel_fusion_tpu_torch.config import PipelineConfig

    return Ctx(bench=manifest.Bench(REPO), cell={}, cfg=PipelineConfig(),
               card=CARD, setup_s=12.5, latencies_s=lat or [],
               window_s=window_s or 0.0, trace=trace, labels=list(labels))


def read(name, ctx):
    return manifest.Bench(REPO).reader(name)(ctx, name)


def test_range_sums_per_layer():
    ctx = _ctx(_trace())
    # segmentation owns depth and tps: (0.01 + 0.02) s per frame
    assert read("host_ms.segmentation", ctx) == pytest.approx(30.0)
    assert read("host_ms.vo", ctx) == pytest.approx(20.0)
    assert read("host_ms.mod", ctx) == pytest.approx(10.0)
    # device time linked to the layer's stages, summed (not a union)
    assert read("dev_ms.segmentation", ctx) == pytest.approx(2 + 1 + 1.5)
    assert read("dev_ms.vo", ctx) == pytest.approx(10.0)
    assert read("dev_ms.icp", ctx) == pytest.approx(2.0)
    assert read("dev_ms.fusion", ctx) == pytest.approx(1.0)


def test_launches_and_waits_inside_the_step():
    ctx = _ctx(_trace())
    assert read("launches_per_frame", ctx) == pytest.approx(18.0)
    assert read("host_waits_per_frame", ctx) == pytest.approx(1.0)


def test_busy_union_and_idle_share():
    tr = _trace()
    # per frame: 2 + (1 + 1.5 - 0.5 overlap) + 10 + 1 + 2 + 1 + 0.5 ms
    busy = 2 + 2.0 + 10 + 1 + 2 + 1 + 0.5
    assert tr.busy_s() == pytest.approx(2 * busy * 1e-3)
    # against an unprofiled stretch of 40 ms per frame, not the traced 100
    ctx = _ctx(tr, lat=[0.04] * 10, window_s=0.4)
    assert read("device_idle_share", ctx) == pytest.approx(
        100 * (1 - busy / 40.0))
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k_feat", pytest.approx(0.02)]
    idle = dict(bd["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(0.2 - 2 * busy * 1e-3)
    # each gap goes to the range open at its midpoint: k_feat to k_mod
    # (41-51 ms) to features; the pose read's gap runs to the next frame's
    # first kernel, or to the stretch's end
    assert idle["ssf.features"] == pytest.approx(2 * 10e-3)
    assert idle["ssf.tps"] == pytest.approx(2 * 17e-3)
    assert idle["bench.pose"] == pytest.approx(10.5e-3 + 8.5e-3)


def test_frame_ms_and_p90_over_all_frames():
    lat = [0.2] * 18 + [0.3, 0.5]
    ctx = _ctx(lat=lat, window_s=sum(lat) + 0.01)
    assert read("frame_ms", ctx) == pytest.approx(1e3 * ctx.window_s / 20)
    want = statistics.quantiles([1e3 * x for x in lat], n=10,
                                method="inclusive")[8]
    assert read("frame_ms_p90", ctx) == pytest.approx(want)
    assert 200 < want < 500
    assert read("setup_s", ctx) == 12.5
    assert read("frame_ms_p90", _ctx(lat=[0.2] * 5, window_s=1.0)) is None


def test_tps_roofline():
    lab = np.repeat(np.repeat(np.arange(40 * 30).reshape(30, 40), 16, 0),
                    16, 1)
    ctx = _ctx(_trace(), labels=[lab, lab])
    least, bound = roofline.tps_frame_bound_s(480, 640, 16, 10,
                                              roofline.boundary_count(lab),
                                              CARD)
    assert bound == "bytes"
    # 5 + 5 iterations, 6 + 6 merges; bytes per pass from the shapes
    npx, tab = 480 * 640, 9 * 30 * 40 * 4
    by = (5 * (npx * 20 + tab) + 5 * (npx * 28 + tab)
          + 6 * (npx * 16 + tab + tab // 3) + 6 * (npx * 24 + tab))
    assert least == pytest.approx(by / 3.35e12)
    # the tps range holds 2.5 ms of device time per frame
    assert read("tps_roofline", ctx) == pytest.approx(100 * least / 2.5e-3)


def test_readers_find_nothing_without_a_trace():
    ctx = _ctx(None, lat=[0.1] * 20, window_s=2.0)
    for name in ("host_ms.vo", "dev_ms.vo", "launches_per_frame",
                 "host_waits_per_frame", "device_idle_share",
                 "tps_roofline"):
        assert read(name, ctx) is None
    # a layer whose stages ran no range reads nothing, not 0
    tr = _trace()
    tr.ranges = [r for r in tr.ranges if r[0] != "ssf.mod"]
    assert read("host_ms.mod", _ctx(tr)) is None

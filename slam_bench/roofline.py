# The byte and operation counts of one TPS iteration and one merge are
# taken from chip_smoke.py:462-480 at commit 37bce59 (each input read once,
# each output written once; operations from the data where they depend on
# it), with the RGB pass's variants written out by the same rule. The peaks
# are NVIDIA's data sheet for the H100 SXM part at its 700 W limit.
"""The yardstick of the kernel metrics: the chip's peaks, and the work the
TPS loop's algorithm needs for one frame.

`tps_frame_bound_s` gives the least time one frame's TPS passes could take
on the chip: for each pass the larger of its bytes over the HBM bandwidth
and its operations over the float32 peak, summed over the passes that
`TPSConfig` implies. It counts the algorithm's work, so it is the same
whatever code implements the loop.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB, dense rates, 700 W (NVIDIA H100 data sheet)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops": 67e12,
                              "power_limit_w": 700.0},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks(card: str) -> dict:
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])


def tps_passes(nb_iters: int) -> dict:
    """Passes of one frame's TPS loop: an RGB-only run of nb_iters // 2
    iterations, then an RGBD run of the rest, each run one merge before
    its iterations and one after each (`ops/tps_cuda.py:_segment`)."""
    n_rgb = nb_iters // 2
    n_rgbd = nb_iters - n_rgb
    return {"iter_rgb": n_rgb, "merge_rgb": n_rgb + 1,
            "iter_rgbd": n_rgbd, "merge_rgbd": n_rgbd + 1}


def tps_pass_work(kind: str, H: int, W: int, cs: int,
                  boundary_px: float) -> tuple[float, float]:
    """(bytes, operations) of one pass at H x W with cell size cs.

    An iteration reads rgb (3 f32) and the labels (i32), writes the labels,
    reads the (9, GH, GW) table once; the RGBD iteration also reads the
    disparity and writes the inliers (f32). Operations: a 12-read stencil
    and the inlier test per pixel, and up to 5 energies of ~45 operations
    on each boundary pixel. A merge reads rgb and the labels and writes the
    table; the RGBD merge also reads the disparity and the inliers, the
    RGB merge reads the three plane channels it keeps. 35 operations per
    pixel."""
    npx = H * W
    tab = 9 * (H // cs) * (W // cs) * 4
    if kind == "iter_rgbd":
        return npx * (3 * 4 + 4 + 4) + tab + npx * (4 + 4), \
            22 * npx + 5 * 45 * boundary_px
    if kind == "iter_rgb":
        return npx * (3 * 4 + 4) + tab + npx * 4, \
            22 * npx + 5 * 45 * boundary_px
    if kind == "merge_rgbd":
        return npx * (3 * 4 + 4 + 4 + 4) + tab, 35 * npx
    if kind == "merge_rgb":
        return npx * (3 * 4 + 4) + tab + tab // 3, 35 * npx
    raise ValueError(kind)


def tps_frame_bound_s(H: int, W: int, cs: int, nb_iters: int,
                      boundary_px: float, card: str) -> tuple[float, str]:
    """The least time of one frame's TPS passes on the card, and which
    bound ("bytes" or "operations") holds for most of it."""
    pk = peaks(card)
    total, by_bytes, by_ops = 0.0, 0.0, 0.0
    for kind, n in tps_passes(nb_iters).items():
        b, o = tps_pass_work(kind, H, W, cs, boundary_px)
        tb, to = b / pk["hbm_bytes_per_s"], o / pk["fp32_flops"]
        total += n * max(tb, to)
        by_bytes += n * tb
        by_ops += n * to
    return total, "bytes" if by_bytes >= by_ops else "operations"


def boundary_count(labels) -> int:
    """Pixels with a 4-neighbour of another label, out of the image
    counting as another label (`ops/tps.py:boundary_count` > 0), from a
    numpy (H, W) integer array."""
    import numpy as np

    lab = np.pad(np.asarray(labels).astype(np.int64), 1, constant_values=-1)
    c = lab[1:-1, 1:-1]
    b = ((lab[:-2, 1:-1] != c) | (lab[2:, 1:-1] != c)
         | (lab[1:-1, :-2] != c) | (lab[1:-1, 2:] != c))
    return int(b.sum())

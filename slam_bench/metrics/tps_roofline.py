"""tps_roofline: the least time one frame's TPS passes could take on the
card (`roofline.tps_frame_bound_s`: the larger of bytes over HBM bandwidth
and operations over the float32 peak, per pass, for the passes TPSConfig
implies, with the boundary pixels of the traced frames' labels) over the
device time per frame of every operation in the `ssf.tps` range, in %.
Bound by bytes at 640x480; the peaks are those of the 700 W part."""

from slam_bench import roofline


def read(ctx, name):
    tr = ctx.trace
    if tr is None or not tr.frames or not ctx.labels:
        return None
    dev = tr.device_s(["tps"]) / tr.frames
    if dev <= 0:
        return None
    cam, tps = ctx.cfg.cam, ctx.cfg.tps
    bpx = sum(roofline.boundary_count(x) for x in ctx.labels) \
        / len(ctx.labels)
    least, _ = roofline.tps_frame_bound_s(cam.height, cam.width,
                                          tps.cell_size, tps.nb_iters, bpx,
                                          ctx.card)
    return 100.0 * least / dev

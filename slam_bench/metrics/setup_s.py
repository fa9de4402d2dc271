"""setup_s: process start (the harness's first line) until the window
opens: imports, the CUDA context, the program's kernel build or cache,
the detector's weights, rendering the traffic and the warm-up frames."""


def read(ctx, name):
    return ctx.setup_s

"""The device's idle share of the traced window: 1 - the union of the
device intervals (kernels, copies, sets) over the window's length."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)

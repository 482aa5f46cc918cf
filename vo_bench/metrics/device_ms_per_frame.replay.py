"""Device busy time per frame over the profiled replay sub-window: the card's own work
a frame (kernels, copies, merged where they overlap), in ms. Moves ``frames_per_s``."""


def read(ctx):
    if ctx.mode != "replay" or ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    return ctx.trace["busy_us"] / ctx.trace["frames"] / 1e3

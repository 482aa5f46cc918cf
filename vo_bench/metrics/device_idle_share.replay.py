"""Share of the profiled replay sub-window (whole chunks, read-backs and uploads
included) in which no operation ran on the card: 1 - merged device busy time / the
sub-window's host-clock length. Moves ``frames_per_s``."""


def read(ctx):
    if ctx.mode != "replay" or ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    return 1.0 - ctx.trace["busy_us"] / ctx.trace["window_us"]

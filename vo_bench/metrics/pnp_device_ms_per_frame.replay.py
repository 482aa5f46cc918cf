"""Device time of the per-frame step's PnP-RANSAC stage (``lcvo.pnp``: P3P with its
Durand-Kerner loop over the hypothesis batch, MSAC scoring, the refit) over the profiled
replay sub-window, per frame, in ms, labelled as ``klt_device_ms_per_frame.replay``.
Moves ``frames_per_s``."""

from vo_bench import stages


def read(ctx):
    if ctx.mode != "replay" or ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    got = stages.totals(ctx.trace, "process_frame")
    if got is None or not ctx.trace["frames"]:
        return None
    return got[1].get("lcvo.pnp", 0.0) / ctx.trace["frames"] / 1e3

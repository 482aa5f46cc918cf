"""Device time of the per-frame step's KLT stage (``lcvo.klt``: the pyramidal tracker over
tracks and candidates) over the profiled replay sub-window, per frame, in ms: the kernels
of each ``process_frame`` replay labelled by the stage they were captured in
(``vo_bench/stages.py``). Silent where any replay's kernels do not match the program's
registry. Moves ``frames_per_s``."""

from vo_bench import stages


def read(ctx):
    if ctx.mode != "replay" or ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    got = stages.totals(ctx.trace, "process_frame")
    if got is None or not ctx.trace["frames"]:
        return None
    return got[1].get("lcvo.klt", 0.0) / ctx.trace["frames"] / 1e3

"""Device time of one keyframe step (the ``ba_step`` graph: the window push and its
Schur-complement LM refine, with its write-back) over the profiled replay sub-window: the
kernels of every ``ba_step`` replay there, matched against the program's registry, over
the replays' count, in ms. 0 where the sub-window holds no keyframe. Moves
``frames_per_s``."""

from vo_bench import stages


def read(ctx):
    if ctx.mode != "replay" or ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    got = stages.totals(ctx.trace, "ba_step")
    if got is None:
        return None
    n, by = got
    return sum(by.values()) / n / 1e3 if n else 0.0

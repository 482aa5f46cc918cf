"""How much later a keyframe's pose comes than another frame's on the live path: the
median latency of the frames whose step ends on the BA cadence minus the median of the
other steps' frames, in ms. Only a configuration with BA has keyframes. Moves
``latency_p50_ms``, the end-to-end latency its one cell reports."""

import statistics


def read(ctx):
    if ctx.mode != "live" or not ctx.cfg.ba.enabled:
        return None
    kf = [ms for ms, key in ctx.latencies if key]
    other = [ms for ms, key in ctx.latencies if not key]
    if not kf or not other:
        return None
    return statistics.median(kf) - statistics.median(other)

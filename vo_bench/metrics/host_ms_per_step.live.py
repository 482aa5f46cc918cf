"""The host's time in one ``VisualOdometry.step`` call, from the call to its return and
before the pose is read back (the harness's own span, outside the profiled steps),
median over the window's steps, in ms. Moves ``latency_p50_ms``."""

import statistics


def read(ctx):
    if ctx.mode != "live" or not ctx.host_step_ms:
        return None
    return statistics.median(ctx.host_step_ms)

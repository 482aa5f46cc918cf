"""Device busy time per frame over a profiled run of live steps, in ms: the card's own
work a frame on the per-frame path. Moves ``latency_p50_ms``."""


def read(ctx):
    if ctx.mode != "live" or ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    return ctx.trace["busy_us"] / ctx.trace["frames"] / 1e3

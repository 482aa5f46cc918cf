"""The 95th percentile of the live path's latency (pose on the host minus frame due), in
ms, over the frames of the window before the profiler starts. Where a cell's live tail
swings too far from run to run to hold a bound (a stall of the host backs the queue up
for seconds), it stands here beside the cell's ``latency_p50_ms``, which it moves."""

from vo_bench import stats


def read(ctx):
    if ctx.mode != "live" or not ctx.latencies:
        return None
    return stats.percentile([ms for ms, _ in ctx.latencies], 95)

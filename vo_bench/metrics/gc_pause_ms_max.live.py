"""The longest garbage collection of the Python host loop between the live window's first
step and the profiler's start, from the program's flight recorder, in ms; 0 where none
ran. A pause holds every frame due behind it. Moves ``latency_p50_ms``."""

from vo_bench import stages


def read(ctx):
    if ctx.mode != "live" or ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    got = stages.window(len(ctx.host_step_ms))
    if got is None:
        return None
    return max((e.gc_ns for e in got[1]), default=0) / 1e6

"""``extract_blocks``' share of its roofline over the profiled replay sub-window, in %:
the bytes each launch must move (``vo_bench/roofline.py::bound_bytes`` at the launch's own
image, centers, S and pad, as the reference's replay of the same chunks called it) at
the card's 3.35 TB/s, over the durations of the trace's ``extract_blocks`` kernels.
Silent when the trace holds no launch of the kernel or not one launch for each of the
reference's calls. Moves ``frames_per_s``."""

from vo_bench.roofline import HBM_BYTES_PER_S, bound_bytes


def read(ctx):
    if ctx.mode != "replay" or ctx.trace is None or not ctx.calls.get("extract_blocks"):
        return None
    us = [e - s for name, s, e in ctx.trace["device_events"] if "extract_blocks" in name]
    calls = ctx.calls["extract_blocks"]
    if len(us) != len(calls) or sum(us) <= 0:
        return None
    moved = sum(bound_bytes(*args, **kw) for args, kw in calls)
    return 100.0 * moved / HBM_BYTES_PER_S / (sum(us) * 1e-6)

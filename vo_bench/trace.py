"""What a traced run reads from ``torch.profiler``: the device's busy time over the
traced sub-window (device intervals merged, as the port's ``chip_smoke.py::
_profile_summary`` merges them), the kernels' times, the idle gaps named by what the host
was doing in them, and every device and host event as it was recorded, for the per-layer
metrics' readers to pick from."""

from __future__ import annotations

from collections import defaultdict


def _merged(spans: list) -> list:
    """Sorted (start, end) intervals merged where they overlap."""
    out: list = []
    for s0, e0 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return out


def summarize(prof, window_us: float, frames: int) -> dict:
    """The traced sub-window of ``frames`` frames and ``window_us`` microseconds of host
    clock: device busy microseconds, device ops, time by kernel name, idle gaps (each
    named by the innermost host operation running at its middle), and the raw events:
    ``device_events`` and ``host_events``, ``(name, start_us, end_us)`` in order of
    start."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("vo_bench."):     # user spans echo on the device
                dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    busy_iv = _merged([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in busy_iv)
    by_name: dict = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += e - s
    gaps = sorted(((e0, s1) for (_, e0), (s1, _) in zip(busy_iv, busy_iv[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for e0, s1 in gaps:
        mid = 0.5 * (e0 + s1)
        inside = [h for h in host if h[0] <= mid <= h[1]]
        name = max(inside, key=lambda h: h[0])[2] if inside else "host: no operation"
        named.append((name, (s1 - e0) * 1e-6))
    return {
        "frames": frames, "window_us": window_us, "busy_us": busy, "device_ops": len(dev),
        "top_ops": sorted(((n, v * 1e-6) for n, v in by_name.items()), key=lambda kv: -kv[1]),
        "gaps": named,
        "device_events": [(n, s, e) for s, e, n in sorted(dev)],
        "host_events": [(n, s, e) for s, e, n in sorted(host)],
    }

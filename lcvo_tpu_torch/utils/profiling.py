"""Tracing / profiling subsystem (port of ``lcvo_tpu/utils/profiling.py``).

- :func:`trace` — context manager capturing a ``torch.profiler`` trace (a Chrome /
  Perfetto ``trace.json`` in ``log_dir``) around any region, e.g. N steps of the frame loop.
- :func:`annotate` — named trace spans (``torch.profiler.record_function``) so host-side
  stages (decode, upload) show up alongside device ops in the timeline; the step's own
  ``lcvo.*`` stage spans are such spans.
- :class:`StageTimer` — steady-state wall timing of callables with warm-up, fenced with
  ``torch.cuda.synchronize()`` when the device is CUDA, for per-stage budgets.
- :func:`cost_analysis` — FLOPs of one eager call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions and attention: the
  ops it has formulas for), and the bytes of the call's tensor arguments and results, the
  least it can move. The reference reads both from the compiled executable; an eager
  program has no such record, so bytes really accessed are absent from the dict, not
  guessed.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from lcvo_tpu_torch.core.state import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed region into ``log_dir/trace.json``
    (host activity always, device activity when CUDA is there). Yields the profiler, so
    the caller can read ``key_averages()`` after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span visible in the trace timeline (host + device correlation)."""
    return torch.profiler.record_function(name)


@dataclass
class StageTimer:
    """Steady-state timing of callables: warm-up excluded, device work fenced with
    ``torch.cuda.synchronize()`` when ``device`` is CUDA (nothing to fence on the CPU).
    Accumulates named results."""

    warmup: int = 2
    iters: int = 20
    device: str | torch.device = "cuda"
    results: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure(self, name: str, fn, *args, **kw) -> float:
        for _ in range(self.warmup):
            fn(*args, **kw)
        self._fence()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn(*args, **kw)
        self._fence()
        dt = (time.perf_counter() - t0) / self.iters
        self.results[name] = dt
        return dt

    def report(self) -> str:
        total = sum(self.results.values())
        lines = [f"{k:32s} {v * 1e3:9.3f} ms  {100 * v / total:5.1f}%" for k, v in self.results.items()]
        lines.append(f"{'total':32s} {total * 1e3:9.3f} ms")
        return "\n".join(lines)


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(x) for x in tree)
    return 0


def cost_analysis(fn, *args, **kw) -> dict:
    """``{"flops", "bytes_in_out"}`` of one call ``fn(*args, **kw)``: FLOPs as
    ``FlopCounterMode`` counts them, and the bytes of the tensors that go in and come
    out (each read or written once: a lower bound on traffic, not a measurement of it)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kw)
    return {
        "flops": float(counter.get_total_flops()),
        "bytes_in_out": float(_tensor_bytes(args) + _tensor_bytes(kw) + _tensor_bytes(out)),
    }


def flops_summary(fn, *args, **kw) -> str:
    ca = cost_analysis(fn, *args, **kw)
    fl, by = ca["flops"], ca["bytes_in_out"]
    return (f"flops={fl:.3e} bytes_in_out={by:.3e} "
            f"arithmetic_intensity<={fl / by if by else float('nan'):.2f}")

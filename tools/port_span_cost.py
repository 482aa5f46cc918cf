#!/usr/bin/env python3
"""Host time that the port's span sites and flight recorder (``utils/profiling.py``) add
to a frame, with no profiler running and under one.

Each path is the sequence of sites that ``pipeline.VisualOdometry`` and
``utils/graphs.CompiledStep`` pass, with empty bodies, timed in a loop (best of 5); the
same bodies called as the code called them before the sites were there are timed beside
it, and the cost is the difference:

- ``live``: one ``step`` (its recorder entry, ``vo.keys``, ``vo.upload``, one compiled
  step with its ``graph.launch``) and the live loop's ``vo.health`` read;
- ``replay``: one chunk of 16 (its entry, keys, upload, the draws' and 16 steps'
  compiled calls, the read-back, ``vo.emit``), per frame;
- ``gc``: the two callbacks of one collection.

    python3 tools/port_span_cost.py [--out chiprun_out/span_cost.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from lcvo_tpu_torch.utils import profiling as P  # noqa: E402


def nothing(*_):
    return None


def compiled():
    """A compiled step's call as ``CompiledStep.__call__`` makes it: one test, then its
    ``_call`` (the copy in) and ``_replay`` (the launch, the output clones)."""
    if P.tracing():
        return P.within("graph.step", _call, True)
    return _call(False)


def _call(traced: bool):
    P.within("graph.copy_in", nothing, None) if traced else nothing(None)
    return _replay(traced)


def _replay(traced: bool):
    P.within("graph.launch", nothing, None)
    return P.within("graph.copy_out", nothing, None) if traced else nothing(None)


def compiled_bare():
    """The same before the sites: ``_assign``, then ``_replay`` with its launch."""
    nothing(None)
    return _replay_bare()


def _replay_bare():
    return nothing(None)


def _next_uniforms():
    return nothing(nothing())


def _step_body(image):
    P.lap("vo.keys", _next_uniforms)
    P.lap("vo.upload", nothing, image)
    return compiled()


def live():
    P.call("step", 0, 1, _step_body, None)
    P.within("vo.health", int, 0)


def live_bare():
    nothing(nothing())
    nothing(None)
    compiled_bare()
    int(0)


def _chunk_body():
    with P.span("vo.keys"):
        nothing()
    with P.span("vo.upload"):
        nothing()
    for _ in range(17):                       # the draws and 16 steps
        compiled()
    with P.span("vo.readback"):
        nothing()
    with P.span("vo.emit"):
        nothing()


def replay_chunk():
    P.call("chunk", 0, 1, _chunk_body)


def replay_chunk_bare():
    nothing()
    nothing()
    for _ in range(17):
        compiled_bare()
    nothing()
    nothing()


def gc_pair():
    P._on_gc("start", {"generation": 0})
    P._on_gc("stop", {"generation": 0})


def per(fn, k: int, reps: int = 5) -> float:
    """µs a call of ``fn``, best of ``reps`` loops of ``k``."""
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(k):
            fn()
        best = min(best, (time.perf_counter() - t) / k)
    return best * 1e6


def costs(n: int = 200_000) -> dict:
    out = {"empty_call_us": per(nothing, n), "clock_read_us": per(time.perf_counter_ns, n)}
    for name, fn, bare, frames in (("live", live, live_bare, 1),
                                   ("replay", replay_chunk, replay_chunk_bare, 16)):
        k = n // frames
        with_sites, without = per(fn, k) / frames, per(bare, k) / frames
        out[f"{name}_us_per_frame"] = with_sites - without
        out[f"{name}_with_sites_us"], out[f"{name}_bare_us"] = with_sites, without
    out["gc_callbacks_us"] = per(gc_pair, n)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["live_traced_us_per_frame"] = per(live, 2000, reps=3) - out["live_bare_us"]
        out["replay_traced_us_per_frame"] = per(replay_chunk, 200, reps=3) / 16 - out[
            "replay_bare_us"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = costs()
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The program's own spans and counters, as the per-layer readers take them.

The port keeps a stage registry and a flight recorder in ``lcvo_tpu_torch.utils.profiling``
(``STAGES``, ``recorded()``). A reader reaches them through ``sys.modules`` alone: the
harness has imported the program, a reader never imports it, so a ``control`` run (no
program loaded) and a program without them read ``None``.

- :func:`replays`: each replay of a captured graph in a trace's device events, every
  event labelled with the stage its node was captured in. A replay runs its nodes in
  capture order on one stream (a captured graph is a chain), so the visible nodes of the
  registry (kernels, copies, memsets) must appear back to back in the device events,
  name for name (kernels) and kind for kind (copies, memsets); the replays found must
  number the program's ``graph.<name>`` spans in the trace. Anything else reads
  ``None``. :func:`totals` sums them by stage.
- :func:`window`: the recorder's ``step`` entries of a live window before the profiler
  started, and the collections among them.
"""

from __future__ import annotations

import sys

PROGRAM = "lcvo_tpu_torch.utils.profiling"
VISIBLE = ("kernel", "memcpy", "memset")      # graph nodes the profiler records on the card


def program():
    """The program's profiling module, where the process has loaded it."""
    return sys.modules.get(PROGRAM)


def registry(graph: str):
    """``STAGES[graph]`` of the program, or ``None``."""
    stages = getattr(program(), "STAGES", None)
    return stages.get(graph) if isinstance(stages, dict) else None


def _labels(reg: dict) -> list:
    """(node type, kernel name, stage) of each node the profiler records, in capture
    order."""
    stage_of = [None] * len(reg["nodes"])
    for stage, first, last in reg["stages"]:
        for i in range(first, last + 1):
            stage_of[i] = stage
    return [(kind, name, stage_of[i]) for i, (kind, name) in enumerate(reg["nodes"])
            if kind in VISIBLE]


def _same(kind: str, name, event: str) -> bool:
    """Whether a trace event is the registry's node: a kernel by its name; a copy or a
    memset by its kind, which the driver runs either on a copy engine (``Memcpy DtoD
    (Device -> Device)``, ``Memset (Unknown)``) or as a kernel of its own
    (``memcpy32_post``)."""
    if kind == "kernel":
        return name is not None and name == event
    word = "memcpy" if kind == "memcpy" else "memset"
    return event[:6].lower() == word


def replays(trace: dict, graph: str):
    """``[[(stage, device µs), ...] per replay]`` of ``graph`` in the traced sub-window,
    or ``None`` where the registry has no such graph, a node has no stage, or the
    replays found are not the ``graph.<graph>`` spans' count."""
    reg = registry(graph)
    if trace is None or reg is None:
        return None
    seq = _labels(reg)
    if not seq or any(stage is None for _, _, stage in seq):
        return None
    calls = sum(1 for name, _, _ in trace["host_events"] if name == "graph." + graph)
    ev = trace["device_events"]
    out, i, n = [], 0, len(seq)
    while i + n <= len(ev):
        if all(_same(kind, name, ev[i + k][0]) for k, (kind, name, _) in enumerate(seq)):
            out.append([(seq[k][2], ev[i + k][2] - ev[i + k][1]) for k in range(n)])
            i += n
        else:
            i += 1
    return out if len(out) == calls else None


def totals(trace: dict, graph: str):
    """``(replays, {stage: device µs})`` of ``graph``'s replays in the traced
    sub-window, summed over the replays, or ``None`` as :func:`replays` reads."""
    reps = replays(trace, graph)
    if reps is None:
        return None
    by: dict = {}
    for rep in reps:
        for stage, us in rep:
            by[stage] = by.get(stage, 0.0) + us
    return len(reps), by


def window(n: int):
    """The live window before the profiler started, from the program's recorder:
    ``(steps, collections)``, the last ``n`` entries of kind ``step`` in runs after the
    host loop's first (its warm-up) that come before the first entry with the profiler
    running (the window's steps whose host times the harness kept), and the collections
    from the first of them to the profiler's start (the start of that entry, or the last
    step's end). ``None`` where the recorder is missing or holds fewer steps."""
    rec = getattr(program(), "recorded", None)
    if not callable(rec) or n <= 0:
        return None
    entries = rec()
    cut = next((i for i, e in enumerate(entries) if e.profiled), len(entries))
    steps = [e for e in entries[:cut] if e.kind == "step" and e.run >= 1][-n:]
    if len(steps) != n:
        return None
    t1 = entries[cut].start_ns if cut < len(entries) else steps[-1].end_ns
    gcs = [e for e in entries if e.kind == "gc" and steps[0].start_ns <= e.start_ns
           and e.end_ns <= t1]
    return steps, gcs

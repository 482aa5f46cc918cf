"""Spans and counters of the port, in one mechanism.

- :func:`span` — a named range of the host loop (``vo.*``), of a compiled step
  (``graph.*``) or of a stage of a step (``lcvo.*``). While a ``torch.profiler`` session
  runs it is a ``RecordFunction`` range, in the same trace as the card's kernels and on
  the same clock. The range has function scope (``torch._C._profiler._RecordFunctionFast``),
  not a user annotation's: the profiler echoes a user annotation on the device's timeline
  as one event over every kernel launched inside it, which a reader of the trace would
  count as device work. With no profiler running and no graph being captured, a span of
  one of :data:`PARTS` only logs its begin and end in the flight recorder, and any other
  span is one shared null context. :func:`within` runs a function inside a span, for the sites
  passed at every frame: where nothing is traced it costs a call, not a ``with`` block's
  two; :func:`lap` does it for a call's leading parts with one clock read; :func:`tracing`
  says whether spans are ranges, for a caller that passes several sites that only a trace
  needs.
- :data:`STAGES` — where each captured graph's nodes came from. While
  ``utils/graphs.py`` captures a graph, each ``lcvo.*`` boundary notes how many nodes the
  graph holds so far; after the capture ``STAGES[name]`` holds ``stages``, a list of
  ``(stage, first_node, last_node)`` (the innermost ``lcvo.*`` span open at the node's
  capture; ``graph.writeback`` after the last stage, the donated state written back;
  ``graph.other`` outside every stage before it, and in a graph with no stage) and
  ``nodes``, each node's ``(type, kernel name or None)`` in capture order, the order a
  replay runs them in on one stream. The newest capture of a name is kept; where the
  driver cannot give the node counts or the nodes, the name has no entry and the
  capture goes on.
- The flight recorder — always on: every host-loop call (``step``, ``chunk``,
  ``bootstrap``: :func:`call`), each of its :data:`PARTS` and every garbage collection
  logs its begin and end on ``time.perf_counter_ns`` into a ring of the last
  :data:`CAPACITY` events; :func:`recorded` folds them into :class:`Entry` rows, oldest
  first. A call's row holds its start and end, the self time of its parts (their length
  less the parts and collections inside them) and of the collections inside it, the
  graphs it captured, whether a profiler was running, and the host loop's run ordinal
  (0: the object's first ``run`` or ``run_chunked``). A collection's row holds its
  generation under ``ident`` and its pause under ``gc_ns``; with a profiler running it
  is the span ``host.gc``. Parts and collections outside any call count in no row.
- :func:`trace` — a ``torch.profiler`` trace of a region, written as ``trace.json``.

The recorder keeps the host loop's thread: a collection another thread makes is counted
against the call open in the host loop.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from collections import deque, namedtuple

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 18
PARTS = ("vo.keys", "vo.upload", "graph.launch", "vo.readback")
STAGES: dict = {}

Entry = namedtuple("Entry", "kind ident run start_ns end_ns keys_ns upload_ns launch_ns "
                            "readback_ns gc_ns captures profiled")

_ns = time.perf_counter_ns
_Range = torch._C._profiler._RecordFunctionFast
_INDEX = {name: i for i, name in enumerate(PARTS)}
# the events of the recorder: (kind, t, ident, run, profiled) a call begins, (part or _GC,
# t) a part or a collection begins, (_END, t[, ...]) the innermost one ends, (_LAP, part,
# t) a part ends that began at the innermost one's begin or last lap, (_CAPTURE,) a graph
# is captured
_GC, _CAPTURE, _END, _LAP = len(PARTS), len(PARTS) + 1, -1, -2
_events: deque = deque(maxlen=CAPACITY)
_log = _events.append


class _Null:
    """The span with no profiler running and no capture: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, t, v, tb):
        return None


_NULL = _Null()
_capture = None          # the _Capture of the graph being captured
_gc_range = None


def tracing() -> bool:
    """Whether a profiler runs or a graph is being captured: a span is then a range."""
    return _autograd_profiler._is_profiler_enabled or _capture is not None


class _Part:
    """One of :data:`PARTS` with no profiler running: its begin and end in the recorder."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __enter__(self):
        _log((self.i, _ns()))

    def __exit__(self, t, v, tb):
        _log((_END, _ns()))


class _Span:
    """A span while a profiler runs or a graph is captured."""

    __slots__ = ("name", "i", "range", "stage")

    def __init__(self, name: str):
        self.name, self.i = name, _INDEX.get(name)

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _Range(self.name)
            self.range.__enter__()
        self.stage = _capture is not None and self.name.startswith("lcvo.")
        if self.stage:
            _capture.open.append(self.name)
            _capture.mark(self.name)
        if self.i is not None:
            _log((self.i, _ns()))

    def __exit__(self, t, v, tb):
        if self.i is not None:
            _log((_END, _ns()))
        if self.stage:
            _capture.open.pop()
            _capture.mark(_capture.open[-1] if _capture.open else None)
        if self.range is not None:
            self.range.__exit__(None, None, None)


def span(name: str):
    """A named range: a profiler's range while one runs or a graph is captured, else
    the recorder's part for one of :data:`PARTS`, else nothing."""
    if _autograd_profiler._is_profiler_enabled or _capture is not None:
        return _Span(name)
    i = _INDEX.get(name)
    return _NULL if i is None else _Part(i)


def within(name: str, fn, *args):
    """``fn(*args)`` inside :func:`span` ``(name)``."""
    if _autograd_profiler._is_profiler_enabled or _capture is not None:
        with _Span(name):
            return fn(*args)
    i = _INDEX.get(name)
    if i is None:
        return fn(*args)
    _log((i, _ns()))
    try:
        return fn(*args)
    finally:
        _log((_END, _ns()))


def lap(name: str, fn, *args):
    """``fn(*args)`` as part ``name`` (one of :data:`PARTS`) of the open call, timed from
    the call's start or its last lap: one clock read where :func:`within` takes two, for
    the parts a call begins with. Under a profiler or a capture it is :func:`within`."""
    if _autograd_profiler._is_profiler_enabled or _capture is not None:
        with _Span(name):
            return fn(*args)
    out = fn(*args)
    _log((_LAP, _INDEX[name], _ns()))
    return out


def call(kind: str, ident: int, run: int, fn, *args):
    """``fn(*args)`` as a host-loop call: the span ``vo.<kind>`` and an entry in the
    recorder. ``ident`` is what the spans of one call share (a step's ``_frame_idx``, a
    chunk's or a bootstrap's first pose index), ``run`` the host loop's run ordinal. A
    call inside a call is counted in both."""
    profiled = _autograd_profiler._is_profiler_enabled
    outer = None
    if profiled or _capture is not None:
        outer = _Span("vo." + kind)
        outer.__enter__()
    _log((kind, _ns(), ident, run, profiled))
    try:
        return fn(*args)
    finally:
        _log((_END, _ns(), _autograd_profiler._is_profiler_enabled))
        if outer is not None:
            outer.__exit__(None, None, None)


def _on_gc(phase: str, info: dict) -> None:
    global _gc_range
    if phase == "start":
        if _autograd_profiler._is_profiler_enabled:
            _gc_range = _Range("host.gc")
            _gc_range.__enter__()
        _log((_GC, _ns()))
        return
    _log((_END, _ns(), info["generation"], _autograd_profiler._is_profiler_enabled))
    if _gc_range is not None:
        _gc_range.__exit__(None, None, None)
        _gc_range = None


def watch_gc() -> None:
    """Record every garbage collection from now on (once per process)."""
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def recorded() -> list:
    """The recorder's calls and collections, in the order they ended, folded from its
    events. A part's self time is its length less the parts and collections that began
    and ended inside it; it counts in every call open around it. What the ring has
    dropped the start of is left out."""
    out: list = []
    # [what, start, ns of the children, the call's parts or None, ev, last lap, children
    # then]
    stack: list = []
    for ev in _events.copy():
        what = ev[0]
        if what == _LAP:
            if stack:
                top = stack[-1]
                d = ev[2] - top[5] - (top[2] - top[6])
                for frame in stack:
                    if frame[3] is not None:
                        frame[3][ev[1]] += d
                top[2] += d
                top[5], top[6] = ev[2], top[2]
        elif what == _END:
            if not stack:
                continue
            top = stack.pop()
            d = ev[1] - top[1]
            if stack:
                stack[-1][2] += d
            if top[3] is not None:
                kind, _, ident, run, profiled = top[4]
                out.append(Entry(kind, ident, run, top[1], ev[1], *top[3],
                                 profiled or ev[2]))
                continue
            for frame in stack:
                if frame[3] is not None:
                    frame[3][top[0]] += d - top[2]
            if top[0] == _GC:
                out.append(Entry("gc", ev[2], -1, top[1], ev[1], 0, 0, 0, 0, d, 0, ev[3]))
        elif what == _CAPTURE:
            for frame in stack:
                if frame[3] is not None:
                    frame[3][_CAPTURE] += 1
        else:
            parts = [0] * (len(PARTS) + 2) if isinstance(what, str) else None
            stack.append([what, ev[1], 0, parts, ev, ev[1], 0])
    return out


class _Capture:
    """The ``lcvo.*`` boundaries of one capture: ``marks``, ``[(nodes so far, stage open
    after)]``, or None once ``count()`` has failed."""

    __slots__ = ("count", "marks", "open")

    def __init__(self, count):
        self.count, self.marks, self.open = count, [(0, None)], []

    def mark(self, stage) -> None:
        if self.marks is None:
            return
        try:
            self.marks.append((self.count(), stage))
        except Exception:  # a diagnostic: the capture goes on without a registry entry
            self.marks = None

    def record(self, name: str, nodes) -> bool:
        """``STAGES[name]`` from the marks and ``nodes()``, the graph's ``(type, kernel
        name)`` in capture order; where either is missing, no entry for ``name``."""
        if self.marks is not None:
            try:
                record_stages(name, self.marks, nodes())
                return True
            except Exception:  # a diagnostic: the graph replays without a registry entry
                pass
        STAGES.pop(name, None)
        return False


@contextlib.contextmanager
def capturing(name: str, count_nodes):
    """The capture of graph ``name``: the span ``graph.capture.<name>``, one more
    capture in the open call and, where ``count_nodes()`` gives the nodes captured so
    far, the ``lcvo.*`` boundaries; yields the :class:`_Capture` (None without
    ``count_nodes``), whose ``record`` fills ``STAGES[name]`` after the capture."""
    global _capture
    _log((_CAPTURE,))
    outer, cap = _capture, None
    with span("graph.capture." + name):
        if count_nodes is not None:
            cap = _capture = _Capture(count_nodes)
        try:
            yield cap
        finally:
            _capture = outer


def record_stages(name: str, marks: list, nodes: list) -> dict:
    """``STAGES[name]`` from a capture's marks and its graph's ``nodes``."""
    total = len(nodes)
    bounds = [(min(n, total), s) for n, s in marks] + [(total, None)]
    segs = [[s, a, b - 1] for (a, s), (b, _) in zip(bounds, bounds[1:]) if b > a]
    named = [i for i, seg in enumerate(segs) if seg[0] is not None]
    last = named[-1] if named else -1
    stages: list = []
    for i, (s, a, b) in enumerate(segs):
        s = s or ("graph.writeback" if named and i > last else "graph.other")
        if stages and stages[-1][0] == s:
            stages[-1][2] = b
        else:
            stages.append([s, a, b])
    STAGES[name] = {"stages": [tuple(s) for s in stages], "nodes": list(nodes)}
    return STAGES[name]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed region into ``log_dir/trace.json``
    (host activity always, device activity when CUDA is there): the program's spans
    beside the kernels. Yields the profiler, so the caller can read ``key_averages()``
    after the block."""
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

"""The port's spans, stage registry and flight recorder (``lcvo_tpu_torch/utils/profiling.py``)
on the CPU.

The host loop runs at the small size of ``tests/test_torch_graphs.py``, through its capture
stand-in where a test needs the compiled steps' replays (on the CPU they run eagerly). For
the stage registry the stand-in counts the operations a capture dispatches as the graph's
nodes, which is what the CUDA driver's node count is to a real capture.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import pytest
import torch
from test_torch_graphs import SMALL, BA, StandIn
from torch.utils._python_dispatch import TorchDispatchMode

from lcvo_tpu_torch.cli import run as cli
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.pipeline import VisualOdometry
from lcvo_tpu_torch.utils import graphs, profiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=40, width=320, height=128, speed=0.3)


@pytest.fixture(scope="module")
def frames(seq):
    return np.stack([seq.frame(i) for i in range(40)])


class _Ops(TorchDispatchMode):
    """Logs each operation dispatched: a captured graph's node, for the stand-in."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.log.append(("kernel", str(func)))
        return func(*args, **(kwargs or {}))


class NodeStandIn(StandIn):
    """The stand-in with graph nodes: each operation its capture runs."""

    def __init__(self):
        super().__init__()
        self.log: list = []
        self.logs: dict = {}

    def capture(self, body):
        self.log = []
        with _Ops(self.log):
            handle, info = super().capture(body)
        self.logs[id(body)] = self.log
        return handle, info

    def nodes(self) -> int:
        return len(self.log)

    def node_kinds(self, handle) -> list:
        return self.logs[id(handle[0])]


def _loop(seq, standin=None, ba=False):
    vo = VisualOdometry(load_config(overrides={**SMALL, **(BA if ba else {})}), seq.K,
                        device="cpu")
    if standin is not None:
        vo._compile_steps(capture=standin)
    return vo


def _events(prof) -> dict:
    """Each program span of the profile: name -> [names of its program-span ancestors]."""
    out: dict = {}
    for e in prof.events():
        if e.name.split(".")[0] not in ("vo", "graph", "lcvo", "host"):
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        out.setdefault(e.name, []).append(chain)
    return out


# -- spans -------------------------------------------------------------------------


def test_span_without_a_profiler_is_the_shared_null_context():
    before = profiling.recorded()
    a, b = profiling.span("vo.chunk"), profiling.span("lcvo.klt")
    assert a is b is profiling._NULL and not profiling.tracing()
    with a:
        with profiling.span("vo.keys"):           # a part, with no call open: in no row
            pass
        assert profiling.within("graph.launch", int, 3) == 3
    assert profiling.recorded() == before


@pytest.mark.parametrize("path", ["step", "chunk", "bootstrap"])
def test_spans_nest_under_the_profiler(seq, frames, path):
    """Each span's parent is the span open when it starts: the step's, the chunk's and
    the bootstrap's children, and the compiled steps' own."""
    vo = _loop(seq, StandIn())
    vo.bootstrap(list(frames[:5]))
    vo.step(frames[5])                            # the step's and the draws' captures
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if path == "step":
            vo.step(frames[6])
        elif path == "chunk":
            vo.run_chunked_continue(iter(frames[6:10]), produced=6, chunk=4)
        else:
            vo.bootstrap(list(frames[10:15]), R0=np.eye(3), t0=np.zeros(3), scale=1.0)
    ev = _events(prof)
    top = "vo." + path
    assert ev[top] == [[]]
    want = {"step": ["vo.keys", "vo.upload", "graph.process_frame"],
            "chunk": ["vo.keys", "vo.upload", "graph.pnp_uniforms", "graph.process_frame",
                      "vo.readback", "vo.emit"],
            "bootstrap": ["graph.build_pyramid", "graph.detect0", "graph.track_pair",
                          "graph.two_view_init", "vo.readback"]}[path]
    for name in want:
        assert all(chain[-1:] == [top] for chain in ev[name]), (name, ev[name])
    for name in ("graph.copy_in", "graph.launch", "graph.copy_out"):
        assert ev[name] and all(chain[0].startswith("graph.") and chain[-1] == top
                                for chain in ev[name]), (name, ev[name])
    if path == "step":
        assert len(ev["graph.launch"]) == 1       # the draws were made ahead


def test_live_loop_reads_health_in_its_own_span(seq, frames):
    vo = _loop(seq)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        vo.run(iter(frames[:9]), n_frames=9)
    ev = _events(prof)
    assert len(ev["vo.step"]) == 4 and len(ev["vo.health"]) == 4
    # the bootstrap's read-back; the live pose's read-back is no span
    assert ev["vo.health"] == [[]] * 4 and ev["vo.readback"] == [["vo.bootstrap"]]
    assert all(chain[-1] == "vo.step" for chain in ev["lcvo.klt"])


# -- the flight recorder --------------------------------------------------------------


def test_recorder_ring_wraps_at_capacity(monkeypatch):
    ring = deque(maxlen=33)           # 8 calls of 4 events, and the end of the one before
    monkeypatch.setattr(profiling, "_events", ring)
    monkeypatch.setattr(profiling, "_log", ring.append)
    for i in range(20):
        profiling.call("step", i, 1, profiling.within, "vo.keys", int, i)
    got = profiling.recorded()
    assert [e.ident for e in got] == list(range(12, 20))
    assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
    assert all(0 < e.keys_ns <= e.end_ns - e.start_ns for e in got)


def test_timed_self_time_leaves_out_nested_ranges_and_collections():
    profiling.watch_gc()

    def launch():
        time.sleep(0.03)
        gc.collect()

    def chunk():
        with profiling.span("vo.keys"):
            time.sleep(0.003)
            profiling.within("graph.launch", launch)
        with profiling.span("vo.readback"):
            time.sleep(0.002)

    profiling.call("chunk", 7, 2, chunk)
    e = profiling.recorded()[-1]
    assert (e.kind, e.ident, e.run, e.captures, e.profiled) == ("chunk", 7, 2, 0, False)
    assert 0.003e9 <= e.keys_ns < e.launch_ns and e.launch_ns >= 0.03e9
    assert e.readback_ns >= 0.002e9 and e.gc_ns > 0
    assert e.upload_ns == 0
    parts = e.keys_ns + e.upload_ns + e.launch_ns + e.readback_ns + e.gc_ns
    assert parts <= e.end_ns - e.start_ns


def test_lap_times_a_calls_leading_parts_from_its_start():
    """A lap runs from the call's start or its last lap; what ended inside it since
    (a part, a collection) is left out, and a part between laps counts as its own."""
    profiling.watch_gc()

    def keys():
        time.sleep(0.004)
        profiling.within("graph.launch", time.sleep, 0.02)
        gc.collect()

    def step():
        profiling.lap("vo.keys", keys)
        profiling.lap("vo.upload", time.sleep, 0.003)
        profiling.within("graph.launch", time.sleep, 0.01)

    profiling.call("step", 5, 1, step)
    e = profiling.recorded()[-1]
    assert 0.004e9 <= e.keys_ns < 0.02e9 and 0.003e9 <= e.upload_ns < 0.01e9
    assert e.launch_ns >= 0.03e9 and e.gc_ns > 0
    parts = e.keys_ns + e.upload_ns + e.launch_ns + e.readback_ns + e.gc_ns
    assert parts <= e.end_ns - e.start_ns


def test_gc_callback_records_a_forced_collection():
    profiling.watch_gc()
    profiling.watch_gc()
    assert gc.callbacks.count(profiling._on_gc) == 1
    profiling.call("step", 3, 1, gc.collect)
    *_, pause, step = profiling.recorded()
    assert (pause.kind, pause.ident) == ("gc", 2) and pause.gc_ns > 0
    assert step.start_ns <= pause.start_ns <= pause.end_ns <= step.end_ns
    assert step.gc_ns >= pause.gc_ns


def test_host_loop_entries_fit_in_their_calls(seq, frames):
    """Through the stand-in: one entry per bootstrap, chunk and step, the run ordinal of
    each run, the captures of the first, every entry's parts within its duration."""
    profiling.watch_gc()
    vo = _loop(seq, StandIn(), ba=True)
    profiling._events.clear()
    vo.run_chunked(frames[:18], chunk=4)          # bootstrap, 3 chunks, 1 tail step
    vo.run_chunked(frames[:14], chunk=4)          # bootstrap, 2 chunks, 1 tail step
    got = [e for e in profiling.recorded() if e.kind != "gc"]
    assert [(e.kind, e.run) for e in got] == (
        [("bootstrap", 0)] + [("chunk", 0)] * 3 + [("step", 0)]
        + [("bootstrap", 1)] + [("chunk", 1)] * 2 + [("step", 1)])
    assert [e.ident for e in got if e.kind == "chunk"] == [1, 5, 9, 15, 19]
    assert got[0].captures >= 4 and got[1].captures >= 2 and got[5].captures == 0
    for e in got:
        parts = (e.keys_ns, e.upload_ns, e.launch_ns, e.readback_ns, e.gc_ns)
        assert min(parts) >= 0 and sum(parts) <= e.end_ns - e.start_ns, e
    assert all(e.launch_ns > 0 and e.readback_ns > 0 and e.keys_ns > 0
               for e in got if e.kind == "chunk")
    assert all(e.launch_ns > 0 and e.upload_ns > 0 and e.keys_ns > 0
               for e in got if e.kind == "step")


def test_live_window_steps_follow_the_harness_count(seq, frames):
    """What the live readers align by: each ``run`` has its ordinal, and the steps a
    profiler saw are marked, so the window's steps before the profiler are the last n
    unmarked steps of runs after the first."""
    vo = _loop(seq)
    profiling._events.clear()
    vo.run(iter(frames[:8]), n_frames=8)          # the warm-up's run: 3 steps
    vo.run(iter(frames[8:16]), n_frames=8)        # bootstrap and 3 steps ...
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        vo.step(frames[16])                       # ... and one under a profiler
    got = [(e.kind, e.run, e.profiled) for e in profiling.recorded() if e.kind != "gc"]
    assert got == ([("bootstrap", 0, False)] + [("step", 0, False)] * 3
                   + [("bootstrap", 1, False)] + [("step", 1, False)] * 3
                   + [("step", 1, True)])
    steps = [e for e in profiling.recorded() if e.kind == "step"]
    assert [e.ident for e in steps] == [0, 1, 2, 0, 1, 2, 3]


# -- the stage registry ---------------------------------------------------------------


def test_record_stages_labels_nested_stages_and_the_write_back():
    marks = [(0, None), (2, "lcvo.a"), (5, None), (5, "lcvo.b"), (6, "lcvo.b.c"),
             (8, "lcvo.b"), (9, None)]
    nodes = [("kernel", f"k{i}") for i in range(12)]
    reg = profiling.record_stages("made_up", marks, nodes)
    assert reg["stages"] == [("graph.other", 0, 1), ("lcvo.a", 2, 4), ("lcvo.b", 5, 5),
                             ("lcvo.b.c", 6, 7), ("lcvo.b", 8, 8), ("graph.writeback", 9, 11)]
    assert profiling.STAGES["made_up"]["nodes"] == nodes


@pytest.mark.parametrize("ba", [False, True], ids=["no_ba", "ba"])
def test_stage_registry_through_the_capture_stand_in(seq, frames, ba):
    """A capture notes its ``lcvo.*`` boundaries in order, the stages cover every node
    once, and what follows the last stage (the donated state written back) is labelled
    ``graph.writeback``."""
    standin = NodeStandIn()
    vo = _loop(seq, standin, ba=ba)
    vo.bootstrap(list(frames[:5]))
    for f in frames[5:8]:
        vo.step(f)
    names = {"process_frame": ["lcvo.pyramid", "lcvo.klt", "lcvo.pnp", "lcvo.map",
                               "lcvo.detect", "graph.writeback"]}
    if ba:
        names["ba_step"] = ["lcvo.ba", "graph.writeback"]
    for graph, want in names.items():
        reg = profiling.STAGES[graph]
        assert [s for s, _, _ in reg["stages"]] == want
        assert reg["stages"][0][1] == 0 and reg["stages"][-1][2] == len(reg["nodes"]) - 1
        assert all(b[1] == a[2] + 1 for a, b in zip(reg["stages"], reg["stages"][1:]))
        wb = reg["stages"][-1]
        assert {n for _, n in reg["nodes"][wb[1]:wb[2] + 1]} >= {"aten.copy_.default"}
    assert profiling.STAGES["pnp_uniforms"]["stages"] == [
        ("graph.other", 0, len(profiling.STAGES["pnp_uniforms"]["nodes"]) - 1)]


def test_compiled_step_counts_copies_in_and_clones_out():
    def f(state, x, y):
        return (state[0] + x,), x * 2, y + 1

    step = graphs.compile_step(f, capture=StandIn())
    state, x, y = (torch.zeros(3),), torch.ones(3), torch.ones(2)
    for _ in range(4):
        state, *_ = step(state, x, y)
    (s,) = step.stats()
    assert s["replays"] == 4 and s["clones_per_replay"] == 2
    assert s["copies_in_per_replay"] == 6 / 4          # x and y, on the three replays after


# -- the CLI's profiled frames ----------------------------------------------------------


def test_profile_frames_traces_n_poses_after_the_warm_up(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "PROFILE_AFTER", 3)
    prof = cli.ProfiledFrames(str(tmp_path), 4)
    with prof:
        for i in range(10):
            with profiling.span("vo.step"):
                on = torch.autograd.profiler._is_profiler_enabled
                torch.ones(4).sum()
            prof.count(2 if i == 3 else 1)
            assert on == (3 <= i <= 5), i
    assert prof.summary() == {"trace": str(tmp_path / "trace.json"), "profiled_frames": 4}
    assert '"vo.step"' in (tmp_path / "trace.json").read_text()
    idle = cli.ProfiledFrames(str(tmp_path / "none"), 0)
    with idle:
        idle.count(100)
    assert idle.summary() == {} and not (tmp_path / "none").exists()


@pytest.mark.parametrize("fault", ["nodes", "node_kinds"])
def test_registry_failure_leaves_the_capture_and_replays(seq, frames, fault):
    """Where the driver cannot give the node count during a capture or the nodes after
    it, the graph has no registry entry, and the step captures and replays as it does
    without the registry."""

    class Failing(NodeStandIn):
        def nodes(self):
            if fault == "nodes":
                raise AttributeError("cuStreamGetCaptureInfo")
            return super().nodes()

        def node_kinds(self, handle):
            if fault == "node_kinds":
                raise RuntimeError("cuGraphNodeGetType failed (1)")
            return super().node_kinds(handle)

    profiling.STAGES.clear()
    vo, plain = _loop(seq, Failing()), _loop(seq, StandIn())
    poses = []
    for v in (vo, plain):
        v.bootstrap(list(frames[:5]))
        poses.append(torch.stack([v.step(f).t for f in frames[5:9]]))
    # a graph with no stage asks no node count during its capture
    assert all(profiling.STAGES[g]["stages"] == [("graph.other", 0, len(
        profiling.STAGES[g]["nodes"]) - 1)] for g in profiling.STAGES)
    assert "process_frame" not in profiling.STAGES
    if fault == "node_kinds":
        assert profiling.STAGES == {}
    (s,) = vo._process.stats()
    assert s["replays"] == 4 and "stages_s" not in s
    torch.testing.assert_close(poses[0], poses[1], rtol=0, atol=0)

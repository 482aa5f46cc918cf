"""The readers of the program's own spans and counters on made-up traces, registries and
recorders: the stage labelling of graph replays and the live window's collections."""

import sys
from collections import namedtuple
from types import SimpleNamespace

import pytest

from vo_bench import run, stages

Entry = namedtuple("Entry", "kind ident run start_ns end_ns keys_ns upload_ns launch_ns "
                            "readback_ns gc_ns captures profiled")
PROCESS = {"stages": [("lcvo.klt", 0, 1), ("lcvo.pnp", 2, 4), ("graph.writeback", 5, 5)],
           "nodes": [("kernel", "void klt<1>(float*)"), ("memcpy", None),
                     ("empty", None), ("kernel", "dk"), ("memset", None),
                     ("kernel", "copy")]}
BA = {"stages": [("lcvo.ba", 0, 1), ("graph.writeback", 2, 2)],
      "nodes": [("kernel", "schur"), ("kernel", "solve"), ("memcpy", None)]}


def _replay(t, klt=(3.0, 1.0), pnp=(5.0, 0.5), wb=2.0, name="void klt<1>(float*)",
            copy="Memcpy DtoD (Device -> Device)"):
    """Device events of one ``process_frame`` replay from ``t`` on, back to back."""
    names = [name, copy, "dk", "Memset (Unknown)", "copy"]
    out = []
    for n, d in zip(names, (*klt, *pnp, wb)):
        out.append((n, t, t + d))
        t += d
    return out, t


def _trace(n_replays=2, frames=2, calls=None, bad=None, ba=0):
    dev, host, t = [], [], 0.0
    for r in range(n_replays):
        dev.append(("Memcpy DtoD (Device -> Device)", t, t + 0.4))       # the copy-in
        # the driver runs a graph's copy on a copy engine or as a kernel of its own
        ev, t = _replay(t + 1.0, name="other" if r == bad else "void klt<1>(float*)",
                        copy="memcpy32_post" if r % 2 else "Memcpy DtoD (Device -> Device)")
        dev += ev
        host.append(("graph.process_frame", t - 20, t - 15))
        host.append(("graph.launch", t - 19, t - 16))
    for _ in range(ba):
        dev += [("schur", t + 1, t + 5), ("solve", t + 5, t + 6),
                ("Memcpy DtoD (Device -> Device)", t + 6, t + 7)]
        host.append(("graph.ba_step", t, t + 1))
        t += 7
    for _ in range((calls or n_replays) - n_replays):
        host.append(("graph.process_frame", t, t + 1))
    busy = sum(e - s for _, s, e in dev)
    return {"frames": frames, "window_us": t, "busy_us": busy, "device_ops": len(dev),
            "device_events": dev, "host_events": sorted(host, key=lambda h: h[1])}


def _ctx(mode, trace, host_step_ms=()):
    return SimpleNamespace(mode=mode, cfg=None, trace=trace, calls={}, profiled=None,
                           host_step_ms=list(host_step_ms), latencies=[])


@pytest.fixture
def program(monkeypatch):
    """A made-up program module in the process: its registry and recorder."""
    mod = SimpleNamespace(STAGES={"process_frame": PROCESS, "ba_step": BA}, entries=[])
    mod.recorded = lambda: list(mod.entries)
    monkeypatch.setitem(sys.modules, stages.PROGRAM, mod)
    return mod


def test_stage_readers_label_each_replay(program):
    ctx = _ctx("replay", _trace())
    assert run.reader("klt_device_ms_per_frame.replay")(ctx) == pytest.approx(4.0 / 1e3)
    assert run.reader("pnp_device_ms_per_frame.replay")(ctx) == pytest.approx(5.5 / 1e3)
    reps = stages.replays(ctx.trace, "process_frame")
    # every event of a replay labelled: the stages and the write-back sum to its time
    assert [sum(us for _, us in rep) for rep in reps] == [11.5, 11.5]
    assert [s for s, _ in reps[0]] == ["lcvo.klt"] * 2 + ["lcvo.pnp"] * 2 + ["graph.writeback"]


@pytest.mark.parametrize("fault", ["kernel_name", "replay_count", "no_registry"])
def test_stage_readers_are_silent_on_a_mismatch(program, fault):
    if fault == "kernel_name":
        trace = _trace(bad=1)
    elif fault == "replay_count":
        trace = _trace(calls=3)
    else:
        trace = _trace()
        del program.STAGES["process_frame"]
    ctx = _ctx("replay", trace)
    assert run.reader("klt_device_ms_per_frame.replay")(ctx) is None
    assert run.reader("pnp_device_ms_per_frame.replay")(ctx) is None


def test_ba_reader_averages_the_keyframe_replays(program):
    read = run.reader("ba_device_ms_per_keyframe.replay")
    assert read(_ctx("replay", _trace(ba=3))) == pytest.approx(6.0 / 1e3)
    assert read(_ctx("replay", _trace(ba=0))) == 0.0          # no keyframe in the window
    del program.STAGES["ba_step"]
    assert read(_ctx("replay", _trace(ba=3))) is None


def _live(program, pauses=((105, 7), (142, 3), (151, 2))):
    e = [Entry("step", i, 0, 10 * i, 10 * i + 5, 0, 0, 1000, 0, 0, 0, False) for i in range(3)]
    e += [Entry("step", i, 1, 110 + 10 * i, 115 + 10 * i, 0, 0, 2_000_000 + 100_000 * i, 0, 0,
                0, False) for i in range(6)]
    e += [Entry("gc", 2, -1, t, t + d, 0, 0, 0, 0, d * 1_000_000, 0, False) for t, d in pauses]
    e.append(Entry("step", 6, 1, 200, 205, 0, 0, 9_000_000, 0, 0, 0, True))
    e.append(Entry("gc", 2, -1, 210, 260, 0, 0, 0, 0, 50_000_000, 0, True))
    program.entries = sorted(e, key=lambda x: x.end_ns)


def test_live_readers_align_with_the_harness_steps(program):
    """The window is the last n steps of runs after the warm-up before the first
    profiled entry; its collections run from the first of them to the profiler's
    start."""
    _live(program)
    steps, gcs = stages.window(4)
    assert [e.ident for e in steps] == [2, 3, 4, 5]
    assert [e.start_ns for e in gcs] == [142, 151]               # not 105, not 210
    ctx = _ctx("live", _trace(), host_step_ms=[1.0] * 4)
    assert run.reader("gc_pause_ms_max.live")(ctx) == pytest.approx(3.0)
    _live(program, pauses=())
    assert run.reader("gc_pause_ms_max.live")(ctx) == 0.0
    ctx = _ctx("live", _trace(), host_step_ms=[1.0] * 7)        # more than the recorder holds
    assert run.reader("gc_pause_ms_max.live")(ctx) is None
    assert stages.window(7) is None


NEW = ["klt_device_ms_per_frame.replay", "pnp_device_ms_per_frame.replay",
       "ba_device_ms_per_keyframe.replay", "gc_pause_ms_max.live"]


@pytest.mark.parametrize("name", NEW)
def test_readers_are_silent_without_device_time_or_program(name, program, monkeypatch):
    mode = name.rsplit(".", 1)[1]
    _live(program)
    steps = [1.0] * 4
    assert run.reader(name)(_ctx(mode, _trace(ba=1), steps)) is not None
    assert run.reader(name)(_ctx(mode, None, steps)) is None
    idle = dict(_trace(ba=1), busy_us=0)
    assert run.reader(name)(_ctx(mode, idle, steps)) is None
    # a control run: no program in the process, none of its spans in the trace
    monkeypatch.delitem(sys.modules, stages.PROGRAM)
    control = _trace(ba=1)
    control["host_events"] = [h for h in control["host_events"] if not h[0].startswith("graph.")]
    assert run.reader(name)(_ctx(mode, control, steps)) is None

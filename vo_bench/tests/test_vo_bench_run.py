"""Whole runs on the CPU at a tiny size: the contract's last line, no JAX in the process,
``correct`` true for the program and false with the timed path broken underneath, and the
control (the reference in TF32 in the program's place) read above the limit."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vo_bench import run
from vo_bench.tests.tiny import tiny_run

ROOT = run.ROOT


def test_tiny_run_prints_the_last_line_and_loads_no_jax():
    code = ("import sys; from vo_bench import run; from vo_bench.tests.tiny import tiny_run; "
            "rc = run.emit(tiny_run('default.replay', 4.0)); "
            "print(sorted(m.split('.')[0] for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'lcvo_tpu')), file=sys.stderr); "
            "sys.exit(rc)")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert p.stderr.strip().splitlines()[-1] == "[]"            # no jax, no lcvo_tpu
    assert p.stderr.strip().splitlines()[-4].startswith("check pose_gap:")
    assert p.stderr.strip().splitlines()[-3].startswith("check map_gap:")


def test_cli_refuses_without_a_card(card_absent):
    p = subprocess.run([sys.executable, "-m", "vo_bench.run", "--workload", "default.replay",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card_absent():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


@pytest.mark.parametrize("cell", ["default.replay", "turn_robust.live"])
def test_program_is_correct(cell):
    res = tiny_run(cell, 4.0)
    assert res["correct"], res["_notes"]
    assert res["checks"]["pose_gap"]["value"] == 0.0        # the eager port = its copy
    assert res["checks"]["map_gap"]["value"] == 0.0


def test_traced_run_reads_its_metrics():
    res = tiny_run("turn_robust.live", 4.0, trace=True)
    # on the CPU the trace holds no device time: the device metrics stay silent
    assert set(res["metrics"]) == {"host_ms_per_step.live", "keyframe_extra_ms.live",
                                   "latency_p95_ms.live"}


# -- the timed path broken underneath ---------------------------------------------------

def _freeze(step, state, image, draw):
    _, res = step(state, image, draw)
    return state, res._replace(R=state.R.clone(), t=state.t.clone())


def _alter(step, state, image, draw):
    """The pose moved by 0.02 along world x where the step produces it (about 6% of a
    frame's 0.35 of motion)."""
    new, res = step(state, image, draw)
    t = res.t - res.R @ torch.tensor([0.02, 0.0, 0.0], dtype=res.t.dtype)
    return new._replace(t=t), res._replace(t=t)


FAULTS = {
    "state_unchanged": lambda n: _freeze,
    "half_the_frames_left_out": lambda n: (lambda step, *a: _freeze(step, *a) if n[0] % 2
                                           else step(*a)),
    "pose_altered": lambda n: _alter,
}


@pytest.mark.parametrize("cell", ["default.replay", "turn_robust.live"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    import lcvo_tpu_torch.pipeline as pl

    orig = pl.frame_step
    count = [0]
    broken = FAULTS[fault](count)

    def frame_step(process):
        step = orig(process)

        def wrapped(state, image, draw):
            count[0] += 1
            return broken(step, state, image, draw)

        return wrapped

    monkeypatch.setattr(pl, "frame_step", frame_step)
    res = tiny_run(cell, 4.0)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell, frames, seconds",
                         [("turn_robust.replay", 16, 4.0), ("turn_robust.live", 8, 6.0)])
def test_keyframe_step_that_leaves_its_window_unchanged_is_not_correct(cell, frames, seconds,
                                                                      monkeypatch):
    """The keyframe step (window BA) returns the state and the window it was given, where
    the program builds it: samples long enough to hold a keyframe see the window."""
    import lcvo_tpu_torch.pipeline as pl

    orig = pl.carry_step

    def carry_step(ba_step):
        step = orig(ba_step)

        def unchanged(carry):
            _, res = step(carry)
            return carry, res

        return unchanged

    monkeypatch.setattr(pl, "carry_step", carry_step)
    res = tiny_run(cell, seconds, check_frames=frames)
    assert not res["correct"], res["checks"]
    assert res["checks"]["map_gap"]["value"] > res["checks"]["map_gap"]["limit"]


@pytest.mark.parametrize("cell", ["default.replay", "turn_robust.live"])
def test_control_reads_above_the_limit(cell):
    """The control: the reference computed with TF32 products (rounded operands on the
    CPU) in the program's place fails the cell's own limit."""
    res = tiny_run(cell, 4.0, system="control")
    assert not res["correct"]
    assert res["checks"]["pose_gap"]["value"] > res["checks"]["pose_gap"]["limit"]
    assert np.isfinite(res["checks"]["pose_gap"]["value"])

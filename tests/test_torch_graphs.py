"""The compiled step (``lcvo_tpu_torch/utils/graphs.py``), the port's ``jax.jit`` with
``donate_argnums``, on the CPU.

There is no card here, so the CUDA capture is replaced by an explicit stand-in that only
these tests pass (``capture=``): it records the step at the capture and replays it by
running the step on the graph's buffers, copying what it gives into the outputs it gave
at the capture, as a replay refreshes a graph's static outputs. A capture executes
nothing on the card, so the stand-in's capture runs the step once and its first replay
hands that result back. A replay passes no Python, so the stand-in takes back what the
launch counters moved inside it. Everything else (keys, buffers, donation, warm-up,
the draws as input buffers, launch accounting, the host loop's writes into the buffers)
is the package's own code, as it runs on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.parallel import streams as ps
from lcvo_tpu_torch.pipeline import (VisualOdometry, frame_step, make_process_frame,
                                     uniforms_fn)
from lcvo_tpu_torch.utils import graphs, jax_random

SMALL = {
    "image_width": 320, "image_height": 128,
    "state": {"max_tracks": 256, "max_candidates": 256, "max_new_per_frame": 96},
    "klt": {"window": 15, "iters": 8, "levels": 3},
    "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
    "bootstrap": {"frame_gap": 4},
}
BA = {"ba": {"enabled": True, "window": 4, "keyframe_every": 3, "gn_iters": 3}}


class StandIn:
    """The CPU tests' stand-in for the CUDA capture (see the module docstring)."""

    def __init__(self):
        self.captured = []          # the captured bodies
        self.replays = 0

    def warmup(self, run):
        run()

    def capture(self, body):
        self.captured.append(body)
        return [body, body(), True], {}

    def replay(self, handle):
        self.replays += 1
        body, outs, first = handle
        if first:
            handle[2] = False
            return outs
        counts = dict(kernels.LAUNCHES)
        new = body()
        kernels.LAUNCHES.update(counts)
        for o, n in zip(tree_flatten(outs)[0], tree_flatten(new)[0]):
            if torch.is_tensor(o) and o is not n:
                o.copy_(n)
        return outs


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


@pytest.fixture(scope="module")
def booted(seq, frames):
    """A bootstrapped state at the small size (the buffers of a host loop)."""
    cfg = load_config(overrides=SMALL)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.bootstrap(list(frames[:5]))
    return cfg, vo.state


def _leaves(tree):
    return [x for x in tree_flatten(tree)[0] if x is not None]


def _clone(tree):
    return graphs.place(None, tree)


def _equal(a, b) -> bool:
    """Bit for bit (NaN equal to NaN where both hold it)."""
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        (x is None and y is None) or (x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x,
            y.reshape(-1).view(torch.uint8) if y.dtype != torch.bool else y))
        for x, y in zip(la, lb))


def _draws(cfg, n):
    """The uniforms of ``n`` step keys from ``cfg.seed``'s chain: (n, n_hyp, 3)."""
    keys = jax_random.split(jax_random.PRNGKey(cfg.seed), n)
    return uniforms_fn(cfg.ransac.pnp_hypotheses, "cpu")(keys)


def _eager_steps(cfg, K, state, frames, n):
    process = frame_step(make_process_frame(cfg, K, "cpu"))
    out = []
    for f, u in zip(frames[5:5 + n], _draws(cfg, n)):
        state, res = process(state, torch.from_numpy(f), u)
        out.append((_clone(state), res))
    return out


def test_donated_state_is_the_buffers_and_equals_eager(seq, frames, booted):
    """``donate=True``: the first call adopts the state's tensors as the graph's
    buffers, every call returns those buffers, ``prev_R``/``prev_t`` hold the R, t of
    the call before after the write-back (R is written in the same graph), and 8 steps
    equal the eager step bit for bit."""
    cfg, boot = booted
    want = _eager_steps(cfg, seq.K, _clone(boot), frames, 8)
    draws = _draws(cfg, 8)
    standin = StandIn()
    step = graphs.compile_step(frame_step(make_process_frame(cfg, seq.K, "cpu")),
                               donate=True, capture=standin)
    state = _clone(boot)
    buffers = _leaves(state)
    for i, (want_state, want_res) in enumerate(want):
        R_before, t_before = state.R.clone(), state.t.clone()
        state, res = step(state, torch.from_numpy(frames[5 + i]), draws[i])
        assert all(a is b for a, b in zip(_leaves(state), buffers))
        assert torch.equal(state.prev_R, R_before) and torch.equal(state.prev_t, t_before)
        assert _equal(state, want_state) and _equal(res, want_res)
    assert len(standin.captured) == 1 and standin.replays == 8


def test_undonated_state_stays_valid_and_equals_eager(seq, frames, booted):
    """``donate=False``: the caller's state is unchanged by the call, the state that
    comes back shares no memory with it, and 8 steps equal the eager step bit for bit."""
    cfg, boot = booted
    want = _eager_steps(cfg, seq.K, _clone(boot), frames, 8)
    draws = _draws(cfg, 8)
    step = graphs.compile_step(frame_step(make_process_frame(cfg, seq.K, "cpu")),
                               donate=False, capture=StandIn())
    state = _clone(boot)
    for i, (want_state, want_res) in enumerate(want):
        before = _clone(state)
        new, res = step(state, torch.from_numpy(frames[5 + i]), draws[i])
        assert _equal(state, before)
        ptrs = {x.untyped_storage().data_ptr() for x in _leaves(state)}
        assert not ptrs & {x.untyped_storage().data_ptr() for x in _leaves(new)}
        assert _equal(new, want_state) and _equal(res, want_res)
        state = new


def test_write_back_reads_every_buffer_before_it_writes_one():
    """Outputs that alias inputs: a step that swaps two fields, keeps one and returns
    an input as a second output gives what the eager call gives, call after call."""
    def swap(state, x):
        a, b, c = state
        return (b, a + x, c), a

    step = graphs.compile_step(swap, capture=StandIn())
    state = (torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]), torch.tensor([5.0]))
    eager = _clone(state)
    for k in range(4):
        x = torch.full((2,), float(k))
        eager, want_a = swap(eager, x)
        state, a = step(state, x)
        assert _equal(state, eager) and torch.equal(a, want_a)


def test_warmup_leaves_the_draws_as_it_found_them(seq, frames, booted):
    """The randomness is an input buffer: the warm-up runs the step on copies, so the
    caller's draws (and state) are as it left them, and every replay reads the draws of
    its own call: a replay with the first call's draws gives the first call's result."""
    cfg, boot = booted
    draws = _draws(cfg, 2)
    kept = draws.clone()
    standin = StandIn()
    step = graphs.compile_step(frame_step(make_process_frame(cfg, seq.K, "cpu")),
                               donate=False, capture=standin)
    first = step(_clone(boot), torch.from_numpy(frames[5]), draws[0])
    assert torch.equal(draws, kept) and len(standin.captured) == 1
    other = step(_clone(boot), torch.from_numpy(frames[5]), draws[1])
    again = step(_clone(boot), torch.from_numpy(frames[5]), draws[0])
    eager = frame_step(make_process_frame(cfg, seq.K, "cpu"))(
        _clone(boot), torch.from_numpy(frames[5]), draws[0])
    assert _equal(first, eager) and _equal(again, eager) and not _equal(other, eager)


def test_one_capture_per_key():
    """The key is the tree, each tensor's shape and dtype, and the Python scalars: the
    same key replays, a new shape, dtype or scalar captures anew."""
    def f(state, x, k):
        return (state[0] + (x.sum() * k).float(),), x * k

    standin = StandIn()
    step = graphs.compile_step(f, capture=standin)
    state = (torch.zeros(()),)
    for x, k, n in ((torch.ones(3), 2, 1), (torch.ones(3) * 2, 2, 1), (torch.ones(4), 2, 2),
                    (torch.ones(4), 3, 3), (torch.ones(4, dtype=torch.float64), 3, 4),
                    (torch.ones(3), 2, 4), (torch.ones(4), 3, 4)):
        state, y = step(state, x, k)
        assert step.captures() == len(standin.captured) == n
        assert torch.equal(y, x * k)
    assert float(state[0]) == 6 + 12 + 8 + 12 + 12 + 6 + 12
    with pytest.raises(TypeError, match="callable|function"):
        step(state, torch.ones(3), lambda: 1)


def test_launches_count_the_capture_times_the_replays():
    """The counters move by what the capture moved them, once per replay; the warm-up
    and the capture themselves count nothing."""
    def f(state, x):
        kernels.LAUNCHES["extract_blocks"] += 3
        kernels.LAUNCHES["extract_blocks_layered"] += 1
        return (state[0] + x,), x

    saved = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    try:
        step = graphs.compile_step(f, capture=StandIn())
        state = (torch.zeros(2),)
        for n in range(1, 6):
            state, _ = step(state, torch.ones(2))
            assert kernels.LAUNCHES == {"extract_blocks": 3 * n, "extract_blocks_layered": n, "svd": 0,
                                        "p3p": 0, "klt_iterate": 0}
        stats = step.stats()
        assert len(stats) == 1 and stats[0]["replays"] == 5
        assert stats[0]["launches_per_replay"] == {"extract_blocks": 3, "extract_blocks_layered": 1}
    finally:
        kernels.LAUNCHES.update(saved)


def test_outputs_come_back_as_copies():
    """Outputs other than the donated state are copies: the next replay, which rewrites
    the graph's own outputs, leaves the ones handed out before as they were."""
    step = graphs.compile_step(lambda s, x: ((s[0] + 1,), s[0] * x), capture=StandIn())
    state = (torch.zeros(3),)
    outs = []
    for _ in range(4):
        state, y = step(state, torch.ones(3))
        outs.append(y)
    assert [float(y[0]) for y in outs] == [0.0, 1.0, 2.0, 3.0]


def test_capture_failure_names_the_operation():
    """A step that cannot be captured raises ``GraphCaptureError`` naming the file and
    line of the operation; nothing falls back to eager."""
    class Capturing(StandIn):
        on = False

        def capture(self, body):
            self.on = True
            return body(), {}

    standin = Capturing()

    def bad(state, x):
        y = x + 1
        if standin.on:
            raise RuntimeError("operation not permitted when stream is capturing")
        return (state[0] + y,), y

    step = graphs.compile_step(bad, capture=standin)
    with pytest.raises(graphs.GraphCaptureError, match=r"test_torch_graphs\.py:\d+ \(raise") as e:
        step((torch.zeros(3),), torch.zeros(3))
    assert "not permitted" in str(e.value) and "bad" in str(e.value)


def test_cpu_tensors_and_disable_graphs_run_eagerly():
    """CPU tensors run the step eagerly when no capture is given, and so does any
    call inside ``disable_graphs()``: nothing is captured, nothing donated."""
    calls = []

    def f(state, x):
        calls.append(1)
        return (state[0] + x,), x

    plain = graphs.compile_step(f)
    state = (torch.zeros(2),)
    new, _ = plain(state, torch.ones(2))
    assert plain.captures() == 0 and new[0] is not state[0] and float(state[0][0]) == 0.0
    standin = StandIn()
    step = graphs.compile_step(f, capture=standin)
    with graphs.disable_graphs():
        new, _ = step(state, torch.ones(2))
    assert step.captures() == 0 and not standin.captured and new[0] is not state[0]
    assert len(calls) == 2


def test_visual_odometry_without_a_card_raises(seq):
    """The device rule is unchanged: with no ``device=`` the host loop wants CUDA."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        VisualOdometry(load_config(overrides=SMALL), seq.K)


def test_place_writes_into_owned_buffers():
    """``place``: into ``dst``'s tensors where the trees fit; a copy sharing memory with
    nothing where ``dst`` is None, does not fit, or aliases itself."""
    src = (torch.arange(3.0), torch.ones(2, dtype=torch.int32), None)
    fresh = graphs.place(None, src)
    assert _equal(fresh, src) and all(a.data_ptr() != b.data_ptr()
                                      for a, b in zip(_leaves(fresh), _leaves(src)))
    new = (torch.arange(3.0) * 2, torch.zeros(2, dtype=torch.int32), None)
    assert graphs.place(fresh, new) is fresh and _equal(fresh, new)
    shared = torch.zeros(3)
    got = graphs.place((shared, shared, None), (torch.ones(3), torch.ones(3) * 2, None))
    assert got[0] is not shared and float(shared.sum()) == 0.0 and float(got[1][0]) == 2.0
    wider = (torch.ones(4), torch.zeros(2, dtype=torch.int32), None)
    assert graphs.place(fresh, wider)[0].shape == (4,) and fresh[0].shape == (3,)


def _host_loop_run(cfg, seq, frames, standin):
    """Bootstrap, two chunks through ``make_chunk_step`` and ``set_chunk_carry``, one
    chunk with a copied carry handed back, a save and a resume, a re-bootstrap, a chunk
    after it; returns the loop, its poses and the data pointers seen at each stage."""
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    if standin is not None:
        vo._compile_steps(capture=standin)
    ptrs = []

    def note():
        ptrs.append([x.data_ptr() for x in _leaves(vo.chunk_carry())])

    vo.bootstrap(list(frames[:5]))
    note()
    step = vo.make_chunk_step(4)
    poses = []
    for c in range(4):
        batch = torch.from_numpy(frames[5 + 4 * c: 9 + 4 * c])
        carry, (Rs, ts, ok, _) = step(vo.chunk_carry(), batch,
                                      jax_random.split(vo._next_key(), 4),
                                      frame_idx=vo._frame_idx)
        if c == 2:
            carry = _clone(carry)
        vo.set_chunk_carry(carry, 4)
        poses.append((Rs, ts, ok))
        note()
    return vo, poses, ptrs


@pytest.mark.parametrize("ba", [False, True], ids=["no_ba", "ba"])
def test_host_loop_writes_into_the_buffers(seq, frames, tmp_path, ba):
    """Through the stand-in the host loop's state (and window) keep their buffers across
    ``set_chunk_carry`` (also of a copied carry), a re-bootstrap, a resume and the
    per-frame step, and every pose equals the eager loop's."""
    cfg = load_config(overrides={**SMALL, **(BA if ba else {})})
    runs = {}
    for name, standin in (("eager", None), ("graphed", StandIn())):
        vo, poses, ptrs = _host_loop_run(cfg, seq, frames, standin)
        path = str(tmp_path / f"{name}.npz")
        vo.save(path, 21)
        vo.bootstrap(list(frames[21:26]), R0=np.eye(3), t0=np.zeros(3), scale=1.0)
        ptrs.append([x.data_ptr() for x in _leaves(vo.chunk_carry())])
        res = [vo.step(f) for f in frames[26:30]]
        ptrs.append([x.data_ptr() for x in _leaves(vo.chunk_carry())])
        assert vo.resume(path) == 21
        ptrs.append([x.data_ptr() for x in _leaves(vo.chunk_carry())])
        res += [vo.step(f) for f in frames[21:24]]
        runs[name] = (poses, res, vo, ptrs)
    poses, res, vo, ptrs = runs["graphed"]
    assert all(p == ptrs[0] for p in ptrs), "the graphed loop rebound its buffers"
    e_poses, e_res, e_vo, _ = runs["eager"]
    for a, b in zip(poses, e_poses):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(res, e_res):
        assert _equal(a, b)
    assert _equal(vo.chunk_carry(), e_vo.chunk_carry())
    assert (vo._frame_idx, vo.n_keyframes) == (e_vo._frame_idx, e_vo.n_keyframes)
    if ba:
        assert vo.ba_refine_stats() == e_vo.ba_refine_stats() and vo.ba_refine_stats()[0] > 0
        assert vo._ba.stats()[0]["replays"] > 0


def test_forced_rebootstrap_replays_the_same_graphs(seq, frames):
    """A run whose every step fails (``min_pnp_inliers`` out of reach) re-bootstraps
    inside ``run_chunked``: through the stand-in it replays the graphs it captured first,
    its buffers stay, and it gives the eager run's poses and re-bootstraps."""
    cfg = load_config(overrides={**SMALL, "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256,
                                                      "min_pnp_inliers": 10 ** 6},
                                 "bootstrap": {"frame_gap": 4, "rebootstrap_skip": 2}})
    eager = VisualOdometry(cfg, seq.K, device="cpu")
    eager.run_chunked(frames[:18], chunk=4)
    standin = StandIn()
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo._compile_steps(capture=standin)
    boot = vo.bootstrap
    seen = []

    def watched(*a, **k):
        n = boot(*a, **k)
        seen.append([x.data_ptr() for x in _leaves(vo.state)])
        return n

    vo.bootstrap = watched
    vo.run_chunked(frames[:18], chunk=4)
    assert vo.n_rebootstraps == eager.n_rebootstraps >= 2 and len(seen) >= 2
    assert all(p == seen[0] for p in seen)
    # one graph per compiled step: the per-frame step and the bootstrap's pieces
    assert all(c.captures() == 1 for c in vo._compiled())
    assert len(standin.captured) == len(vo._compiled())
    assert standin.replays == sum(g["replays"] for g in vo.graph_stats()["graphs"])
    assert vo._process.stats()[0]["replays"] >= 8
    np.testing.assert_array_equal(np.asarray(vo.poses), np.asarray(eager.poses))
    assert vo.pose_ok_flags == eager.pose_ok_flags


def test_streams_chunk_step_graphed_equals_eager(seq, frames, monkeypatch):
    """The compiled steps of ``make_multistream_chunk_step`` through the stand-in (the vmapped step and
    the vmapped keyframe step, with the per-stream select where the cadences differ)
    give the eager chunk step's poses and carry bit for bit."""
    cfg = load_config(overrides={**SMALL, **BA})
    vos = []
    for _ in range(2):
        vo = VisualOdometry(cfg, seq.K, device="cpu")
        vo.bootstrap(list(frames[:5]))
        vos.append(vo)
    vos[1].step(frames[5])          # stream 1 one frame ahead: the cadences differ
    fr = torch.from_numpy(np.stack([frames[5:11], frames[6:12]]))
    out = {}
    for name in ("eager", "graphed"):
        if name == "graphed":
            standin = StandIn()
            monkeypatch.setattr(ps, "compile_step",
                                lambda fn, **kw: graphs.compile_step(fn, capture=standin, **kw))
        step = ps.make_multistream_chunk_step(cfg, seq.K, device="cpu")
        carry = ps.stack_streams([vo.chunk_carry() for vo in vos])
        keys = ps.chunk_keys(ps.stream_keys(3, 2), 6)[1]
        carry, res = step(carry, fr, keys, frame_idx=[0, 1])
        out[name] = (carry, res)
    assert _equal(out["graphed"], out["eager"])
    assert len(standin.captured) == 2      # the frame step, the keyframe step with a select

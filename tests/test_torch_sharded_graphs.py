"""The sharded calls as compiled steps: the port's counterpart of the JAX package's last
``jax.jit`` (``lcvo_tpu/solve/ba/sharded.py:121``, the ``shard_map`` of
``frontend/match.py:69-99`` and the mesh step of ``parallel/streams.py:104-114``).

``ba_solve_sharded``, ``knn_match_ratio_sharded`` and the mesh ``make_multistream_step``
run as compiled steps (``utils/graphs.py``) whose collectives are captured with them
where the group is NCCL's, and run eagerly on gloo (``parallel/mesh.py::capturable``).
There is no card here: at 1 and 2 gloo ranks (``tests/torch_rank_programs.py:
sharded_graphs``) each call runs as the backend decides (eager), and again made as on
NCCL (``capturable`` patched to true there) with its compiled step capturing through
the CPU tests' stand-in for the CUDA capture. Held: the
stand-in captures once and replays after, with the collectives inside the captured
body (the mesh step's sum too, where the JAX package's ``out_shardings`` puts it), and
every result is the eager call's bit for bit; at one rank the sharded calls are the
unsharded ones exactly; the gather into one buffer is the gather into a list.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.parallel import mesh as mesh_mod
from lcvo_tpu_torch.parallel import streams as ps
from lcvo_tpu_torch.parallel.launch import run_ranks
from lcvo_tpu_torch.pipeline import VisualOdometry
from lcvo_tpu_torch.utils.graphs import compile_step

WORLDS = (1, 2)
CALLS = ("ba", "match", "step")
BA_ITERS = 3
# collectives of one call: the BA's initial cost, a reduced system and a cost per
# iteration, the gather of X; the matcher's two gathers; the step's one sum
COLLECTIVES = {"ba": 2 * BA_ITERS + 2, "match": 2, "step": 1}
W, H = 160, 96
SMALL = {"image_width": W, "image_height": H,
         "state": {"max_tracks": 64, "max_candidates": 96, "max_new_per_frame": 32},
         "ransac": {"pnp_hypotheses": 64, "e_hypotheses": 64}, "klt": {"levels": 2, "iters": 3}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ba_problem(seed=0, W_=5, K=64):
    """W_ cameras along +x looking at K points, 0.3 px of noise, the free poses and
    every landmark moved (``tests/test_torch_sharded_ba.py``'s worker scene)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-4, -2, 6], [4, 2, 14], (K, 3))
    Rs, ts, obs = [], [], []
    for w in range(W_):
        a = 0.02 * w
        Rw = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = -Rw @ np.array([0.4 * w, 0.0, 0.0])
        p = (Rw @ X.T).T + t
        Rs.append(Rw)
        ts.append(t)
        obs.append(p[:, :2] / p[:, 2:3] + rng.normal(0, 0.3 / 500.0, (K, 2)))
    tp = np.stack(ts) + rng.normal(0, 0.01, (W_, 3))
    tp[:2] = np.stack(ts)[:2]
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (f32(np.stack(Rs)), f32(tp), f32(X + rng.normal(0, 0.05, X.shape)), f32(np.stack(obs)),
            torch.ones((W_, K), dtype=torch.bool))


def _match_inputs(seed=0, nq=64, nt=48, d=32):
    rng = np.random.default_rng(seed)
    dq = rng.normal(size=(nq, d)).astype(np.float32)
    dt = rng.normal(size=(nt, d)).astype(np.float32)
    dt[: nq // 4] = dq[: nq // 4] + rng.normal(size=(nq // 4, d)).astype(np.float32) * 1e-3
    return [torch.from_numpy(dq), torch.from_numpy(rng.random(nq) < 0.9),
            torch.from_numpy(dt), torch.from_numpy(rng.random(nt) < 0.9)]


def _step_case():
    """Two streams at 160x96, each bootstrapped on its own frames, with the next frame
    and injected PnP samples (``tests/test_torch_streams.py``'s small case)."""
    cfg = load_config(overrides=SMALL)
    seq = SyntheticSequence(n_frames=12, width=W, height=H)
    frames = np.stack([seq.frame(i) for i in range(12)]).astype(np.float32)
    gap = cfg.bootstrap.frame_gap
    vos = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a weak-bootstrap warning changes nothing here
        for s in range(2):
            vo = VisualOdometry(cfg, seq.K, device="cpu")
            vo.bootstrap(list(frames[s: s + gap + 1]))
            vos.append(vo)
    rng = np.random.default_rng(1)
    samples = np.stack([rng.choice(np.flatnonzero(vo.state.tracks.valid.numpy()), size=(64, 3))
                        for vo in vos])
    return {"overrides": SMALL, "K": seq.K, "states": ps.stack_streams([vo.state for vo in vos]),
            "images": torch.from_numpy(np.stack([frames[s + gap + 1] for s in range(2)])),
            "samples": torch.from_numpy(samples).long()}


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Each world's ranks' results (``tests/torch_rank_programs.py:sharded_graphs``)."""
    inputs = {"ba": {"problem": _ba_problem(), "kw": {"iters": BA_ITERS, "n_fix": 2}},
              "match": _match_inputs(), "step": _step_case()}
    d = tmp_path_factory.mktemp("sharded_graphs")
    torch.save(inputs, d / "inputs.pt")
    out = {}
    for world in WORLDS:
        run_ranks("tests/torch_rank_programs.py:sharded_graphs", world,
                  [str(d / "inputs.pt"), str(d / f"w{world}")], device="cpu", timeout=240)
        out[world] = [dict(np.load(d / f"w{world}_rank{r}.npz")) for r in range(world)]
    return out


def _tree(got: dict, tag: str) -> list:
    keys = sorted((k for k in got if k.startswith(tag + "/") and k[len(tag) + 1:].isdigit()),
                  key=lambda k: int(k.rsplit("/", 1)[1]))
    return [got[k] for k in keys]


def _bits_equal(a: list, b: list) -> bool:
    return len(a) == len(b) > 0 and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


@pytest.fixture
def gloo_world_of_one(tmp_path):
    """A gloo group of one rank in this process and its mesh, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield mesh_mod.make_mesh(1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_capturable_is_true_for_nccl_and_false_for_gloo(gloo_world_of_one, monkeypatch):
    """The backend decides: a gloo group's collectives are not capturable, and the
    compiled sharded step runs eagerly; a group that reports NCCL (whose tensors are on
    the card) is, and the step captures in ``thread_local`` mode; the mesh keeps one step
    per key."""
    mesh = gloo_world_of_one
    assert mesh_mod.capturable(mesh, "data") is False
    step = mesh_mod.compile_sharded(lambda: lambda x: x, mesh, "data", ("probe", 1))
    assert step.eager and step.capture_mode == "thread_local" and not step.donate
    assert mesh_mod.compile_sharded(lambda: lambda x: x, mesh, "data", ("probe", 1)) is step
    monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda group=None: "nccl")
    assert mesh_mod.capturable(mesh, "data") is True
    assert not mesh_mod.compile_sharded(lambda: lambda x: x, mesh, "data", ("probe", 2)).eager
    # an eager step reports that it did not replay, on the card too
    eager = compile_step(lambda x: x + 1, eager=True)
    assert torch.equal(eager(torch.zeros(2)), torch.ones(2)) and eager.replayed is False


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_call_captures_once_and_replays(rank_results, world, call):
    """Through the stand-in each call captures once (one key) and replays at every call
    after, with all of its collectives inside the captured body; the mesh step's sum
    over ranks is in the graph made as on NCCL and after the step on gloo."""
    for r, got in enumerate(rank_results[world]):
        assert int(got[f"{call}/captures"]) == 1, f"rank {r}"
        assert int(got[f"{call}/replays"]) == 3, f"rank {r}"
        assert int(got[f"{call}/collectives_in_capture"]) == COLLECTIVES[call], f"rank {r}"
        assert all(bool(got[f"{call}/standin{k}_replayed"]) for k in range(3))
        assert not bool(got[f"{call}/eager_replayed"])
    if call == "step":
        assert all(bool(g["step/standin_sum_in_graph"]) and not bool(g["step/eager_sum_in_graph"])
                   for g in rank_results[world])


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_call_through_the_capture_equals_eager(rank_results, world, call):
    """Every call through the stand-in gives the eager call's results bit for bit (the
    BA result, the matcher's idx and ok, the step's states, results and ``agg``), and
    every rank holds the same replicated results."""
    for r, got in enumerate(rank_results[world]):
        eager = _tree(got, f"{call}/eager")
        for k in range(3):
            assert _bits_equal(_tree(got, f"{call}/standin{k}"), eager), f"rank {r} call {k}"
        if call != "step":
            assert _bits_equal(eager, _tree(rank_results[world][0], f"{call}/eager"))


def test_world_of_one_equals_the_unsharded_calls(rank_results):
    """At one rank the sharded BA is ``ba_solve`` and the sharded matcher is
    ``knn_match_ratio``, bit for bit, and the BA lowered its cost."""
    (got,) = rank_results[1]
    assert _bits_equal(_tree(got, "ba/eager"), _tree(got, "ba/one"))
    assert _bits_equal(_tree(got, "match/eager"), _tree(got, "match/one"))
    R, t, X, cost0, cost = _tree(got, "ba/eager")
    assert float(cost) < float(cost0)


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_into_one_buffer_equals_the_list_gather(rank_results, world):
    """``mesh.all_gather`` (one collective into one buffer) equals a gather into a list
    of tensors concatenated, for float32, int64 and bool, on every rank."""
    for got in rank_results[world]:
        assert all(bool(got[f"gather/{dt}"]) for dt in (torch.float32, torch.int64, torch.bool))

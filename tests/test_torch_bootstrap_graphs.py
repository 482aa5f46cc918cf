"""The compiled bootstrap (``VisualOdometry._compile_steps``: ``detect0``, ``track_pair``,
``two_view_init``, the pyramid of a frame, the SIFT features of a frame and
``mutual_match``) and the SVD wrapper it reaches (``lcvo_tpu_torch/ops/svd.py``), on the
CPU.

The CUDA capture is replaced by ``tests/test_torch_graphs.py``'s stand-in (``StandIn``),
at that file's size: graphed and eager bootstraps from one seed must agree bit for bit
for the KLT init (the dataclass defaults) and for the SIFT init
(``configs/reference.yaml``: SIFT on both endpoint frames, mutual matching, five-point),
a re-bootstrap must capture nothing new, and the key chain must be the eager one across
a bootstrap and the steps after it. On the CPU the SVD wrapper is
``torch.linalg.svd``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.ops import svd as svd_mod
from lcvo_tpu_torch.pipeline import VisualOdometry
from test_torch_graphs import SMALL, StandIn, _equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_YAML = os.path.join(ROOT, "configs", "reference.yaml")
INITS = {
    "klt": lambda **over: load_config(overrides={**SMALL, **over}),
    "sift": lambda **over: load_config(REFERENCE_YAML, overrides={
        **SMALL, "descriptor": {"max_keypoints": 384}, **over}),
}
# the bootstrap's compiled pieces, by init method
PIECES = {"klt": {"build_pyramid", "detect0", "track_pair", "two_view_init"},
          "sift": {"build_pyramid", "sift_features", "mutual_match", "two_view_init"}}


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


def _loop(cfg, K, graphed: bool):
    """A host loop, its steps through the stand-in (``graphed``) or eager, and the
    outputs of every ``two_view_init`` call it makes."""
    vo = VisualOdometry(cfg, K, device="cpu")
    standin = None
    if graphed:
        standin = StandIn()
        vo._compile_steps(capture=standin)
    vo._two_view = _Watched(vo._two_view)
    return vo, standin, vo._two_view.outputs


class _Watched:
    """A compiled step that keeps what each call returns (and is otherwise the step)."""

    def __init__(self, step):
        self.step, self.outputs = step, []

    def __call__(self, *args):
        self.outputs.append(self.step(*args))
        return self.outputs[-1]

    def __getattr__(self, name):
        return getattr(self.step, name)


def _boot(vo, frames, rebootstrap: bool):
    """The first bootstrap over ``frame_gap + 1`` frames; with ``rebootstrap``, then a
    re-bootstrap over ``rebootstrap_skip + 1`` later frames, anchored and scaled as the
    host loop anchors one."""
    b = vo.cfg.bootstrap
    kernels.reset_launches()
    n = [vo.bootstrap(list(frames[: b.frame_gap + 1]))]
    if rebootstrap:
        R0, t0 = vo._host_pose()
        start = b.frame_gap + 6
        n.append(vo.bootstrap(list(frames[start: start + b.rebootstrap_skip + 1]),
                              R0=R0, t0=t0, scale=0.7))
    return n, dict(kernels.LAUNCHES)


@pytest.mark.parametrize("init", list(INITS))
def test_compiled_bootstrap_equals_eager(seq, frames, init):
    """Graphed = eager bit for bit: ``two_view_init``'s R, t, X, ok and inlier count,
    the count ``bootstrap`` returns, every leaf of the state after it and the launch
    counters; each piece captured once, and only the pieces of this init method."""
    cfg = INITS[init]()
    assert cfg.bootstrap.init_method == init
    runs = {}
    for name in ("eager", "graphed"):
        vo, standin, views = _loop(cfg, seq.K, name == "graphed")
        n, launches = _boot(vo, frames, rebootstrap=False)
        runs[name] = (vo, standin, views, n, launches)
    vo, standin, views, n, launches = runs["graphed"]
    e_vo, _, e_views, e_n, e_launches = runs["eager"]
    assert n == e_n and n[0] > 20 and launches == e_launches
    assert len(views) == len(e_views) == 1 and _equal(views, e_views)
    assert _equal(vo.state, e_vo.state)
    boot = {g["name"] for g in vo.graph_stats()["graphs"]}
    assert boot == PIECES[init]
    assert all(c.captures() == 1 for c in vo._compiled() if c.name in boot)
    assert len(standin.captured) == len(boot)


@pytest.mark.parametrize("init", list(INITS))
def test_rebootstrap_captures_nothing_new(seq, frames, init):
    """A re-bootstrap over ``rebootstrap_skip + 1`` frames after a first one over
    ``frame_gap + 1`` replays the graphs of the first (one graph per hop, not per burst)
    and gives the eager re-bootstrap's results and state bit for bit."""
    cfg = INITS[init](bootstrap={"frame_gap": 4, "rebootstrap_skip": 2})
    runs = {}
    for name in ("eager", "graphed"):
        vo, standin, views = _loop(cfg, seq.K, name == "graphed")
        n, launches = _boot(vo, frames, rebootstrap=True)
        runs[name] = (vo, standin, views, n, launches)
    vo, standin, views, n, launches = runs["graphed"]
    e_vo, _, e_views, e_n, e_launches = runs["eager"]
    assert len(standin.captured) == len(PIECES[init])
    assert all(g["replays"] >= 2 for g in vo.graph_stats()["graphs"])
    assert n == e_n and launches == e_launches
    assert _equal(views, e_views) and _equal(vo.state, e_vo.state)


@pytest.mark.parametrize("init", list(INITS))
def test_random_stream_after_bootstrap_and_steps_equals_eager(seq, frames, init):
    """One key chain feeds ``two_view_init``'s graph and the per-frame step's draws:
    after a bootstrap and 5 steps the chain, the poses and the state equal the eager
    run's."""
    cfg = INITS[init]()
    gap = cfg.bootstrap.frame_gap
    runs = {}
    for name in ("eager", "graphed"):
        vo, _, _ = _loop(cfg, seq.K, name == "graphed")
        vo.bootstrap(list(frames[: gap + 1]))
        res = [vo.step(f) for f in frames[gap + 1: gap + 6]]
        runs[name] = (vo, res)
    (vo, res), (e_vo, e_res) = runs["graphed"], runs["eager"]
    assert np.array_equal(vo._key, e_vo._key)
    assert _equal(res, e_res) and _equal(vo.state, e_vo.state)
    assert vo._process.captures() == 1


SHAPES = {"eight_point": ((512, 8, 9), False), "project_to_essential": ((512, 3, 3), True),
          "decompose_essential": ((3, 3), True), "five_point": ((51, 5, 9), True)}


@pytest.mark.parametrize("site", list(SHAPES))
def test_svd_on_the_cpu_is_torch_linalg_svd(site):
    """At each call site's shape a CPU tensor runs ``torch.linalg.svd`` exactly, launches
    nothing and records no failure."""
    shape, full = SHAPES[site]
    A = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(np.float32))
    kernels.reset_launches()
    svd_mod.reset("cpu")
    got = svd_mod.svd(A, full_matrices=full, site=site)
    want = torch.linalg.svd(A, full_matrices=full)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.LAUNCHES["svd"] == 0 and not svd_mod.record("cpu").any()


def test_a_failed_record_raises_naming_the_call_site_and_matrix():
    """The record names the call site and the matrix of a failure, and raises nothing:
    all zero reads as no failure; a batch with two NaN matrices at ``five_point`` leaves
    that row at [2, the first of them, -1] (no solver code on the CPU), read back as
    ``{"five_point": 2}``; a later call of the site that fails elsewhere keeps the first
    call's row; a tensor on another device than the CPU or CUDA is refused."""
    assert svd_mod.failures(np.zeros((len(svd_mod.SITES), 3))) == {}
    A = torch.from_numpy(np.random.default_rng(5).normal(size=(51, 5, 9)).astype(np.float32))
    A[7, 2, 4] = float("nan")
    A[30, 0, 0] = float("inf")
    svd_mod.reset("cpu")
    svd_mod.svd(A, site="five_point")
    B = A.clone()
    B[0, 0, 0] = float("nan")
    svd_mod.svd(B, site="five_point")
    rows = svd_mod.record("cpu").numpy()
    assert rows[svd_mod.SITES.index("five_point")].tolist() == [2, 7, -1]
    assert svd_mod.failures(rows.reshape(-1)) == {"five_point": 2}
    with pytest.raises(ValueError, match="meta"):
        svd_mod.svd(torch.empty((4, 3, 3), device="meta"), site="decompose_essential")

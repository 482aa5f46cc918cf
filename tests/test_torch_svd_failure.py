"""An SVD that fails gives NaN, in the port as in the JAX package, and nothing raises
(``lcvo_tpu_torch/ops/svd.py``).

``jnp.linalg.svd`` writes NaN into ``s``, ``u`` and ``vt`` of each matrix whose solver
reports a failure and leaves the rest of the batch alone. The port does the same on the
CPU and the card, for matrices with a non-finite entry too. A hypothesis whose SVD failed
is then scored like any other: its MSAC score is NaN, and ``argmin`` returns the index of
a NaN in both packages, so the NaN hypothesis wins, the essential matrix is NaN with no
inlier, and the host loop treats the bootstrap as weak (it extends or slides the window,
``lcvo_tpu/pipeline.py:1018-1075``).

Held here against the JAX package on the CPU, on inputs made with numpy from a seed: the
SVD itself (NaN mask exact, the finite matrices ``torch.linalg.svd``'s bits), and
``essential_ransac`` and ``two_view_init`` with injected minimal sets, one of which holds
a NaN point marked invalid, against a composition of the JAX package's own public
functions with the same sets (its ``essential_ransac`` draws them from its key). Then the
port's host loop with one hypothesis forced to fail.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lcvo_tpu.core import geometry as jgeo
from lcvo_tpu.ops import epipolar as jepi
from lcvo_tpu.ops import ransac as jransac
from lcvo_tpu.ops.five_point import five_point as jfive_point
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.core import geometry as tgeo
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.ops import epipolar as tepi
from lcvo_tpu_torch.ops import ransac as transac
from lcvo_tpu_torch.ops import svd as svd_mod
from lcvo_tpu_torch.ops.five_point import five_point as tfive_point
from lcvo_tpu_torch.pipeline import VisualOdometry, make_bootstrap_fns
from test_torch_graphs import SMALL

N_PTS = 64
NAN_POINT = 11                          # the point made NaN and marked invalid
SETS = {"eight_point": (32, 8, 5), "five_point": (8, 5, 3)}   # sets, set size, the set holding it
THRESH_PX = 1.0
K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=0):
    """Two views of N_PTS points (0.2 px of noise), pixel and normalized coordinates,
    with point NAN_POINT NaN in the second view and invalid."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 5], [3, 2, 12], (N_PTS, 3))
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-0.5, 0.02, 0.05])
    x1 = X[:, :2] / X[:, 2:]
    p2 = X @ R.T + t
    x2 = p2[:, :2] / p2[:, 2:] + rng.normal(0, 0.2 / K[0, 0], (N_PTS, 2))
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    x2[NAN_POINT] = np.nan
    valid = np.ones(N_PTS, bool)
    valid[NAN_POINT] = False
    to_px = lambda x: (x * K[0, 0] + K[:2, 2]).astype(np.float32)
    return x1, x2, valid, to_px(x1), to_px(x2), rng


def _sets(rng, valid, solver):
    """Minimal sets drawn among the valid points, with NAN_POINT put into one of them."""
    n, k, which = SETS[solver]
    idx = rng.choice(np.flatnonzero(valid), size=(n, k))
    idx[which, 2] = NAN_POINT
    return idx


def _jax_essential(x1, x2, valid, thresh, solver, idx):
    """``lcvo_tpu.ops.epipolar.essential_ransac``'s body, from the JAX package's public
    functions, with the minimal sets ``idx``: (E, inliers, count, winner)."""
    x1, x2, valid = jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid)
    h1 = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], -1)
    h2 = jnp.concatenate([x2, jnp.ones_like(x2[:, :1])], -1)
    if solver == "five_point":
        E_h, ok = jfive_point(x1[idx], x2[idx])
        E_h, ok = E_h.reshape(-1, 3, 3), ok.reshape(-1)
        err = jnp.where(ok[:, None], jgeo.sampson_error(E_h, h1, h2), jnp.inf)
    else:
        E_h = jepi.project_to_essential(jepi.eight_point(x1[idx], x2[idx]))
        err = jgeo.sampson_error(E_h, h1, h2)
    thr2 = thresh * thresh
    score, _ = jransac.msac_score(err, valid, thr2)
    best = jransac.best_hypothesis(score)
    E_best = E_h[best]
    inl = (jgeo.sampson_error(E_best, h1, h2) < thr2) & valid
    R0, t0, _ = jepi.recover_pose(E_best, x1, x2, inl)
    Rr, tr = jepi.refine_pose_sampson(R0, t0, x1, x2, inl.astype(x1.dtype))
    E_ref = jgeo.hat(tr) @ Rr
    inl_ref = (jgeo.sampson_error(E_ref, h1, h2) < thr2) & valid
    use_ref = jnp.sum(inl_ref) >= jnp.sum(inl)
    E = jnp.where(use_ref, E_ref, E_best)
    inl = jnp.where(use_ref, inl_ref, inl)
    return E, inl, jnp.sum(inl), best


def _port_winner(x1, x2, valid, thresh, solver, idx):
    """The port's MSAC winner on the same sets, from its public functions."""
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)
    h2 = torch.cat([x2, torch.ones_like(x2[:, :1])], -1)
    if solver == "five_point":
        E_h, ok = tfive_point(x1[idx], x2[idx])
        err = tgeo.sampson_error(E_h.reshape(-1, 3, 3), h1, h2)
        err = err.masked_fill(~ok.reshape(-1)[:, None], float("inf"))
    else:
        err = tgeo.sampson_error(tepi.project_to_essential(tepi.eight_point(x1[idx], x2[idx])),
                                 h1, h2)
    return int(transac.best_hypothesis(transac.msac_score(err, valid, thresh * thresh)[0]))


def _same_nan_and_close(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], atol=atol)


def _signed(E):
    """E and -E are one essential matrix: the sign that makes the largest entry positive."""
    flat = E.reshape(-1)
    return E if np.isnan(flat).any() else E * np.sign(flat[np.argmax(np.abs(flat))])


SHAPES = {"eight_point": ((32, 8, 9), False), "project_to_essential": ((32, 3, 3), True),
          "five_point": ((8, 5, 9), True)}


@pytest.mark.parametrize("site", list(SHAPES))
def test_svd_of_a_batch_with_a_nan_matrix_matches_jax(site):
    """Two matrices with a NaN entry each: those two are NaN in ``U``,
    ``S`` and ``Vh`` exactly where ``jnp.linalg.svd`` has NaN, the others equal
    ``torch.linalg.svd`` of the batch without them bit for bit and are finite, nothing
    raises, and the record counts the two."""
    shape, full = SHAPES[site]
    A = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    A[3, 1, 2] = np.nan
    A[5, 0, 0] = np.nan
    svd_mod.reset("cpu")
    got = svd_mod.svd(torch.from_numpy(A), full_matrices=full, site=site)
    want_j = jnp.linalg.svd(jnp.asarray(A), full_matrices=full)
    keep = [i for i in range(shape[0]) if i not in (3, 5)]
    want_t = torch.linalg.svd(torch.from_numpy(A[keep]), full_matrices=full)
    for g, j, w in zip(got, (want_j[0], want_j[1], want_j[2]), want_t):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(j)))
        nan = np.isnan(g.numpy()).reshape(shape[0], -1)
        assert nan[[3, 5]].all() and not nan[keep].any()
        assert torch.equal(g[keep], w)
    assert svd_mod.failures(svd_mod.record("cpu")) == {site: 2}


def test_a_matrix_lapack_does_not_converge_on_is_nan(monkeypatch):
    """Where ``torch.linalg.svd`` raises for a finite matrix (LAPACK did not converge;
    stood in for here by a matrix it is made to refuse), that matrix alone is NaN, every
    other matrix is ``torch.linalg.svd``'s bit for bit, and the record counts it."""
    A = np.random.default_rng(9).normal(size=(6, 3, 3)).astype(np.float32)
    A[4, 0, 0] = 1234.5
    real = torch.linalg.svd

    def refusing(a, full_matrices=True):
        if bool((a.reshape(-1, 9)[:, 0] == 1234.5).any()):
            raise torch.linalg.LinAlgError("linalg.svd: the algorithm failed to converge")
        return real(a, full_matrices=full_matrices)

    monkeypatch.setattr(torch.linalg, "svd", refusing)
    svd_mod.reset("cpu")
    got = svd_mod.svd(torch.from_numpy(A), site="kabsch")
    keep = [0, 1, 2, 3, 5]
    for g, w in zip(got, real(torch.from_numpy(A[keep]))):
        assert torch.isnan(g[4]).all() and torch.equal(g[keep], w)
    assert svd_mod.failures(svd_mod.record("cpu")) == {"kabsch": 1}


@pytest.mark.parametrize("solver", list(SETS))
def test_essential_ransac_with_a_failed_hypothesis_matches_jax(solver):
    """``essential_ransac(idx=)`` with one minimal set holding a NaN point (marked
    invalid) against the JAX composition on the same sets: the same MSAC winner (the
    same set for five-point), E with the same NaN pattern (and within 1e-3 up to sign
    where finite), the same inliers and count. For
    the eight-point solver the NaN hypothesis wins in both packages: E is NaN and no
    point is an inlier."""
    x1, x2, valid, _, _, rng = _scene()
    idx = _sets(rng, valid, solver)
    thresh = THRESH_PX / float(K[0, 0])
    E_j, inl_j, n_j, best_j = _jax_essential(x1, x2, valid, thresh, solver, idx)
    t1, t2, tv, tidx = (torch.from_numpy(v) for v in (x1, x2, valid, idx))
    E, inl, n = tepi.essential_ransac(None, t1, t2, tv, thresh, n_hyp=10 * len(idx),
                                      solver=solver, idx=tidx)
    # a five-point set's ten solutions come in another order in each package (the null
    # space basis is not unique, ROADMAP's five-point tolerances): the same set wins
    per_set = 10 if solver == "five_point" else 1
    assert _port_winner(t1, t2, tv, thresh, solver, tidx) // per_set == int(best_j) // per_set
    _same_nan_and_close(_signed(E.numpy()), _signed(np.asarray(E_j)), 1e-3)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    assert int(n) == int(n_j)
    if solver == "eight_point":
        assert int(best_j) == SETS[solver][2]
        assert np.isnan(E.numpy()).all() and int(n) == 0
    else:
        assert int(n) > N_PTS // 2


@pytest.mark.parametrize("solver", list(SETS))
def test_two_view_init_with_a_failed_hypothesis_matches_jax(solver):
    """The port's ``two_view_init`` with the same injected sets against the JAX
    package's ``two_view_init`` body (``lcvo_tpu/pipeline.py:387-418``) composed on the
    JAX composition of ``essential_ransac``: R, t and X with the same NaN pattern and
    within 1e-3 where finite, the ``ok`` mask and the inlier count equal. Eight-point:
    a NaN pose with an empty mask and 0 inliers."""
    x1, x2, valid, p1, p2, rng = _scene()
    idx = _sets(rng, valid, solver)
    cfg = load_config(overrides={"ransac": {"e_solver": solver, "e_thresh_px": THRESH_PX,
                                            "e_hypotheses": 10 * len(idx)}})
    _, _, two_view_init = make_bootstrap_fns(cfg, K, "cpu")
    R, t, X, ok, n = two_view_init(None, torch.from_numpy(p1), torch.from_numpy(p2),
                                   torch.from_numpy(valid), e_idx=torch.from_numpy(idx))

    Kj = jnp.asarray(K)
    x0j, x1j = jgeo.normalize_points(jnp.asarray(p1), Kj), jgeo.normalize_points(jnp.asarray(p2), Kj)
    E_j, inl_j, n_j, _ = _jax_essential(x0j, x1j, valid, THRESH_PX / float(K[0, 0]), solver, idx)
    R_j, t_j, _ = jepi.recover_pose(E_j, x0j, x1j, inl_j)
    X_j = jgeo.triangulate_linear(jnp.eye(3), jnp.zeros(3), R_j, t_j, x0j, x1j)
    uv1, _ = jgeo.project(Kj, R_j, t_j, X_j)
    md = cfg.triangulation.min_depth * 0.25
    ok_j = (inl_j & (X_j[:, 2] > md) & (jgeo.se3_apply(R_j, t_j, X_j)[:, 2] > md)
            & (jnp.sum((uv1 - jnp.asarray(p2)) ** 2, -1) < THRESH_PX ** 2 * 16.0))

    _same_nan_and_close(R.numpy(), R_j, 1e-3)
    _same_nan_and_close(t.numpy(), t_j, 1e-3)
    _same_nan_and_close(X.numpy(), X_j, 1e-2)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    assert int(n) == int(n_j)
    if solver == "eight_point":
        assert np.isnan(R.numpy()).all() and not ok.numpy().any() and int(n) == 0


# -- the host loop ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(n_frames=40, width=320, height=128, speed=0.3)
    return seq, np.stack([seq.frame(i) for i in range(40)])


class _FailOnce:
    """``svd_plain`` with matrix 0 of the next ``arm`` eight-point fits made NaN, as a
    matrix that did not converge comes back."""

    def __init__(self, monkeypatch, n_hyp):
        self.plain, self.n_hyp, self.armed = svd_mod.svd_plain, n_hyp, 0
        monkeypatch.setattr(svd_mod, "svd_plain", self)

    def __call__(self, A, full_matrices=True):
        U, S, Vh = self.plain(A, full_matrices)
        if self.armed and tuple(A.shape) == (self.n_hyp, 8, 9):
            self.armed -= 1
            U, S, Vh = (x.clone() for x in (U, S, Vh))
            for x in (U, S, Vh):
                x[0] = float("nan")
        return U, S, Vh


def _watch_bootstraps(vo, frames):
    """Record, for each bootstrap, the index of its first frame, its length and the
    inlier count it returned."""
    calls, boot = [], vo.bootstrap

    def bootstrap(burst, *a, **k):
        n = boot(burst, *a, **k)
        first = next(i for i, f in enumerate(frames) if np.array_equal(f, burst[0]))
        calls.append((first, len(burst), n, vo.last_bootstrap_svd_failures))
        return n

    vo.bootstrap = bootstrap
    return calls


def test_a_failed_bootstrap_extends_the_window(monkeypatch, frames):
    """``run`` with the first bootstrap's eight-point hypothesis 0 made NaN: nothing
    raises, that bootstrap returns 0 inliers with a NaN pose and 3 failed matrices in
    the record (the fit, its projection and the first decomposition of the winner), the
    window grows by one frame (``lcvo_tpu/pipeline.py:1018-1033``) and that bootstrap
    succeeds; one pose per frame, the first held and flagged."""
    seq, fr = frames
    cfg = load_config(overrides=SMALL)
    fail = _FailOnce(monkeypatch, cfg.ransac.e_hypotheses)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    calls = _watch_bootstraps(vo, fr)
    fail.armed = 1
    n_frames = 14
    traj = vo.run(iter(fr), n_frames)
    gap = cfg.bootstrap.frame_gap
    assert calls[0] == (0, gap + 1, 0, 3)
    assert calls[1][:2] == (0, gap + 2) and calls[1][2] >= cfg.bootstrap.min_matches
    assert calls[1][3] == 0 and len(calls) == 2
    assert len(traj) == n_frames - gap
    assert np.isnan(traj[0]).all() and not vo.pose_ok_flags[0]
    assert np.isfinite(np.stack(traj[1:])).all() and all(vo.pose_ok_flags[1:])


def test_a_failed_rebootstrap_slides_the_window(monkeypatch, frames):
    """``run_continue`` after a collapse (health forced to 2 at one frame): the
    re-bootstrap over ``rebootstrap_skip + 1`` frames has its eight-point hypothesis 0
    made NaN, returns 0 inliers and nothing raises; the loop slides the burst forward one
    frame (``lcvo_tpu/pipeline.py:1050-1062``) and the next re-bootstrap succeeds."""
    seq, fr = frames
    cfg = load_config(overrides={**SMALL, "bootstrap": {"frame_gap": 4, "rebootstrap_skip": 2}})
    fail = _FailOnce(monkeypatch, cfg.ransac.e_hypotheses)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    step, collapse_at = vo.step, 8

    def collapsing_step(img):
        res = step(img)
        if np.array_equal(img, fr[collapse_at]):
            vo.state = vo.state._replace(health=torch.full_like(vo.state.health, 2))
            fail.armed = 1
        return res

    vo.step = collapsing_step
    calls = _watch_bootstraps(vo, fr)
    n_frames = 16
    traj = vo.run(iter(fr), n_frames)
    skip = cfg.bootstrap.rebootstrap_skip
    assert vo.n_rebootstraps == 1
    assert [c[:3] for c in calls[1:2]] == [(collapse_at, skip + 1, 0)]
    assert calls[2][:2] == (collapse_at + 1, skip + 1) and calls[2][2] >= cfg.bootstrap.min_matches
    assert len(calls) == 3 and len(traj) == n_frames - cfg.bootstrap.frame_gap

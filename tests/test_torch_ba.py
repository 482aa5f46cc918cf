"""The port's sliding-window BA against the JAX package on the same numpy inputs, and
the port's counterparts of the single-device tests of ``tests/test_ba.py``.

Stated tolerances (float32 on the CPU; the two packages sum over the landmark axis in
different orders):

- ``_residuals_jacobians``, ``_inv3``, ``_apply_pose_delta``: <= 1e-5 relative to the
  largest entry of each output;
- ``assemble_blocks``: each of its six outputs <= 2e-4 relative to its largest entry
  (``S`` and ``rhs`` are differences of sums over K = 128 landmarks);
- ``_solve_reduced`` on the same ``S``: <= 1e-3 relative (a 36x36 LU in float32);
- ``ba_solve`` / ``refine_window``: ``cost0`` <= 1e-5 relative, final ``cost`` within
  5% or 1e-9, R <= 2e-4, t <= 2e-3, X <= 2e-2 on adjusted landmarks (five to ten LM
  steps on a problem that is weakly conditioned along the gauge);
- window bookkeeping (``push``, ``gather_problem``: order, mask, ring fields): exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.core import geometry as jgeo
from lcvo_tpu.core import state as jst
from lcvo_tpu.ops import pnp as jpnp
from lcvo_tpu.solve.ba import schur as jschur
from lcvo_tpu.solve.ba import window as jwin
from lcvo_tpu_torch.core import geometry as tgeo
from lcvo_tpu_torch.core import state as tst
from lcvo_tpu_torch.ops import pnp as tpnp
from lcvo_tpu_torch.solve.ba import schur as tschur
from lcvo_tpu_torch.solve.ba import window as twin


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def rel(a, b):
    a, b = N(a).astype(np.float64), N(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _rodrigues(rv):
    return np.asarray(jgeo.rodrigues(jnp.asarray(rv, jnp.float32)))


def _make_scene(rng, W=6, K=80, noise_px=0.0, fx=500.0):
    """W cameras moving along +x looking at a cloud of K points (tests/test_ba.py)."""
    X = rng.uniform([-4, -2, 6], [4, 2, 14], (K, 3))
    Rs, ts, obs = [], [], []
    for w in range(W):
        ang = 0.02 * w
        Rw = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        t = -Rw @ np.array([0.4 * w, 0.0, 0.0])
        p = (Rw @ X.T).T + t
        xy = p[:, :2] / p[:, 2:3]
        xy = xy + rng.normal(0, noise_px / fx, xy.shape)
        Rs.append(Rw)
        ts.append(t)
        obs.append(xy)
    return (np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32),
            X.astype(np.float32), np.stack(obs).astype(np.float32))


def random_window(seed=0, W=6, K=128):
    """A window with ~30% of the mask off, some points behind a camera, some residuals
    far above the Huber threshold, perturbed poses and landmarks."""
    rng = np.random.default_rng(seed)
    R, t, X, obs = _make_scene(rng, W=W, K=K, noise_px=0.5)
    X[:6, 2] = -3.0                                    # behind every camera
    obs[rng.integers(0, W, 40), rng.integers(0, K, 40)] += 0.05   # gross outliers
    mask = rng.random((W, K)) > 0.3
    for w in range(W):
        R[w] = _rodrigues(rng.normal(0, 0.01, 3)) @ R[w]
    t = t + rng.normal(0, 0.03, t.shape).astype(np.float32)
    X = X + rng.normal(0, 0.08, X.shape).astype(np.float32)
    return R, t, X, obs, mask


HUBER = 2.0 / 500.0


# ---------------------------------------------------------------------------
# schur.py, function by function
# ---------------------------------------------------------------------------


def test_residuals_jacobians_match_jax():
    R, t, X, obs, mask = random_window()
    jout = jschur._residuals_jacobians(*map(jnp.asarray, (R, t, X, obs, mask)), HUBER)
    tout = tschur._residuals_jacobians(*map(T, (R, t, X, obs, mask)), HUBER)
    # the scene really has what the docstring promises
    p = np.einsum("wij,kj->wki", R, X) + t[:, None]
    assert (p[..., 2] < 0).any()
    rn = np.linalg.norm(p[..., :2] / p[..., 2:3] - obs, axis=-1)
    assert ((rn > HUBER) & mask & (p[..., 2] > 1e-3)).sum() > 20
    for name, a, b in zip(("r", "Jp", "Jx", "cost"), tout, jout):
        assert rel(a, b) <= 1e-5, name
    assert tout[1].shape == (6, 128, 2, 6) and tout[2].shape == (6, 128, 2, 3)


def test_inv3_matches_jax_and_inverts():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    A[0] = 0.0                                      # singular: the guarded determinant
    ti, ji = tschur._inv3(T(A)), jschur._inv3(jnp.asarray(A))
    assert rel(ti[1:], np.asarray(ji)[1:]) <= 1e-5
    np.testing.assert_array_equal(N(ti[0]), np.asarray(ji[0]))
    np.testing.assert_allclose(N(ti[1:]) @ A[1:], np.broadcast_to(np.eye(3), (49, 3, 3)),
                               atol=1e-3)


@pytest.mark.parametrize("lam", [1e-4, 0.5])
def test_assemble_blocks_match_jax(lam):
    R, t, X, obs, mask = random_window()
    jout = jschur.assemble_blocks(*map(jnp.asarray, (R, t, X, obs, mask)), HUBER, lam)
    tout = tschur.assemble_blocks(*map(T, (R, t, X, obs, mask)), HUBER,
                                  torch.full((), lam))
    names = ("S", "rhs", "U", "Hll_inv", "bl", "cost")
    shapes = ((6, 6, 6, 6), (6, 6), (6, 128, 6, 3), (128, 3, 3), (128, 3), ())
    for name, shape, a, b in zip(names, shapes, tout, jout):
        assert tuple(a.shape) == shape, name
        assert rel(a, b) <= 2e-4, (name, rel(a, b))
    # a float lam gives what the 0-d tensor gives
    tout_f = tschur.assemble_blocks(*map(T, (R, t, X, obs, mask)), HUBER, lam)
    for a, b in zip(tout, tout_f):
        np.testing.assert_array_equal(N(a), N(b))


def test_block_diagonal_write_puts_each_pose_block_on_its_own_diagonal():
    """``Hpp_full[arange(W), :, arange(W), :] = v``: the two index tensors are split by
    a slice, so the broadcast axis leads and ``v`` is (W, 6, 6). A non-symmetric fill
    shows a transposed or misplaced block."""
    W = 4
    v = torch.arange(W * 36, dtype=torch.float32).reshape(W, 6, 6)
    ar = torch.arange(W)
    full = torch.zeros((W, 6, W, 6))
    full[ar, :, ar, :] = v
    jfull = jnp.zeros((W, 6, W, 6)).at[jnp.arange(W), :, jnp.arange(W), :].set(jnp.asarray(N(v)))
    np.testing.assert_array_equal(N(full), np.asarray(jfull))
    for w in range(W):
        for u in range(W):
            want = N(v[w]) if u == w else np.zeros((6, 6), np.float32)
            np.testing.assert_array_equal(N(full[w, :, u, :]), want)
    # and in assemble_blocks itself: without any coupling (one landmark view per pose
    # is masked off entirely) S is exactly that block diagonal
    R, t, X, obs, _ = random_window(W=W, K=16)
    none = np.zeros((W, 16), bool)
    S = tschur.assemble_blocks(*map(T, (R, t, X, obs, none)), HUBER, 0.25)[0]
    for w in range(W):
        for u in range(W):
            want = 0.25 * np.eye(6, dtype=np.float32) if u == w else np.zeros((6, 6), np.float32)
            np.testing.assert_array_equal(N(S[w, :, u, :]), want)


@pytest.mark.parametrize("fix", [[True, True, False, False, False, False],
                                 [False, False, True, False, True, True],
                                 [True] * 6], ids=["first2", "mixed", "all_frozen"])
def test_solve_reduced_matches_jax_and_freezes_exactly(fix):
    R, t, X, obs, mask = random_window()
    S, rhs, *_ = jschur.assemble_blocks(*map(jnp.asarray, (R, t, X, obs, mask)), HUBER, 1e-4)
    fix = np.asarray(fix)
    jd = jschur._solve_reduced(S, rhs, jnp.asarray(fix))
    td = tschur._solve_reduced(T(S), T(rhs), T(fix))
    assert td.shape == (6, 6)
    np.testing.assert_array_equal(N(td)[fix], 0.0)     # frozen δ is exactly 0
    if fix.all():
        # every row frozen: the system is the identity and δ is 0 everywhere
        np.testing.assert_array_equal(N(td), 0.0)
        np.testing.assert_array_equal(np.asarray(jd), 0.0)
    else:
        assert rel(td, jd) <= 1e-3
        assert np.abs(N(td)[~fix]).max() > 0


def test_apply_pose_delta_matches_jax_also_at_zero():
    R, t, *_ = random_window()
    rng = np.random.default_rng(2)
    delta = rng.normal(0, 0.02, (6, 6)).astype(np.float32)
    delta[:2] = 0.0            # frozen poses: rodrigues at exactly 0 (small-angle branch)
    jR, jt = jschur._apply_pose_delta(jnp.asarray(R), jnp.asarray(t), jnp.asarray(delta))
    tR, tt = tschur._apply_pose_delta(T(R), T(t), T(delta))
    assert rel(tR, jR) <= 1e-5 and rel(tt, jt) <= 1e-5
    np.testing.assert_array_equal(N(tR)[:2], R[:2])
    np.testing.assert_array_equal(N(tt)[:2], t[:2])
    assert torch.isfinite(tR).all()


def test_hat_and_rodrigues_take_leading_dimensions():
    """BA calls ``hat`` on (W, K, 3) and ``rodrigues`` on (W, 3)."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(4, 7, 3)).astype(np.float32)
    jh = jax.vmap(jax.vmap(jgeo.hat))(jnp.asarray(p))
    np.testing.assert_array_equal(N(tgeo.hat(T(p))), np.asarray(jh))
    rv = rng.normal(0, 0.5, (5, 3)).astype(np.float32)
    rv[0] = 0.0
    jr = jax.vmap(jgeo.rodrigues)(jnp.asarray(rv))
    assert rel(tgeo.rodrigues(T(rv)), jr) <= 1e-6


# ---------------------------------------------------------------------------
# ba_solve
# ---------------------------------------------------------------------------


def _perturbed_scene(seed=0):
    rng = np.random.default_rng(seed)
    R, t, X, obs = _make_scene(rng)
    W = obs.shape[0]
    t_p, R_p = t.copy(), R.copy()
    for w in range(2, W):
        R_p[w] = _rodrigues(rng.normal(0, 0.01, 3)) @ R[w]
        t_p[w] = t[w] + rng.normal(0, 0.05, 3)
    X_p = X + rng.normal(0, 0.1, X.shape).astype(np.float32)
    return (R, t, X), (R_p, t_p, X_p, obs, np.ones(obs.shape[:2], bool))


def _outlier_scene():
    rng = np.random.default_rng(1)
    R, t, X, obs = _make_scene(rng, noise_px=0.3)
    W, K = obs.shape[:2]
    n_out = (W * K) // 10
    iw, ik = rng.integers(0, W, n_out), rng.integers(0, K, n_out)
    obs[iw, ik] += rng.uniform(0.05, 0.2, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    X_p = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    return (R, t, X), (R, t, X_p, obs, np.ones((W, K), bool))


def _centers(R, t):
    return np.stack([-N(R[w]).T @ N(t[w]) for w in range(len(R))])


def _both_solve(arrs, **kw):
    jkw = {k: (jnp.asarray(v) if k == "fix_rows" else v) for k, v in kw.items()}
    tkw = {k: (T(v) if k == "fix_rows" else v) for k, v in kw.items()}
    jres = jschur.ba_solve(jschur.BAProblem(*map(jnp.asarray, arrs)), **jkw)
    tres = tschur.ba_solve(tschur.BAProblem(*map(T, arrs)), **tkw)
    return tres, jres


def _check_same_result(tres, jres, sel=None):
    assert rel(tres.cost0, jres.cost0) <= 1e-5
    c, jc = float(tres.cost), float(jres.cost)
    assert abs(c - jc) <= max(0.05 * jc, 1e-9), (c, jc)
    np.testing.assert_allclose(N(tres.R), np.asarray(jres.R), atol=2e-4)
    np.testing.assert_allclose(N(tres.t), np.asarray(jres.t), atol=2e-3)
    tX, jX = N(tres.X), np.asarray(jres.X)
    if sel is not None:
        tX, jX = tX[sel], jX[sel]
    np.testing.assert_allclose(tX, jX, atol=2e-2)


def test_ba_recovers_perturbed_scene():
    (R, t, X), arrs = _perturbed_scene()
    tres, jres = _both_solve(arrs, iters=10, n_fix=2)
    assert float(tres.cost) < 1e-4 * float(tres.cost0)
    assert np.max(np.abs(_centers(tres.R, tres.t) - _centers(R, t))) < 1e-2
    _check_same_result(tres, jres)
    # the two frozen poses come back bit for bit
    np.testing.assert_array_equal(N(tres.R)[:2], arrs[0][:2])
    np.testing.assert_array_equal(N(tres.t)[:2], arrs[1][:2])


def test_ba_robust_to_outliers():
    (R, t, X), arrs = _outlier_scene()
    tres, jres = _both_solve(arrs, iters=10, n_fix=2, huber=2.0 / 500.0)
    assert float(tres.cost) < float(tres.cost0)
    assert np.max(np.abs(_centers(tres.R, tres.t) - _centers(R, t))) < 5e-2
    _check_same_result(tres, jres)


def test_ba_solve_fix_rows_matches_jax():
    """An explicit mask of frozen rows (here the newest two) instead of ``n_fix``."""
    _, arrs = _perturbed_scene(seed=4)
    fix = np.array([False, False, False, False, True, True])
    tres, jres = _both_solve(arrs, iters=6, n_fix=2, fix_rows=fix)
    _check_same_result(tres, jres)
    np.testing.assert_array_equal(N(tres.R)[fix], arrs[0][fix])
    np.testing.assert_array_equal(N(tres.t)[fix], arrs[1][fix])
    assert np.abs(N(tres.t)[~fix] - arrs[1][~fix]).max() > 1e-3


def test_ba_solve_all_frozen_is_landmarks_only():
    """Every row frozen: the reduced system is the identity, no pose moves by a bit,
    and the landmarks still improve."""
    _, arrs = _perturbed_scene(seed=5)
    tres, jres = _both_solve(arrs, iters=6, fix_rows=np.ones(6, bool))
    np.testing.assert_array_equal(N(tres.R), arrs[0])
    np.testing.assert_array_equal(N(tres.t), arrs[1])
    assert float(tres.cost) < float(tres.cost0)
    _check_same_result(tres, jres)


def test_ba_solve_never_raises_its_cost_and_returns_device_scalars():
    arrs = random_window(seed=7)
    tres, jres = _both_solve(arrs, iters=5, n_fix=2, huber=HUBER)
    assert tres.cost.shape == () and tres.cost0.shape == ()
    assert float(tres.cost) <= float(tres.cost0)
    assert rel(tres.cost0, jres.cost0) <= 1e-5


# ---------------------------------------------------------------------------
# window.py against JAX, from carried-over windows and track tables
# ---------------------------------------------------------------------------

K_MAT = np.array([[500.0, 0, 320], [0, 500.0, 160], [0, 0, 1]], np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tracks_to_torch(jtracks):
    a = _np_tree(jtracks)
    return tst.TrackTable(*[None if getattr(a, f) is None else T(getattr(a, f))
                            for f in tst.TrackTable._fields])


def _assert_windows_equal(tw, jw, pose_atol=0.0):
    for f in twin.KeyframeWindow._fields:
        a, b = N(getattr(tw, f)), np.asarray(getattr(jw, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in ("R", "t") and pose_atol:
            np.testing.assert_allclose(a, b, atol=pose_atol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _jax_window(n_push, W=6, cap=96, seed=3, bump_gen_after=None, noise=0.05):
    """A JAX window with ``n_push`` keyframes of a translating camera over ``cap``
    landmarks (older poses perturbed), and the live track table (noisy landmarks).
    ``bump_gen_after=k``: from the k-th push on, slots 0..3 belong to new landmarks."""
    rng = np.random.default_rng(seed)
    Kj = jnp.asarray(K_MAT)
    X_gt = rng.uniform([-4, -2, 6], [4, 2, 14], (cap, 3)).astype(np.float32)
    tracks = jst.make_track_table(cap)._replace(
        X=jnp.asarray(X_gt + rng.normal(0, noise, X_gt.shape).astype(np.float32)),
        valid=jnp.asarray(rng.random(cap) > 0.1),
        ang=jnp.asarray(rng.uniform(0.01, 0.2, cap).astype(np.float32)))
    win = jwin.make_window(W, cap)
    for w in range(n_push):
        Rw = _rodrigues([0.0, 0.01 * w, 0.0]).astype(np.float32)
        tw_true = np.array([-0.4 * w, 0, 0], np.float32)
        uv, _ = jgeo.project(Kj, jnp.asarray(Rw), jnp.asarray(tw_true), jnp.asarray(X_gt))
        uv = uv + rng.normal(0, 0.2, (cap, 2)).astype(np.float32)
        tw = tw_true + (rng.normal(0, 0.03, 3).astype(np.float32) if w < n_push - 2 else 0)
        if bump_gen_after is not None and w == bump_gen_after:
            tracks = tracks._replace(gen=tracks.gen.at[:4].add(1))
        seen = jnp.asarray(rng.random(cap) > 0.15) & tracks.valid
        win = jwin.push(win, tracks._replace(P=uv, valid=seen), jnp.asarray(Rw),
                        jnp.asarray(tw))
    return win, tracks


def test_make_window_matches_jax():
    _assert_windows_equal(twin.make_window(5, 12, "cpu"), jwin.make_window(5, 12))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            twin.make_window(5, 12)


def test_window_from_numpy_carries_every_field():
    jw, _ = _jax_window(4)
    tw = tst.window_from_numpy(_np_tree(jw), device="cpu")
    _assert_windows_equal(tw, jw)
    tw2 = tst.window_from_numpy(_np_tree(jw)._asdict(), device="cpu")
    _assert_windows_equal(tw2, jw)
    assert tw.head.dtype == torch.int32 and tw.obs_gen.dtype == torch.int32


@pytest.mark.parametrize("n_push", [1, 4, 6, 9], ids=["one", "partial", "full", "wrapped"])
def test_push_matches_jax(n_push):
    """The port pushes the same keyframes into its own ring: every field equal, the
    head wraps, and the input window is left as it was."""
    rng = np.random.default_rng(0)
    W, cap = 6, 32
    jw, tw = jwin.make_window(W, cap), twin.make_window(W, cap, "cpu")
    for i in range(n_push):
        P = rng.uniform(0, 300, (cap, 2)).astype(np.float32)
        gen = rng.integers(0, 5, cap).astype(np.int32)
        valid = rng.random(cap) > 0.3
        R = _rodrigues(rng.normal(0, 0.1, 3)).astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        jt = jst.make_track_table(cap)._replace(P=jnp.asarray(P), gen=jnp.asarray(gen),
                                                valid=jnp.asarray(valid))
        tt = tst.make_track_table(cap, "cpu")._replace(P=T(P), gen=T(gen), valid=T(valid))
        before = [x.clone() for x in tw]
        jw = jwin.push(jw, jt, jnp.asarray(R), jnp.asarray(t))
        tw_new = twin.push(tw, tt, T(R), T(t))
        for a, b in zip(before, tw):
            assert torch.equal(a, b)
        tw = tw_new
    _assert_windows_equal(tw, jw)
    assert int(tw.head) == n_push % W
    np.testing.assert_array_equal(N(twin._chronological_order(tw)),
                                  np.asarray(jwin._chronological_order(jw)))


@pytest.mark.parametrize("n_push,bump", [(3, None), (6, None), (9, None), (5, 3)],
                         ids=["partial", "full", "wrapped", "reused_slots"])
def test_gather_problem_matches_jax(n_push, bump):
    jw, jtracks = _jax_window(n_push, bump_gen_after=bump)
    tw, ttracks = tst.window_from_numpy(_np_tree(jw), "cpu"), _tracks_to_torch(jtracks)
    jprob, jorder = jwin.gather_problem(jw, jtracks, K_MAT)
    for K_arg in (K_MAT, T(K_MAT)):          # an array or a tensor on the device
        tprob, torder = twin.gather_problem(tw, ttracks, K_arg)
        np.testing.assert_array_equal(N(torder), np.asarray(jorder))
        np.testing.assert_array_equal(N(tprob.mask), np.asarray(jprob.mask))
        np.testing.assert_array_equal(N(tprob.R), np.asarray(jprob.R))
        np.testing.assert_array_equal(N(tprob.t), np.asarray(jprob.t))
        np.testing.assert_array_equal(N(tprob.X), np.asarray(jprob.X))
        np.testing.assert_allclose(N(tprob.obs), np.asarray(jprob.obs), atol=1e-6)
    m = N(tprob.mask)
    assert m.any()
    if bump is not None:
        # observations of slots 0..3 from before the re-use are masked
        assert not m[: 6 - n_push + bump, :4].any()


@pytest.mark.parametrize("n_push,kw", [
    (6, dict(gauge="oldest")),
    (6, dict(gauge="newest")),
    (6, dict(landmarks_only=True)),
    (3, dict(gauge="oldest")),
    (3, dict(gauge="newest")),
    (2, dict(gauge="newest")),
    (9, dict(gauge="newest")),
    (9, dict(gauge="oldest")),
], ids=["oldest", "newest", "landmarks_only", "partial_oldest", "partial_newest",
        "two_keyframes_all_frozen", "wrapped_newest", "wrapped_oldest"])
def test_refine_window_matches_jax(n_push, kw):
    jw, jtracks = _jax_window(n_push)
    tw, ttracks = tst.window_from_numpy(_np_tree(jw), "cpu"), _tracks_to_torch(jtracks)
    args = dict(iters=5, n_fix=2, huber=HUBER, lam0=1e-4, **kw)
    jw2, jtr2, jR, jt, jres = jwin.refine_window(jw, jtracks, K_MAT, **args)
    tw2, ttr2, tR, tt, tres = twin.refine_window(tw, ttracks, T(K_MAT), **args)
    adjusted = N(twin.gather_problem(tw, ttracks, K_MAT)[0].mask).sum(0) >= 2
    assert adjusted.any() and not adjusted.all()
    _check_same_result(tres, jres, sel=adjusted)
    _assert_windows_equal(tw2, jw2, pose_atol=2e-3)
    np.testing.assert_allclose(N(tR), np.asarray(jR), atol=2e-4)
    np.testing.assert_allclose(N(tt), np.asarray(jt), atol=2e-3)
    np.testing.assert_allclose(N(ttr2.X), np.asarray(jtr2.X), atol=2e-2)
    # landmarks outside the problem keep their bits; anchors retire (ang = π) on the
    # adjusted slots only
    np.testing.assert_array_equal(N(ttr2.X)[~adjusted], N(ttracks.X)[~adjusted])
    np.testing.assert_array_equal(N(ttr2.ang), np.asarray(jtr2.ang))
    assert np.all(N(ttr2.ang)[adjusted] == np.float32(math.pi))
    np.testing.assert_array_equal(N(ttr2.ang)[~adjusted], N(ttracks.ang)[~adjusted])
    # the newest keyframe's pose is what the ring now holds at the slot before head
    newest = (int(tw2.head) - 1) % tw2.R.shape[0]
    np.testing.assert_array_equal(N(tR), N(tw2.R[newest]))
    np.testing.assert_array_equal(N(tt), N(tw2.t[newest]))
    # frozen poses come back bit for bit
    order = N(twin._chronological_order(tw))
    real = N(tw.kf_valid)[order]
    if kw.get("landmarks_only") or n_push <= 2:
        frozen = real
    elif kw.get("gauge") == "newest":
        frozen = real & (np.cumsum(real[::-1])[::-1] <= 2)
    else:
        frozen = real & (np.cumsum(real) <= 2)
    np.testing.assert_array_equal(N(tw2.R)[order][frozen], N(tw.R)[order][frozen])
    np.testing.assert_array_equal(N(tw2.t)[order][frozen], N(tw.t)[order][frozen])
    if (real & ~frozen).any():
        assert np.abs(N(tw2.t)[order][real & ~frozen] - N(tw.t)[order][real & ~frozen]).max() > 0
    # inputs untouched
    _assert_windows_equal(tw, jw)


def test_refine_window_without_anchor_fields():
    """A track table without anchors (``ang`` is None) refines and keeps it None."""
    jw, jtracks = _jax_window(5)
    tw = tst.window_from_numpy(_np_tree(jw), "cpu")
    tt = _tracks_to_torch(jtracks)._replace(F=None, R_f=None, t_f=None, ang=None)
    _, tr2, _, _, res = twin.refine_window(tw, tt, T(K_MAT), iters=3, huber=HUBER)
    assert tr2.ang is None and float(res.cost) <= float(res.cost0)


# ---------------------------------------------------------------------------
# the port's counterparts of the single-device tests of tests/test_ba.py
# ---------------------------------------------------------------------------


def test_window_gen_masks_reused_slots():
    """A slot re-used for a different landmark must not leak stale observations."""
    Kcap = 8
    tracks = tst.make_track_table(Kcap, "cpu")._replace(
        P=torch.arange(Kcap * 2, dtype=torch.float32).reshape(Kcap, 2),
        X=torch.ones((Kcap, 3)), valid=torch.ones((Kcap,), dtype=torch.bool))
    w = twin.make_window(3, Kcap, "cpu")
    w = twin.push(w, tracks, torch.eye(3), torch.zeros(3))
    gen2 = tracks.gen.clone()
    gen2[0] += 1                                   # slot 0 gets re-used
    tracks2 = tracks._replace(gen=gen2)
    w = twin.push(w, tracks2, torch.eye(3), torch.zeros(3))
    K_mat = np.array([[100.0, 0, 0], [0, 100.0, 0], [0, 0, 1]])
    prob, order = twin.gather_problem(w, tracks2, K_mat)
    m = N(prob.mask)
    first, second = m[-2], m[-1]                   # chronological: the two pushes last
    assert not first[0]
    assert m[:, 0].sum() == 0                      # one matching view: column masked
    assert first[1] and second[1]
    np.testing.assert_array_equal(N(order), [2, 0, 1])


def test_window_refine_improves_noisy_map():
    rng = np.random.default_rng(2)
    R, t, X, obs = _make_scene(rng, W=5, K=60, fx=200.0)
    fx = 200.0
    K_mat = T(np.array([[fx, 0, 0], [0, fx, 0], [0, 0, 1]], np.float32))
    w = twin.make_window(5, 60, "cpu")
    X_noisy = X + rng.normal(0, 0.08, X.shape).astype(np.float32)
    tracks = tst.make_track_table(60, "cpu")._replace(
        X=T(X_noisy), valid=torch.ones((60,), dtype=torch.bool))
    for i in range(5):
        w = twin.push(w, tracks._replace(P=T(obs[i] * fx)), T(R[i]), T(t[i]))
    _, tracks2, _, _, res = twin.refine_window(
        w, tracks._replace(P=T(obs[-1] * fx)), K_mat, iters=8, n_fix=2)
    err0 = np.abs(X_noisy - X).max()
    err1 = np.abs(N(tracks2.X) - X).max()
    assert float(res.cost) < float(res.cost0)
    assert err1 < 0.2 * err0


def test_refine_window_recovers_biased_landmarks():
    """Exact keyframe poses and a 1.5% depth bias on all landmarks: the refine pulls
    structure back to ground truth (median error to the cm level)."""
    rng = np.random.default_rng(0)
    Kt = T(np.array([[700.0, 0, 620], [0, 700.0, 188], [0, 0, 1]], np.float32))
    cap, W = 128, 10
    X_gt = rng.uniform([-10, -2, 8], [10, 1.6, 60], (cap, 3)).astype(np.float32)
    poses, yaw, pos = [], 0.0, np.zeros(3)
    for _ in range(W):
        yaw += np.deg2rad(10)
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pos = pos + R_wc[:, 2] * 1.75
        poses.append((R_wc.T.astype(np.float32), (-R_wc.T @ pos).astype(np.float32)))
    win = twin.make_window(W, cap, "cpu")
    tracks = tst.TrackTable(P=torch.zeros((cap, 2)), X=T(X_gt),
                            valid=torch.ones(cap, dtype=torch.bool),
                            gen=torch.zeros(cap, dtype=torch.int32))
    for R, t in poses:
        uv, z = tgeo.project(Kt, T(R), T(t), T(X_gt))
        uv = uv + T(rng.normal(0, 0.3, (cap, 2)).astype(np.float32))
        win = twin.push(win, tracks._replace(P=uv, valid=z > 1), T(R), T(t))
    problem, _ = twin.gather_problem(win, tracks, Kt)
    sel = N(problem.mask).sum(0) >= 2
    assert sel.mean() > 0.9
    X_bad = X_gt * 0.985
    res = tschur.ba_solve(problem._replace(X=T(X_bad)), iters=8, n_fix=2, huber=2.0 / 700,
                          lam0=1e-4, fix_rows=torch.ones(W, dtype=torch.bool))
    err_before = np.linalg.norm(X_bad - X_gt, axis=1)
    err_after = np.linalg.norm(N(res.X) - X_gt, axis=1)
    assert np.median(err_before[sel]) > 0.3
    assert np.median(err_after[sel]) < 0.05, np.median(err_after[sel])


def test_partial_window_gauge_is_anchored():
    """With a partially-filled keyframe ring, refine_window must freeze REAL keyframes
    (not the empty leading slots): with exact observations nothing moves materially."""
    rng = np.random.default_rng(1)
    Kt = T(np.array([[700.0, 0, 620], [0, 700.0, 188], [0, 0, 1]], np.float32))
    cap, W = 96, 10
    X_gt = rng.uniform([-8, -2, 6], [8, 1.6, 40], (cap, 3)).astype(np.float32)
    win = twin.make_window(W, cap, "cpu")
    tracks = tst.TrackTable(P=torch.zeros((cap, 2)), X=T(X_gt),
                            valid=torch.ones(cap, dtype=torch.bool),
                            gen=torch.zeros(cap, dtype=torch.int32))
    pos = np.zeros(3)
    t_last = None
    for _ in range(3):                              # only 3 of 10 ring slots filled
        pos = pos + np.array([0.2, 0, 1.6])
        R = np.eye(3, dtype=np.float32)
        t = (-R @ pos).astype(np.float32)
        uv, z = tgeo.project(Kt, T(R), T(t), T(X_gt))
        win = twin.push(win, tracks._replace(P=uv, valid=z > 1), T(R), T(t))
        t_last = t
    _, tracks2, _, t2, _ = twin.refine_window(win, tracks, Kt, iters=5, n_fix=2,
                                              huber=2.0 / 700, lam0=1e-4)
    assert float(np.max(np.abs(N(tracks2.X) - X_gt))) < 0.05
    assert float(np.linalg.norm(N(t2) - t_last)) < 0.02


def test_refine_window_gauge_newest_freezes_live_pose():
    """gauge='newest': the newest keyframe pose comes back IDENTICAL (no live-pose
    jump), older poses are free to move, and the refine still reduces the cost."""
    rng = np.random.default_rng(3)
    Kt = T(K_MAT)
    cap, W = 96, 6
    X_gt = rng.uniform([-4, -2, 6], [4, 2, 14], (cap, 3)).astype(np.float32)
    tracks = tst.make_track_table(cap, "cpu")._replace(
        X=T(X_gt), valid=torch.ones(cap, dtype=torch.bool))
    poses = []
    for w in range(W):
        tw = np.array([-0.4 * w, 0, 0], np.float32)
        if w < W - 2:                               # perturb the OLDER poses
            tw = tw + rng.normal(0, 0.05, 3).astype(np.float32)
        poses.append((np.eye(3, dtype=np.float32), tw))
    win = twin.make_window(W, cap, "cpu")
    for w in range(W):                              # exact observations, from the true poses
        tw_true = T(np.array([-0.4 * w, 0, 0], np.float32))
        uv, _ = tgeo.project(Kt, torch.eye(3), tw_true, T(X_gt))
        win = twin.push(win, tracks._replace(P=uv), T(poses[w][0]), T(poses[w][1]))
    win2, _, R_l, t_l, res = twin.refine_window(win, tracks, Kt, iters=6, n_fix=2,
                                                gauge="newest")
    np.testing.assert_array_equal(N(R_l), poses[-1][0])
    np.testing.assert_array_equal(N(t_l), poses[-1][1])
    assert float(res.cost) < float(res.cost0) * 0.2
    order = N(twin._chronological_order(win2))
    err_before = np.linalg.norm(poses[0][1])
    err_after = np.linalg.norm(N(win2.t)[order][0])
    assert err_after < err_before


# ---------------------------------------------------------------------------
# the geometry left "for BA", and Kabsch
# ---------------------------------------------------------------------------


def test_log_so3_matches_jax_and_inverts_rodrigues():
    rng = np.random.default_rng(0)
    rv = rng.normal(0, 0.6, (20, 3)).astype(np.float32)
    rv[0] = 0.0
    rv[1] = 1e-8
    R = np.asarray(jax.vmap(jgeo.rodrigues)(jnp.asarray(rv)))
    tl, jl = tgeo.log_so3(T(R)), jgeo.log_so3(jnp.asarray(R))
    np.testing.assert_allclose(N(tl), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(N(tl), rv, atol=2e-3)
    assert tgeo.log_so3(T(R[3])).shape == (3,)


def test_quat_to_rot_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 5, 4)).astype(np.float32)      # not unit: it normalizes
    tr, jr = tgeo.quat_to_rot(T(q)), jgeo.quat_to_rot(jnp.asarray(q))
    np.testing.assert_allclose(N(tr), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(N(tr @ tr.transpose(-1, -2)),
                               np.broadcast_to(np.eye(3), (4, 5, 3, 3)), atol=1e-5)


def test_essential_from_pose_matches_jax():
    rng = np.random.default_rng(2)
    R = _rodrigues(rng.normal(0, 0.3, 3)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    tE, jE = tgeo.essential_from_pose(T(R), T(t)), jgeo.essential_from_pose(
        jnp.asarray(R), jnp.asarray(t))
    np.testing.assert_allclose(N(tE), np.asarray(jE), atol=1e-6)
    x1 = rng.normal(size=(10, 3)).astype(np.float32) + np.array([0, 0, 8], np.float32)
    x2 = x1 @ R.T + t
    x1h, x2h = x1 / x1[:, 2:], x2 / x2[:, 2:]
    assert np.abs(np.einsum("ni,ij,nj->n", x2h, N(tE), x1h)).max() < 1e-5
    np.testing.assert_array_equal(N(tgeo.essential_from_pose(T(R), torch.zeros(3))), 0.0)


def test_kabsch_matches_jax():
    rng = np.random.default_rng(3)
    Pw = rng.normal(size=(12, 3, 3)).astype(np.float32)
    R = np.stack([_rodrigues(rng.normal(0, 0.5, 3)) for _ in range(12)]).astype(np.float32)
    t = rng.normal(size=(12, 3)).astype(np.float32)
    Pc = np.einsum("bij,bnj->bni", R, Pw) + t[:, None]
    tR, tt = tpnp._kabsch(T(Pc), T(Pw))
    jR, jt = jpnp._kabsch(jnp.asarray(Pc), jnp.asarray(Pw))
    np.testing.assert_allclose(N(tR), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(N(tt), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(N(tR), R, atol=1e-4)
    np.testing.assert_allclose(N(tt), t, atol=1e-4)

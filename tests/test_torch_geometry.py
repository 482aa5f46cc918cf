"""Geometry, state tables, RANSAC, PnP and the essential-matrix path: the port against
the JAX package on the same inputs. Random samples are the JAX package's
(``ops/ransac.py::sample_minimal_sets``), injected into the port; the port's own draw
from the same key is the same (``tests/test_torch_jax_random.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu import metrics as jmetrics
from lcvo_tpu.config import load_config as jload_config
from lcvo_tpu.core import geometry as jgeo
from lcvo_tpu.core import state as jst
from lcvo_tpu.ops import epipolar as jepi
from lcvo_tpu.ops import pnp as jpnp
from lcvo_tpu.ops import ransac as jransac
from lcvo_tpu_torch import metrics as tmetrics
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.core import geometry as tgeo
from lcvo_tpu_torch.core import state as tst
from lcvo_tpu_torch.ops import epipolar as tepi
from lcvo_tpu_torch.ops import pnp as tpnp
from lcvo_tpu_torch.ops import ransac as transac
from lcvo_tpu_torch.utils import jax_random

K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def J(a):
    return jnp.asarray(np.asarray(a, np.float32))


def close(t, j, tol):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=tol, atol=tol)


def _rot(rng, scale=0.3):
    return np.asarray(jgeo.rodrigues(J(rng.normal(size=3) * scale)))


# ---------------------------------------------------------------------------
# Geometry primitives: <= 1e-5
# ---------------------------------------------------------------------------

GEOMETRY_CASES = ["hat", "rodrigues", "rodrigues_zero", "se3_compose", "se3_inverse",
                  "se3_matrix", "se3_apply", "camera_center", "project", "backproject",
                  "normalize_points", "sampson_error", "triangulate_shared",
                  "triangulate_per_point", "bearing_angle_shared", "bearing_angle_per_point"]


@pytest.mark.parametrize("case", GEOMETRY_CASES)
def test_geometry_matches_jax(rng, case):
    N = 37
    R1, R2 = _rot(rng), _rot(rng)
    t1, t2 = rng.normal(size=3), rng.normal(size=3)
    X = rng.normal(size=(N, 3)) * [4, 2, 3] + [0, 0, 12]
    uv = rng.uniform([0, 0], [640, 480], size=(N, 2))
    tol = 1e-5
    if case == "hat":
        w = rng.normal(size=(N, 3))
        close(tgeo.hat(T(w)), jgeo.hat(J(w)), tol)
    elif case == "rodrigues":
        w = rng.normal(size=(N, 3))
        close(tgeo.rodrigues(T(w)), jgeo.rodrigues(J(w)), tol)
    elif case == "rodrigues_zero":
        w = np.zeros((2, 3))
        close(tgeo.rodrigues(T(w)), jgeo.rodrigues(J(w)), tol)
    elif case == "se3_compose":
        for a, b in zip(tgeo.se3_compose(T(R1), T(t1), T(R2), T(t2)),
                        jgeo.se3_compose(J(R1), J(t1), J(R2), J(t2))):
            close(a, b, tol)
    elif case == "se3_inverse":
        for a, b in zip(tgeo.se3_inverse(T(R1), T(t1)), jgeo.se3_inverse(J(R1), J(t1))):
            close(a, b, tol)
    elif case == "se3_matrix":
        close(tgeo.se3_matrix(T(R1), T(t1)), jgeo.se3_matrix(J(R1), J(t1)), tol)
    elif case == "se3_apply":
        close(tgeo.se3_apply(T(R1), T(t1), T(X)), jgeo.se3_apply(J(R1), J(t1), J(X)), tol)
    elif case == "camera_center":
        close(tgeo.camera_center(T(R1), T(t1)), jgeo.camera_center(J(R1), J(t1)), tol)
    elif case == "project":
        for a, b in zip(tgeo.project(T(K), T(R1), T(t1), T(X)),
                        jgeo.project(J(K), J(R1), J(t1), J(X))):
            close(a, b, tol)
    elif case == "backproject":
        close(tgeo.backproject(T(K), T(uv)), jgeo.backproject(J(K), J(uv)), tol)
    elif case == "normalize_points":
        close(tgeo.normalize_points(T(uv), T(K)), jgeo.normalize_points(J(uv), J(K)), tol)
    elif case == "sampson_error":
        E = rng.normal(size=(5, 3, 3))
        h1 = np.concatenate([rng.normal(size=(N, 2)), np.ones((N, 1))], 1)
        h2 = np.concatenate([rng.normal(size=(N, 2)), np.ones((N, 1))], 1)
        close(tgeo.sampson_error(T(E), T(h1), T(h2)), jgeo.sampson_error(J(E), J(h1), J(h2)), tol)
    elif case.startswith("triangulate"):
        x1 = np.asarray(jgeo.normalize_points(jgeo.project(J(K), J(R1), J(t1), J(X))[0], J(K)))
        x2 = np.asarray(jgeo.normalize_points(jgeo.project(J(K), J(R2), J(t2), J(X))[0], J(K)))
        if case == "triangulate_shared":
            a1, b1 = R1, t1
        else:
            a1, b1 = np.broadcast_to(R1, (N, 3, 3)), np.broadcast_to(t1, (N, 3))
        got = tgeo.triangulate_linear(T(a1), T(b1), T(R2), T(t2), T(x1), T(x2))
        ref = jgeo.triangulate_linear(J(a1), J(b1), J(R2), J(t2), J(x1), J(x2))
        # relative to the point scale (depths ~12 m)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5 * 12)
        np.testing.assert_allclose(got.numpy(), X, atol=1e-2)
    elif case.startswith("bearing_angle"):
        uv2 = rng.uniform([0, 0], [640, 480], size=(N, 2))
        if case == "bearing_angle_shared":
            a1, b1 = R1, t1
        else:
            a1 = np.stack([_rot(rng) for _ in range(N)])
            b1 = rng.normal(size=(N, 3))
        close(tgeo.bearing_angle(T(a1), T(b1), T(R2), T(t2), T(uv), T(uv2), T(K)),
              jgeo.bearing_angle(J(a1), J(b1), J(R2), J(t2), J(uv), J(uv2), J(K)), tol)


# ---------------------------------------------------------------------------
# State tables: slot order exact
# ---------------------------------------------------------------------------


def _tables_equal(t_table, j_table):
    for f in j_table._fields:
        a, b = getattr(t_table, f), getattr(j_table, f)
        if b is None:
            assert a is None, f
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("cap,n_new", [(16, 5), (16, 20), (9, 9)])
def test_insert_into_tracks_slot_order_after_prune(rng, cap, n_new):
    """Insert, prune a scattered subset, insert again (with anchors, with overflow):
    every field of the port's table equals the JAX package's, slot for slot."""
    jt, tt = jst.make_track_table(cap), tst.make_track_table(cap, "cpu")
    for step in range(3):
        P = rng.uniform(0, 100, size=(n_new, 2)).astype(np.float32)
        X = rng.normal(size=(n_new, 3)).astype(np.float32)
        v = rng.random(n_new) > 0.3
        if step == 1:
            F = rng.uniform(0, 100, size=(n_new, 2)).astype(np.float32)
            Rf = np.stack([_rot(rng) for _ in range(n_new)]).astype(np.float32)
            tf = rng.normal(size=(n_new, 3)).astype(np.float32)
            ang = rng.uniform(0, 0.1, size=n_new).astype(np.float32)
            jt = jst.insert_into_tracks(jt, J(P), J(X), jnp.asarray(v), F_new=J(F),
                                        R_f_new=J(Rf), t_f_new=J(tf), ang_new=J(ang))
            tt = tst.insert_into_tracks(tt, T(P), T(X), torch.from_numpy(v), F_new=T(F),
                                        R_f_new=T(Rf), t_f_new=T(tf), ang_new=T(ang))
        elif step == 2:
            Rf, tf = _rot(rng).astype(np.float32), rng.normal(size=3).astype(np.float32)
            jt = jst.insert_into_tracks(jt, J(P), J(X), jnp.asarray(v), F_new=J(P),
                                        R_f_new=J(Rf), t_f_new=J(tf), ang_new=J(P[:, 0]))
            tt = tst.insert_into_tracks(tt, T(P), T(X), torch.from_numpy(v), F_new=T(P),
                                        R_f_new=T(Rf), t_f_new=T(tf), ang_new=T(P[:, 0]))
        else:
            jt = jst.insert_into_tracks(jt, J(P), J(X), jnp.asarray(v))
            tt = tst.insert_into_tracks(tt, T(P), T(X), torch.from_numpy(v))
        _tables_equal(tt, jt)
        keep = rng.random(cap) > 0.4
        jt = jst.prune_tracks(jt, jnp.asarray(keep))
        tt = tst.prune_tracks(tt, torch.from_numpy(keep))
        _tables_equal(tt, jt)


@pytest.mark.parametrize("cap,n_new", [(16, 6), (12, 30)])
def test_insert_into_candidates_slot_order_after_prune(rng, cap, n_new):
    jc, tc = jst.make_candidate_table(cap), tst.make_candidate_table(cap, "cpu")
    for _ in range(3):
        C = rng.uniform(0, 100, size=(n_new, 2)).astype(np.float32)
        v = rng.random(n_new) > 0.25
        R, t = _rot(rng).astype(np.float32), rng.normal(size=3).astype(np.float32)
        jc = jst.insert_into_candidates(jc, J(C), J(R), J(t), jnp.asarray(v))
        tc = tst.insert_into_candidates(tc, T(C), T(R), T(t), torch.from_numpy(v))
        _tables_equal(tc, jc)
        keep = rng.random(cap) > 0.5
        jc = jst.prune_candidates(jc, jnp.asarray(keep))
        tc = tst.prune_candidates(tc, torch.from_numpy(keep))
        _tables_equal(tc, jc)


def test_free_slots_stable_order():
    valid = np.array([True, False, True, False, False, True, False, True])
    got = tst.free_slots(torch.from_numpy(valid), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jst.free_slots(jnp.asarray(valid), 6)))
    assert got.tolist() == [1, 3, 4, 6, 0, 2]


@pytest.mark.parametrize("H,W", [(376, 1240), (127, 333)])
def test_make_vo_state_and_state_from_numpy(rng, H, W):
    """Pyramid dims are repeated ceil halvings; a JAX state carried across with
    state_from_numpy equals it field for field."""
    over = {"image_width": W, "image_height": H,
            "state": {"max_tracks": 32, "max_candidates": 24}}
    jcfg, tcfg = jload_config(overrides=over), load_config(overrides=over)
    js = jst.make_vo_state(jcfg, (H, W))
    ts = tst.make_vo_state(tcfg, (H, W), "cpu")
    assert [tuple(p.shape) for p in ts.prev_pyramid] == [tuple(p.shape) for p in js.prev_pyramid]
    P = rng.uniform(0, 100, size=(20, 2)).astype(np.float32)
    js = js._replace(tracks=jst.insert_into_tracks(js.tracks, J(P), J(rng.normal(size=(20, 3))),
                                                   jnp.asarray(rng.random(20) > 0.5)),
                     health=jnp.asarray(3, jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, js)
    ts = tst.state_from_numpy(tree, device="cpu")
    _tables_equal(ts.tracks, js.tracks)
    _tables_equal(ts.cands, js.cands)
    for f in ("R", "t", "frame_idx", "prev_image", "health", "prev_R", "prev_t"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    assert ts.prev_desc is None and ts.health.dtype == torch.int32
    # the dict form of the same tree
    as_dict = {f: getattr(tree, f) for f in tree._fields}
    as_dict["tracks"] = tree.tracks._asdict()
    as_dict["prev_pyramid"] = {str(i): p for i, p in enumerate(tree.prev_pyramid)}
    ts2 = tst.state_from_numpy(as_dict, device="cpu")
    _tables_equal(ts2.tracks, js.tracks)
    assert len(ts2.prev_pyramid) == len(js.prev_pyramid)


# ---------------------------------------------------------------------------
# RANSAC machinery, PnP, essential matrix
# ---------------------------------------------------------------------------


def test_sample_minimal_sets_draws_only_valid_points():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 21, 40]] = True
    u = torch.from_numpy(jax_random.uniform(jax_random.PRNGKey(0), (64, 3)))
    idx = transac.sample_minimal_sets(u, 50, valid)
    assert idx.shape == (64, 3)
    assert set(idx.flatten().tolist()) <= {3, 17, 21, 40}


def test_msac_score_and_best_match_jax(rng):
    err = rng.exponential(1e-5, size=(40, 60)).astype(np.float32)
    valid = rng.random(60) > 0.2
    js, jc = jransac.msac_score(J(err), jnp.asarray(valid), 1.6e-5)
    ts, tc = transac.msac_score(T(err), torch.from_numpy(valid), 1.6e-5)
    close(ts, js, 1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(transac.best_hypothesis(ts)) == int(jransac.best_hypothesis(js))


@pytest.mark.parametrize("coeffs", [[1.0, -10.0, 35.0, -50.0, 24.0], [1.0, 3.0, -9.0, 3.0, -10.0],
                                    [2.5, -1.0, 0.3, 4.0, -2.0]])
def test_quartic_roots_match_jax(coeffs):
    """Durand-Kerner in complex64, 40 iterations: roots agree to 1e-4 (sorted)."""
    c = np.array([coeffs], np.float32)
    j = np.sort_complex(np.asarray(jpnp.quartic_roots(J(c)))[0])
    t = np.sort_complex(tpnp.quartic_roots(T(c)).numpy()[0])
    np.testing.assert_allclose(t, j, atol=1e-4)


def _pnp_scene(rng, N, noise=0.0, outlier_frac=0.0):
    X = rng.normal(size=(N, 3)) * np.array([5, 3, 4]) + np.array([0, 0, 15.0])
    R = _rot(rng, 0.1)
    t = rng.normal(size=3) * np.array([1, 0.3, 0.5])
    uv, _ = jgeo.project(J(K), J(R), J(t), J(X))
    uv = np.asarray(uv) + rng.normal(size=(N, 2)) * noise
    n_out = int(N * outlier_frac)
    if n_out:
        uv[:n_out] += rng.uniform(15, 60, size=(n_out, 2)) * rng.choice([-1, 1], size=(n_out, 2))
    x_obs = (uv - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    return X.astype(np.float32), R, t, x_obs.astype(np.float32)


def test_p3p_matches_jax(rng):
    """All four root hypotheses of 16 samples. P3P in f32 with Durand-Kerner in
    complex64 is ill-conditioned near double roots on both sides (the root nearest the
    truth lies up to ~0.1 from it), so hypotheses are compared statistically: validity
    agrees on >= 95%, the median difference of valid pairs is <= 1e-4, and the port's
    root nearest each sample's truth is, at the median, no further from the truth than
    twice the JAX package's (+1e-4). pnp_ransac below, after scoring and polish, holds
    the pose to 1e-4."""
    n = 16
    Pw = np.stack([_pnp_scene(rng, 3)[0] for _ in range(n)])
    f = np.zeros((n, 3, 3))
    truth = []
    for i in range(n):
        R, t = _rot(rng, 0.1), rng.normal(size=3) * 0.5
        truth.append((R, t))
        Xc = Pw[i] @ R.T + t
        f[i] = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
    jR, jt, jok = map(np.asarray, jpnp.p3p_grunert(J(Pw), J(f)))
    tR, tt, tok = (a.numpy() for a in tpnp.p3p_grunert(T(Pw), T(f)))
    assert np.mean(tok == jok) >= 0.95 and jok.any()
    both = jok & tok
    assert np.median(np.abs(tR[both] - jR[both]).max(axis=(-1, -2))) <= 1e-4

    def nearest(Rs, ts, ok, i):
        R, t = truth[i]
        return min(np.abs(Rs[i, k] - R).max() + np.abs(ts[i, k] - t).max()
                   for k in range(4) if ok[i, k])

    live = [i for i in range(n) if jok[i].any() and tok[i].any()]
    ej = np.median([nearest(jR, jt, jok, i) for i in live])
    et = np.median([nearest(tR, tt, tok, i) for i in live])
    assert et <= 2 * ej + 1e-4


def test_gauss_newton_pose_matches_jax(rng):
    X, R, t, x_obs = _pnp_scene(rng, 60)
    R0 = np.asarray(jgeo.rodrigues(J(rng.normal(size=3) * 0.03))) @ R
    t0 = t + rng.normal(size=3) * 0.2
    w = (rng.random(60) > 0.1).astype(np.float32)
    jR, jt = jpnp.gauss_newton_pose(J(R0), J(t0), J(X), J(x_obs), J(w), iters=8)
    tR, tt = tpnp.gauss_newton_pose(T(R0), T(t0), T(X), T(x_obs), T(w), iters=8)
    close(tR, jR, 1e-4)
    close(tt, jt, 1e-4)


@pytest.mark.parametrize("noise,outliers,seed", [(0.2, 0.0, 0), (0.3, 0.2, 1), (0.5, 0.3, 2)])
def test_pnp_ransac_with_jax_samples(rng, noise, outliers, seed):
    """JAX's minimal sets injected: R and t <= 1e-4; inlier masks equal except on
    <= 1% borderline points."""
    N, n_hyp = 120, 256
    X, R, t, x_obs = _pnp_scene(rng, N, noise, outliers)
    valid = rng.random(N) > 0.05
    key = jax.random.PRNGKey(seed)
    thresh = 2.0 / 500.0
    jR, jt, jinl, jn = jpnp.pnp_ransac(key, J(X), J(x_obs), jnp.asarray(valid), thresh=thresh,
                                       n_hyp=n_hyp)
    idx = np.asarray(jransac.sample_minimal_sets(key, N, jnp.asarray(valid), n_hyp, 3))
    tR, tt, tinl, tn = tpnp.pnp_ransac(None, T(X), T(x_obs), torch.from_numpy(valid),
                                       thresh=thresh, n_hyp=n_hyp,
                                       idx=torch.from_numpy(idx).long())
    close(tR, jR, 1e-4)
    close(tt, jt, 1e-4)
    assert np.mean(tinl.numpy() != np.asarray(jinl)) <= 0.01
    assert abs(int(tn) - int(jn)) <= max(1, int(0.01 * N))


def _two_view_scene(rng, N, noise, outlier_frac):
    X = rng.normal(size=(N, 3)) * np.array([5, 3, 4]) + np.array([0, 0, 15.0])
    R = np.asarray(jgeo.rodrigues(J([0.02, 0.04, 0.01])))
    t = np.array([1.0, 0.0, 0.2])
    uv1, _ = jgeo.project(J(K), jnp.eye(3), jnp.zeros(3), J(X))
    uv2, _ = jgeo.project(J(K), J(R), J(t), J(X))
    uv1 = np.asarray(uv1) + rng.normal(size=(N, 2)) * noise
    uv2 = np.asarray(uv2) + rng.normal(size=(N, 2)) * noise
    n_out = int(N * outlier_frac)
    if n_out:
        uv2[:n_out] += rng.uniform(20, 80, size=(n_out, 2)) * rng.choice([-1, 1], size=(n_out, 2))
    x1 = np.asarray(jgeo.normalize_points(J(uv1), J(K)))
    x2 = np.asarray(jgeo.normalize_points(J(uv2), J(K)))
    return x1, x2, R, t


@pytest.mark.parametrize("noise,outliers,seed", [(0.3, 0.2, 0), (0.2, 0.1, 1), (0.3, 0.25, 4)])
def test_essential_ransac_recover_pose_with_jax_samples(rng, noise, outliers, seed):
    """JAX's minimal sets injected; the selected pose after recover_pose agrees to
    <= 1e-4 (SVD sign conventions differ, so E and the decomposition index are not
    compared); inlier masks equal except on <= 1% borderline points.

    The cases are well-posed ones, where the JAX package itself finds the true pose.
    With heavy outliers (35% at 256 hypotheses) few samples are all-inlier, and the
    minimal-set E is the ill-conditioned 8th singular vector (quirk 2), so LAPACK
    rounding can change which hypothesis wins on either side (ROADMAP §C)."""
    N, n_hyp = 250, 256
    x1, x2, R, t = _two_view_scene(rng, N, noise, outliers)
    valid = np.ones(N, bool)
    key = jax.random.PRNGKey(seed)
    thresh = 1.5 / 500.0
    jE, jinl, jn = jepi.essential_ransac(key, J(x1), J(x2), jnp.asarray(valid), thresh=thresh,
                                         n_hyp=n_hyp)
    jR, jt, _ = jepi.recover_pose(jE, J(x1), J(x2), jinl)
    idx = np.asarray(jransac.sample_minimal_sets(key, N, jnp.asarray(valid), n_hyp, 8))
    tE, tinl, tn = tepi.essential_ransac(None, T(x1), T(x2), torch.from_numpy(valid),
                                         thresh=thresh, n_hyp=n_hyp,
                                         idx=torch.from_numpy(idx).long())
    tR, tt, _ = tepi.recover_pose(tE, T(x1), T(x2), tinl)
    close(tR, jR, 1e-4)
    close(tt, jt, 1e-4)
    assert np.mean(tinl.numpy() != np.asarray(jinl)) <= 0.01
    # and the pose is the true one (rotation within 0.5 degree)
    dR = tR.numpy() @ R.T
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 0.5


def test_recover_pose_and_refine_match_jax(rng):
    x1, x2, R, t = _two_view_scene(rng, 120, 0.3, 0.0)
    E = jgeo.essential_from_pose(J(R), J(t))
    valid = np.ones(120, bool)
    jR, jt, jn = jepi.recover_pose(E, J(x1), J(x2), jnp.asarray(valid))
    tR, tt, tn = tepi.recover_pose(T(np.asarray(E)), T(x1), T(x2), torch.from_numpy(valid))
    close(tR, jR, 1e-5)
    close(tt, jt, 1e-5)
    assert int(tn) == int(jn)
    w = np.ones(120, np.float32)
    jR2, jt2 = jepi.refine_pose_sampson(jR, jt, J(x1), J(x2), J(w))
    tR2, tt2 = tepi.refine_pose_sampson(tR, tt, T(x1), T(x2), T(w))
    close(tR2, jR2, 1e-4)
    close(tt2, jt2, 1e-4)


def test_quirk2_eight_point_minimal_set_is_not_the_null_vector(rng):
    """ROADMAP §C quirk 2: the thin SVD of an (8, 9) system has an (8, 9) Vh, so its
    last row is the 8th right singular vector, not the null vector. The port keeps
    it: on a noise-free minimal set its epipolar residual is orders of magnitude
    above the true E's, and it agrees with the JAX package's up to sign."""
    x1, x2, R, t = _two_view_scene(rng, 8, 0.0, 0.0)
    je = np.asarray(jepi.eight_point(J(x1), J(x2))).ravel()
    te = tepi.eight_point(T(x1), T(x2)).numpy().ravel()
    assert abs(np.dot(je, te)) >= 1 - 1e-4
    h1 = np.concatenate([x1, np.ones((8, 1))], 1)
    h2 = np.concatenate([x2, np.ones((8, 1))], 1)

    def resid(E):
        E = E.reshape(3, 3) / np.linalg.norm(E)
        return np.mean(np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)))

    E_true = np.asarray(jgeo.essential_from_pose(J(R), J(t)))
    assert resid(te) > 100 * resid(E_true)
    # the full SVD's last row is the null vector
    A = (h2[:, :, None] * h1[:, None, :]).reshape(8, 9)
    null = np.linalg.svd(A, full_matrices=True)[2][-1]
    assert resid(null) < resid(te) / 100


def test_ate_rmse_matches_jax(rng):
    gt = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    est = 0.3 * gt @ _rot(rng).T + 2.0 + rng.normal(size=(40, 3)) * 0.05
    assert abs(tmetrics.ate_rmse(est, gt) - jmetrics.ate_rmse(est, gt)) <= 1e-12

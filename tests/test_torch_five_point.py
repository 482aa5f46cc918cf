"""The port's Nistér five-point solver against the JAX package on the same inputs, on
the CPU.

Stated tolerances: degree-10 roots as sets <= 1e-3; the valid essential matrices of a
sample pair up between the packages <= 1e-3 (Frobenius, up to sign) as often as the
JAX package's pair up with its own for the same points in another order (>= 70% over
200 scenes), and the packages' accuracy statistics agree (share of
inaccurate solutions within 0.03, share of scenes whose true E is found within 0.05);
each scene's best epipolar residual as small as ``tests/test_five_point.py`` demands
(< 1e-3 in 10 of 12); ``essential_ransac(solver="five_point")`` + ``recover_pose``
with the JAX package's samples injected: R, t <= 1e-3. The null-space basis of the 5x9
system is not unique between SVD implementations, so E solutions are compared, never
the basis; and since the degree-10 coefficients inherit that difference in their last
f32 digits, solutions near a double root differ or drop out on either side, which is
why the set comparison is a share and not every solution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.ops import epipolar as jepi
from lcvo_tpu.ops import five_point as jfp
from lcvo_tpu.ops import ransac as jransac
from lcvo_tpu_torch.ops import epipolar as tepi
from lcvo_tpu_torch.ops import five_point as tfp
from lcvo_tpu_torch.utils import jax_random


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine and slows these tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def scene(seed, n=40, noise=0.0, rot_scale=0.15):
    """Two views of n random points (the scene of tests/test_five_point.py)."""
    rng = np.random.default_rng(seed)
    rv = rng.normal(size=3) * rot_scale
    th = np.linalg.norm(rv)
    Kx = _hat(rv / max(th, 1e-12))
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n, 3))
    x1 = X[:, :2] / X[:, 2:]
    Xc2 = X @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:]
    if noise:
        x1 = x1 + rng.normal(size=x1.shape) * noise
        x2 = x2 + rng.normal(size=x2.shape) * noise
    return x1.astype(np.float32), x2.astype(np.float32), R, t


def _sign_dist(E, F):
    return min(np.linalg.norm(E - F), np.linalg.norm(E + F))


# ---------------------------------------------------------------------------
# Constants and the polynomial machinery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["_M11", "_M21", "_C44", "_C45", "_C54", "_C48", "_C57"])
def test_multiplication_tensors_match_jax(name):
    np.testing.assert_array_equal(getattr(tfp, name), np.asarray(getattr(jfp, name)))


def test_constraint_matrix_matches_jax(rng):
    Ec = rng.normal(size=(7, 3, 3, 4)).astype(np.float32)
    j = np.asarray(jfp._constraint_matrix(jnp.asarray(Ec)))
    t = tfp._constraint_matrix(T(Ec)).numpy()
    assert t.shape == (7, 10, 20)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_constraint_matrix_vanishes_on_an_essential_matrix():
    """With E1..E3 = 0 and E4 a true essential matrix, the monomial vector at
    x = y = z = 0 is e_20, so the last column (the constant terms) must vanish."""
    _, _, R, t = scene(2)
    E = _hat(t) @ R
    E /= np.linalg.norm(E)
    Ec = np.zeros((3, 3, 4), np.float32)
    Ec[..., 3] = E
    C = tfp._constraint_matrix(T(Ec)).numpy()
    assert np.abs(C[:, -1]).max() < 1e-6
    assert np.abs(C[:, :-1]).max() == 0.0


ROOT_CASES = {
    "real_separated": [-4.0, -3.0, -2.0, -1.0, -0.4, 0.6, 1.2, 2.2, 3.2, 4.2],
    "complex_pairs": [1 + 2j, 1 - 2j, -3 + 1j, -3 - 1j, 0.5, -0.2, 3.0, 0.3 + 0.7j, 0.3 - 0.7j, -1.5],
    "small": [0.01, -0.03, 0.05, 0.1, -0.12, 0.2, -0.25, 0.3, 0.02 + 0.04j, 0.02 - 0.04j],
}


@pytest.mark.parametrize("case", sorted(ROOT_CASES))
def test_poly_roots_deg10_match_jax(case):
    """Roots as sets: each root of one side has one of the other within 1e-3, and both
    are the true roots within the f32 accuracy tests/test_five_point.py asks (5e-2)."""
    gt = np.array(ROOT_CASES[case])
    c = np.real(np.poly(gt)).astype(np.float32)
    j = np.asarray(jfp.poly_roots_deg10(jnp.asarray(c)))
    t = tfp.poly_roots_deg10(T(c)).numpy()
    assert t.shape == (10,) and t.dtype == np.complex64
    d = np.abs(j[:, None] - t[None, :])
    assert d.min(1).max() <= 1e-3 and d.min(0).max() <= 1e-3
    assert np.abs(t[:, None] - gt[None, :]).min(0).max() <= 5e-2


def test_poly_roots_batched_and_scaled_no_overflow():
    """A tiny leading coefficient gives huge roots; the Fujiwara rescale keeps f32
    finite. Batched over two leading dims."""
    c = np.poly([120.0, -55.0, 3.0, 0.5, -0.2, 1 + 2j, 1 - 2j, -3 + 1j, -3 - 1j, 7.0])
    c = (np.real(c) * 1e-6).astype(np.float32)
    batch = np.stack([c, np.real(np.poly(ROOT_CASES["real_separated"])).astype(np.float32)])
    batch = np.stack([batch, batch[::-1]])
    roots = tfp.poly_roots_deg10(T(batch)).numpy()
    assert roots.shape == (2, 2, 10) and np.all(np.isfinite(roots))
    np.testing.assert_allclose(np.sort_complex(roots[0, 0]), np.sort_complex(roots[1, 1]),
                               atol=1e-5)
    r = roots[0, 0]
    real = r[np.abs(r.imag) < 1e-2 * (1 + np.abs(r.real))].real
    assert np.any(np.abs(real - 120.0) < 0.5) and np.any(np.abs(real + 55.0) < 0.5)
    j = np.asarray(jfp.poly_roots_deg10(jnp.asarray(c)))
    d = np.abs(j[:, None] - r[None, :]) / (1 + np.abs(j[:, None]))
    assert d.min(1).max() <= 1e-3


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


N_SCENES = 200


@pytest.fixture(scope="module")
def solved():
    """200 exact scenes (seeds 0..199), the first five correspondences of each solved
    by both packages in one batched call. Returns numpy arrays."""
    scenes = [scene(seed) for seed in range(N_SCENES)]
    X1 = np.stack([sc[0][:5] for sc in scenes])
    X2 = np.stack([sc[1][:5] for sc in scenes])
    E_true = np.stack([_hat(sc[3]) @ sc[2] for sc in scenes])
    E_true /= np.linalg.norm(E_true, axis=(1, 2), keepdims=True)
    jE, jv = jfp.five_point(jnp.asarray(X1), jnp.asarray(X2))
    tE, tv = tfp.five_point(T(X1), T(X2))
    # the JAX package once more with the five points in another order: the same
    # problem, other rounding
    perm = [3, 1, 4, 0, 2]
    pE, pv = jfp.five_point(jnp.asarray(X1[:, perm]), jnp.asarray(X2[:, perm]))
    return dict(scenes=scenes, X1=X1, X2=X2, E_true=E_true, jE=np.asarray(jE),
                jv=np.asarray(jv), tE=tE.numpy(), tv=tv.numpy(), pE=np.asarray(pE),
                pv=np.asarray(pv))


def _constraint_residual(E, X1, X2):
    """(B, 10) how far each E is from a solution: the largest of the epipolar residual
    on its five points, |det E| and |2 E Et E - tr(E Et) E|, in f64."""
    E = E.astype(np.float64)
    h1 = np.concatenate([X1, np.ones(X1.shape[:-1] + (1,))], -1)
    h2 = np.concatenate([X2, np.ones(X2.shape[:-1] + (1,))], -1)
    epi = np.abs(np.einsum("bni,bkij,bnj->bkn", h2, E, h1)).max(-1)
    Et = np.swapaxes(E, -1, -2)
    tr = np.trace(E @ Et, axis1=-2, axis2=-1)[..., None, None]
    cub = np.abs(2 * E @ Et @ E - tr * E).max((-1, -2))
    return np.maximum(epi, np.maximum(np.abs(np.linalg.det(E)), cub))


def _nearest(E, cands):
    return min((_sign_dist(E, F) for F in cands), default=np.inf)


def _paired_share(aE, av, bE, bv, tol=1e-3):
    """Share of a's valid solutions with a partner among b's within tol."""
    d = [_nearest(E, bE[i][bv[i]]) for i in range(len(aE)) for E in aE[i][av[i]]]
    return float(np.mean(np.array(d) <= tol)), len(d)


def test_five_point_solution_sets_match_jax(solved):
    """Valid solutions pair up between the packages within 1e-3 (Frobenius, up to sign)
    as often as the JAX package's own solutions pair up with its solutions for the same
    five points given in another order (less 0.03), and on >= 70%. It is not 100% on
    either count: a reordering, like another SVD's null-space basis, changes the
    degree-10 coefficients in their last f32 digits, and a root near a double root then
    moves, or falls just short of real and drops its solution."""
    s = solved
    assert s["tE"].shape == (N_SCENES, 10, 3, 3) and s["tv"].shape == (N_SCENES, 10)
    np.testing.assert_allclose(np.linalg.norm(s["tE"][s["tv"]].reshape(-1, 9), axis=1), 1.0,
                               atol=1e-5)
    j_to_t, n = _paired_share(s["jE"], s["jv"], s["tE"], s["tv"])
    t_to_j, _ = _paired_share(s["tE"], s["tv"], s["jE"], s["jv"])
    j_to_own, _ = _paired_share(s["jE"], s["jv"], s["pE"], s["pv"])
    assert n > 4 * N_SCENES
    assert min(j_to_t, t_to_j) >= max(j_to_own - 0.03, 0.7), (j_to_t, t_to_j, j_to_own)


def test_five_point_accuracy_statistics_match_jax(solved):
    """The port is as accurate as the JAX package, over 200 scenes: the count of valid
    solutions within 3%, the share of valid solutions that miss the defining
    constraints by more than 1e-3 within 0.03, and the share of scenes whose true E is
    among the solutions (<= 1e-3) within 0.05."""
    s = solved
    stats = {}
    for name, E, v in (("jax", s["jE"], s["jv"]), ("torch", s["tE"], s["tv"])):
        r = _constraint_residual(E, s["X1"], s["X2"])[v]
        found = np.mean([_nearest(s["E_true"][b], E[b][v[b]]) <= 1e-3 for b in range(N_SCENES)])
        stats[name] = (int(v.sum()), float(np.mean(r > 1e-3)), float(found))
    (jn, jbad, jfound), (tn, tbad, tfound) = stats["jax"], stats["torch"]
    assert abs(tn - jn) <= 0.03 * jn, stats
    assert abs(tbad - jbad) <= 0.03 and tbad <= 0.12, stats
    assert abs(tfound - jfound) <= 0.05 and tfound >= 0.8, stats


def test_five_point_recovers_the_true_solution(solved):
    """The bar of tests/test_five_point.py::test_five_point_exact_solutions, on its
    scenes (seeds 0..11): in at least 10 of 12 some returned E has an epipolar residual
    < 1e-3 on all 40 correspondences, the 35 held-out ones included."""
    hits = 0
    for b in range(12):
        x1, x2 = solved["scenes"][b][:2]
        h1 = np.concatenate([x1, np.ones((len(x1), 1), np.float32)], 1)
        h2 = np.concatenate([x2, np.ones((len(x2), 1), np.float32)], 1)
        best = min(np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)).max()
                   for E in solved["tE"][b][solved["tv"][b]])
        hits += best < 1e-3
    assert hits >= 10, f"the port's five-point recovered the true E in only {hits}/12 scenes"


def _same_solutions(E, valid, E_ref, valid_ref):
    """Batched and single calls take other LAPACK paths, which moves an ill-conditioned
    solution by up to ~1e-4: same valid slots, E within 2e-3."""
    assert bool((valid == valid_ref).all())
    torch.testing.assert_close(E[valid], E_ref[valid_ref], atol=2e-3, rtol=0)


def test_five_point_batched_shapes():
    x1, x2, *_ = scene(3)
    b1 = T(np.stack([x1[:5], x1[5:10], x1[10:15]]).reshape(1, 3, 5, 2))
    b2 = T(np.stack([x2[:5], x2[5:10], x2[10:15]]).reshape(1, 3, 5, 2))
    E, valid = tfp.five_point(b1, b2)
    assert E.shape == (1, 3, 10, 3, 3) and valid.shape == (1, 3, 10)
    assert valid.dtype == torch.bool and E.dtype == torch.float32
    _same_solutions(E[0, 1], valid[0, 1], *tfp.five_point(b1[0, 1], b2[0, 1]))


@pytest.mark.parametrize("kind", ["repeated_point", "all_same_point", "zeros"])
def test_five_point_degenerate_sample_is_masked(kind):
    """A degenerate minimal set raises nothing, and no slot that claims to be valid
    holds a NaN or an infinity."""
    x1, x2, R, t = scene(0)
    a, b = x1[:5].copy(), x2[:5].copy()
    if kind == "repeated_point":
        a[1], b[1] = a[0], b[0]
    elif kind == "all_same_point":
        a[:], b[:] = a[0], b[0]
    else:
        a[:], b[:] = 0.0, 0.0
    x1, x2, R, t = scene(3)
    E, valid = tfp.five_point(T(np.stack([a, x1[:5]])), T(np.stack([b, x2[:5]])))
    assert E.shape == (2, 10, 3, 3)
    assert bool(torch.isfinite(E[valid]).all())
    # the well-posed sample beside it (scene 3) still yields its true E
    E_true = _hat(t) @ R
    E_true /= np.linalg.norm(E_true)
    assert _nearest(E_true, E[1][valid[1]].numpy()) <= 1e-3


# ---------------------------------------------------------------------------
# RANSAC with the five-point solver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("outlier_frac,seed", [(0.0, 0), (0.3, 0), (0.2, 3)])
def test_five_point_ransac_pose_with_jax_samples(outlier_frac, seed):
    """essential_ransac(solver='five_point') with the JAX package's minimal sets, then
    recover_pose: R, t <= 1e-3 between the packages, and the pose is the true one
    (the bars of tests/test_five_point.py::test_five_point_ransac_pose)."""
    x1, x2, R_gt, t_gt = scene(7, n=120, noise=5e-4)
    rng = np.random.default_rng(1)
    n_out = int(len(x1) * outlier_frac)
    if n_out:
        x2[:n_out] = rng.uniform(-0.5, 0.5, size=(n_out, 2)).astype(np.float32)
    valid = np.ones(len(x1), bool)
    key = jax.random.PRNGKey(seed)
    n_hyp = 512
    jE, jinl, jn = jepi.essential_ransac(key, jnp.asarray(x1), jnp.asarray(x2),
                                         jnp.asarray(valid), thresh=2e-3, n_hyp=n_hyp,
                                         solver="five_point")
    jR, jt, _ = jepi.recover_pose(jE, jnp.asarray(x1), jnp.asarray(x2), jinl)
    idx = np.asarray(jransac.sample_minimal_sets(key, len(x1), jnp.asarray(valid),
                                                 n_hyp // 10, 5))
    assert idx.shape == (51, 5)
    tE, tinl, tn = tepi.essential_ransac(None, T(x1), T(x2), T(valid), thresh=2e-3,
                                         n_hyp=n_hyp, solver="five_point", idx=T(idx).long())
    tR, tt, _ = tepi.recover_pose(tE, T(x1), T(x2), tinl)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    assert np.mean(tinl.numpy() != np.asarray(jinl)) <= 0.01
    R, t = tR.numpy(), tt.numpy()
    ang = np.degrees(np.arccos(np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1, 1)))
    tdir = np.degrees(np.arccos(np.clip(abs(t @ t_gt), -1, 1)))
    assert int(tn) > 0.8 * (len(x1) - n_out)
    assert ang < 0.5 and tdir < 2.0


def test_five_point_ransac_draws_its_own_samples():
    """Without idx= the minimal sets are drawn from the uniforms of a key, of
    ``draw_shape``'s n_hyp // 10 samples of five; the pose is still the true one."""
    x1, x2, R_gt, t_gt = scene(7, n=120, noise=5e-4)
    shape = tepi.draw_shape(256, "five_point")
    assert shape == (25, 5)
    u = torch.from_numpy(jax_random.uniform(jax_random.PRNGKey(0), shape))
    E, inl, n = tepi.essential_ransac(u, T(x1), T(x2), torch.ones(120, dtype=torch.bool),
                                      thresh=2e-3, n_hyp=256, solver="five_point")
    R, t, _ = tepi.recover_pose(E, T(x1), T(x2), inl)
    ang = np.degrees(np.arccos(np.clip((np.trace(R.numpy().T @ R_gt) - 1) / 2, -1, 1)))
    assert int(n) > 96 and ang < 0.5


def test_unknown_essential_solver_raises():
    x = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="unknown essential solver"):
        tepi.essential_ransac(None, x, x, torch.ones(10, dtype=torch.bool), 1e-3,
                              solver="seven_point")

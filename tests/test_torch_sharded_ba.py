"""The port's landmark-sharded window BA (``solve/ba/sharded.py::ba_solve_sharded``) on
1, 2 and 4 gloo ranks on the CPU, against the JAX package's ``ba_solve_sharded`` on the
8-device CPU mesh and against the port's ``ba_solve`` (the counterparts of
tests/test_ba.py::test_sharded_ba_matches_single_device and tests/multiprocess_worker.py).

The ranks are processes started by ``lcvo_tpu_torch.parallel.launch.run_ranks`` with
``tests/torch_rank_programs.py:sharded_ba``; each gets the whole problem and writes its
result. Tolerance: the ``ba_solve`` line of ROADMAP §C (cost0 <= 1e-5 relative, final
cost within 5%, R <= 2e-4, t <= 2e-3, X <= 2e-2), against either reference. Largest
difference measured here over the three scenes at 2 and 4 ranks: R 1.1e-5, t 1.1e-4,
X 7.4e-4 against the port's ``ba_solve`` (the order of the sum over landmarks apart,
carried through the LM steps); R 8.4e-6, t 9.5e-5, X 7.9e-4 against the JAX package. At
one rank the result is ``ba_solve``'s exactly, and every rank holds the same result bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lcvo_tpu.core import geometry as jgeo
from lcvo_tpu.parallel.mesh import make_mesh as jmake_mesh
from lcvo_tpu.solve.ba.schur import BAProblem as JProblem
from lcvo_tpu.solve.ba.sharded import ba_solve_sharded as jba_solve_sharded
from lcvo_tpu_torch.parallel.launch import run_ranks

WORLDS = (1, 2, 4)
FIELDS = ("R", "t", "X", "cost0", "cost")


def _make_scene(rng, W, K, noise_px=0.0, fx=500.0):
    """W cameras moving along +x looking at a cloud of K points (tests/test_ba.py)."""
    X = rng.uniform([-4, -2, 6], [4, 2, 14], (K, 3))
    Rs, ts, obs = [], [], []
    for w in range(W):
        ang = 0.02 * w
        Rw = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        t = -Rw @ np.array([0.4 * w, 0.0, 0.0])
        p = (Rw @ X.T).T + t
        Rs.append(Rw)
        ts.append(t)
        obs.append(p[:, :2] / p[:, 2:3] + rng.normal(0, noise_px / fx, (K, 2)))
    return (np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32),
            X.astype(np.float32), np.stack(obs).astype(np.float32))


def _test_ba_scene():
    """tests/test_ba.py's: seed 3, W = 5, K = 64, poses 2.. and every landmark moved."""
    rng = np.random.default_rng(3)
    R, t, X, obs = _make_scene(rng, W=5, K=64)
    R_p, t_p = R.copy(), t.copy()
    for w in range(2, 5):
        R_p[w] = np.asarray(jgeo.rodrigues(jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32)))) @ R[w]
        t_p[w] = t[w] + rng.normal(0, 0.05, 3)
    X_p = X + rng.normal(0, 0.1, X.shape).astype(np.float32)
    return dict(R=R_p, t=t_p, X=X_p, obs=obs, mask=np.ones((5, 64), bool), iters=np.array(6))


def _worker_scene():
    """tests/multiprocess_worker.py's: seed 0, W = 6, K = 64, 0.3 px noise."""
    rng = np.random.default_rng(0)
    R, t, X, obs = _make_scene(rng, W=6, K=64, noise_px=0.3)
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    tp = t + rng.normal(0, 0.01, t.shape).astype(np.float32)
    tp[:2] = t[:2]
    return dict(R=R, t=tp.astype(np.float32), X=X0, obs=obs, mask=np.ones((6, 64), bool),
                iters=np.array(5))


SCENES = {
    "test_ba": _test_ba_scene(),
    "worker": _worker_scene(),
    "fix_rows": {**_test_ba_scene(), "fix_rows": np.array([False, False, False, True, True])},
}


@pytest.fixture(scope="module")
def jax_results():
    mesh = jmake_mesh(8, axis_names=("data",))
    out = {}
    for name, sc in SCENES.items():
        prob = JProblem(*(jnp.asarray(sc[k]) for k in ("R", "t", "X", "obs", "mask")))
        kw = {"fix_rows": jnp.asarray(sc["fix_rows"])} if "fix_rows" in sc else {}
        res = jba_solve_sharded(prob, mesh, axis="data", iters=int(sc["iters"]), n_fix=2, **kw)
        out[name] = {f: np.asarray(getattr(res, f)) for f in FIELDS}
    return out


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """{world: [rank 0's npz, rank 1's, ...]} from one launch per world size."""
    d = tmp_path_factory.mktemp("sharded_ba")
    src = str(d / "scenes.npz")
    np.savez(src, **{f"{name}/{k}": v for name, sc in SCENES.items() for k, v in sc.items()})
    out = {}
    for world in WORLDS:
        run_ranks("tests/torch_rank_programs.py:sharded_ba", world,
                  [src, str(d / f"w{world}")], device="cpu", timeout=240)
        out[world] = [dict(np.load(d / f"w{world}_rank{r}.npz")) for r in range(world)]
    return out


def _assert_within_the_ba_solve_line(got: dict, ref: dict, what: str) -> None:
    c0, rc0 = float(got["cost0"]), float(ref["cost0"])
    assert abs(c0 - rc0) <= 1e-5 * abs(rc0), (what, c0, rc0)
    c, rc = float(got["cost"]), float(ref["cost"])
    assert abs(c - rc) <= max(0.05 * rc, 1e-9), (what, c, rc)
    for f, tol in (("R", 2e-4), ("t", 2e-3), ("X", 2e-2)):
        err = np.abs(got[f] - ref[f]).max()
        assert err <= tol, (what, f, err)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ba_matches_jax_and_ba_solve(rank_results, jax_results, world, scene):
    """Rank 0's result against the JAX package's sharded solve and against the port's
    ``ba_solve`` on the same problem, to the ``ba_solve`` line; the solve converged and
    frozen rows did not move."""
    r0 = rank_results[world][0]
    got = {f: r0[f"{scene}/sharded/{f}"] for f in FIELDS}
    one = {f: r0[f"{scene}/one/{f}"] for f in FIELDS}
    _assert_within_the_ba_solve_line(got, jax_results[scene], f"{scene} at {world} ranks vs JAX")
    _assert_within_the_ba_solve_line(got, one, f"{scene} at {world} ranks vs ba_solve")
    assert float(got["cost"]) < float(got["cost0"])
    sc = SCENES[scene]
    frozen = sc["fix_rows"] if "fix_rows" in sc else np.arange(len(sc["R"])) < 2
    np.testing.assert_array_equal(got["R"][frozen], sc["R"][frozen])
    np.testing.assert_array_equal(got["t"][frozen], sc["t"][frozen])
    if world == 1:
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], one[f], err_msg=f"{scene}: {f} at one rank")


@pytest.mark.parametrize("world", WORLDS[1:])
def test_sharded_ba_is_the_same_on_every_rank(rank_results, world):
    """Poses, costs and the gathered landmarks are bit for bit the same on every rank:
    each decided accept or reject from the same reduced cost."""
    ranks = rank_results[world]
    for scene in SCENES:
        for f in FIELDS:
            for r in range(1, world):
                np.testing.assert_array_equal(ranks[r][f"{scene}/sharded/{f}"],
                                              ranks[0][f"{scene}/sharded/{f}"],
                                              err_msg=f"{scene}/{f} rank {r}")


@pytest.mark.parametrize("world", WORLDS[1:])
def test_landmarks_that_do_not_divide_raise(rank_results, world):
    """K = 63 over 2 or 4 ranks raises ``ValueError`` on every rank (the JAX package
    asserts K % n == 0)."""
    for r in range(world):
        for scene in SCENES:
            assert bool(rank_results[world][r][f"{scene}/odd_k_raised"]), (scene, r)

"""The port's row-sharded matcher (``frontend/match.py::knn_match_ratio_sharded``) on 2
and 4 gloo ranks on the CPU, against the JAX package's ``knn_match_ratio_sharded`` on
the 8-device CPU mesh and against the port's ``knn_match_ratio`` on one rank, on the
inputs of tests/test_match_sharded.py (256 queries, 192 targets, 128-d, seed 0).

``ok`` is exactly the JAX package's and ``idx`` equal where ``ok``; against the port's
unsharded matcher both are equal everywhere (a query row's distances do not depend on
the other rows). The ranks are processes started by ``run_ranks`` with
``tests/torch_rank_programs.py:sharded_match``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lcvo_tpu.frontend.match import knn_match_ratio_sharded as jknn_match_ratio_sharded
from lcvo_tpu.parallel.mesh import make_mesh as jmake_mesh
from lcvo_tpu_torch.parallel.launch import run_ranks

WORLDS = (2, 4)


def _inputs():
    rng = np.random.default_rng(0)
    Nq, Nt, D = 256, 192, 128
    dq = rng.normal(size=(Nq, D)).astype(np.float32)
    dt = rng.normal(size=(Nt, D)).astype(np.float32)
    dt[:64] = dq[:64] + rng.normal(size=(64, D)).astype(np.float32) * 1e-3
    vq = rng.random(Nq) < 0.9
    vt = rng.random(Nt) < 0.9
    return dict(dq=dq, vq=vq, dt=dt, vt=vt)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("sharded_match")
    src = str(d / "inputs.npz")
    np.savez(src, **inputs)
    out = {}
    for world in WORLDS:
        run_ranks("tests/torch_rank_programs.py:sharded_match", world, [src, str(d / f"w{world}")],
                  device="cpu", timeout=180)
        out[world] = [dict(np.load(d / f"w{world}_rank{r}.npz")) for r in range(world)]
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matcher_matches_jax(rank_results, inputs, world):
    """``ok`` exactly the JAX package's sharded matcher's, ``idx`` equal where ``ok``, on
    every rank; and some queries pass the ratio test."""
    idx_j, ok_j = jknn_match_ratio_sharded(jmake_mesh(8), *(jnp.asarray(inputs[k])
                                                             for k in ("dq", "vq", "dt", "vt")))
    ok_j, idx_j = np.asarray(ok_j), np.asarray(idx_j)
    assert ok_j.sum() >= 32
    for r, got in enumerate(rank_results[world]):
        np.testing.assert_array_equal(got["ok"], ok_j, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["idx"][ok_j], idx_j[ok_j], err_msg=f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matcher_equals_one_rank(rank_results, world):
    """Sharded = the port's ``knn_match_ratio`` on the whole query set, ``idx`` (int64)
    and ``ok`` everywhere."""
    for r, got in enumerate(rank_results[world]):
        assert got["idx"].dtype == np.int64 and got["ok"].dtype == np.bool_
        np.testing.assert_array_equal(got["idx"], got["idx_one"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["ok"], got["ok_one"], err_msg=f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_queries_that_do_not_divide_raise(rank_results, world):
    """255 queries over 2 or 4 ranks raise ``ValueError`` on every rank."""
    assert all(bool(got["odd_q_raised"]) for got in rank_results[world])

"""The port's copy of the JAX package's random stream (``lcvo_tpu_torch/utils/jax_random.py``)
and its RANSAC draw (``ops/ransac.py::sample_minimal_sets``) against ``jax.random`` and
the JAX package's ``sample_minimal_sets`` on the CPU: keys, uniforms and minimal sets
equal bit for bit, from numpy on the host and from torch tensors (what the card runs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.ops import ransac as jransac
from lcvo_tpu_torch.ops import ransac as transac
from lcvo_tpu_torch.pipeline import pnp_key, uniforms_fn
from lcvo_tpu_torch.utils import jax_random as jr

SEEDS = range(51)
# the shapes the pipeline draws: PnP (n_hyp, 3), eight-point (n_hyp, 8), five-point
# (n_hyp // 10, 5) at the shipped and the tests' hypothesis counts
SHAPES = [(512, 3), (256, 3), (128, 3), (64, 3), (512, 8), (256, 8), (51, 5), (25, 5),
          (1, 3), (7,), ()]


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def test_prng_key_and_chained_splits_equal_jax():
    """``PRNGKey`` at seeds 0-50 and 2**31 - 1, 2**32 - 1, 2**32 + 5 (taken mod 2**32 as
    JAX takes them), and chains of five ``split`` from each, the host loop's
    ``key, k = split(key)``."""
    for seed in [*SEEDS, 2**31 - 1, 2**32 - 1, 2**32 + 5]:
        jk, tk = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
        assert tk.dtype == np.uint32 and tk.shape == (2,)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        for _ in range(5):
            jk, jsub = jax.random.split(jk)
            tk, tsub = jr.split(tk)
            np.testing.assert_array_equal(tk, np.asarray(jk))
            np.testing.assert_array_equal(tsub, np.asarray(jsub))


@pytest.mark.parametrize("num", [1, 2, 3, 16, 64])
def test_split_into_many_equals_jax(num):
    """``split(key, num)`` (a chunk's keys, the streams' keys) from numpy and from a
    batch of torch keys at once."""
    keys = [jax.random.PRNGKey(s) for s in SEEDS]
    want = np.stack([np.asarray(jax.random.split(k, num)) for k in keys])
    host = np.stack([np.asarray(k) for k in keys])
    np.testing.assert_array_equal(jr.split(host, num), want)
    got = jr.split(torch.from_numpy(host.astype(np.int64)), num)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_equals_jax(shape):
    """``uniform(key, shape)`` float32 bit for bit, from numpy and from torch, at the
    pipeline's shapes and for keys split off seeds 0-50."""
    keys = np.stack([np.asarray(jax.random.split(jax.random.PRNGKey(s))[1]) for s in SEEDS])
    want = np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])
    host = jr.uniform(keys, shape)
    assert host.dtype == np.float32 and host.shape == (len(keys), *shape)
    np.testing.assert_array_equal(_bits(host), _bits(want))
    dev = jr.uniform(torch.from_numpy(keys.astype(np.int64)), shape)
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(_bits(dev.numpy()), _bits(want))


def test_step_uniforms_are_the_jax_steps_pnp_draw():
    """The batched form a chunk runs: for keys (S, chunk, 2), the JAX step's
    ``k_pnp, k_det = split(key)`` then ``uniform(k_pnp, (n_hyp, 3))``, through
    ``pipeline.uniforms_fn`` (the key split on the host, the uniforms on the device)."""
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), 3 * 16)).reshape(3, 16, 2)
    want = np.stack([[np.asarray(jax.random.uniform(jax.random.split(k)[0], (512, 3)))
                      for k in row] for row in keys])
    np.testing.assert_array_equal(_bits(jr.uniform(pnp_key(keys), (512, 3))), _bits(want))
    np.testing.assert_array_equal(pnp_key(keys), np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.split(k)[0]))(keys)))
    got = uniforms_fn(512, "cpu")(keys)
    assert got.shape == (3, 16, 512, 3)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _valid(n: int, kind: str, rng) -> np.ndarray:
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "one":
        v = np.zeros(n, bool)
        v[rng.integers(n)] = True
        return v
    return rng.random(n) < 0.6


@pytest.mark.parametrize("n", [1, 341, 2047, 2048])
@pytest.mark.parametrize("k", [3, 5, 8])
def test_sample_minimal_sets_equals_jax_choice(k, n):
    """The minimal sets equal the JAX package's ``sample_minimal_sets`` and
    ``jax.random.choice`` exactly, all valid, 60% valid, one valid and none valid (every
    index 0 then, as JAX draws), at k = 3 (PnP, 512 sets), 5 (five-point, 51) and 8
    (eight-point, 512)."""
    n_hyp = 51 if k == 5 else 512
    rng = np.random.default_rng(1000 * k + n)
    for kind in ("all", "60%", "one", "none"):
        v = _valid(n, kind, rng)
        key = jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 20))))[1]
        want = np.asarray(jransac.sample_minimal_sets(key, n, jnp.asarray(v), n_hyp, k))
        p = v.astype(np.float32) / max(v.sum(), 1.0)
        np.testing.assert_array_equal(
            want, np.asarray(jax.random.choice(key, n, (n_hyp, k), p=jnp.asarray(p))))
        u = torch.from_numpy(jr.uniform(np.asarray(key), (n_hyp, k)))
        got = transac.sample_minimal_sets(u, n, torch.from_numpy(v))
        assert got.dtype == torch.int64 and got.shape == (n_hyp, k)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{kind} valid")
        if v.any():
            assert v[got.numpy()].all()
        else:
            assert not got.any()


@pytest.mark.parametrize("n", [1, 16, 17, 255, 256, 341, 1024, 2047, 2048, 4096, 5000])
def test_cumsum_rounds_as_jax(n):
    """The prefix sums of the draw's probabilities (zeros and 1/m) equal ``jnp.cumsum``
    jitted on the CPU bit for bit, at fractions of valid points from all to 1%; at
    these sizes a left-to-right sum differs in some last bits."""
    rng = np.random.default_rng(n)
    f = jax.jit(jnp.cumsum)
    for frac in (1.0, 0.6, 0.3, 0.01):
        v = rng.random(n) < frac
        p = (v.astype(np.float32) / np.float32(max(v.sum(), 1))).astype(np.float32)
        np.testing.assert_array_equal(
            _bits(transac.cumsum_as_xla(torch.from_numpy(p)).numpy()), _bits(f(p)))


def test_searchsorted_probes_as_jax_on_unsorted_sums():
    """Where rounding leaves the prefix sums unsorted (a one-ulp dip after invalid
    points), the index is JAX's bisection's, which a plain lower bound can miss: on
    arrays with planted dips and queries at the dips, equal to ``jnp.searchsorted``."""
    rng = np.random.default_rng(5)
    for n in (7, 64, 341, 1024, 2047, 2048):
        c = np.cumsum(rng.random(n).astype(np.float32) * (rng.random(n) < 0.5)).astype(np.float32)
        dips = rng.choice(n - 1, size=max(n // 20, 1), replace=False) + 1
        dips = dips[c[dips - 1] > 0]        # a dip below 0 would be a denormal, which XLA flushes
        c[dips] = np.nextafter(c[dips - 1], np.float32(-1))
        q = np.concatenate([c[dips], c[dips - 1], rng.random(300).astype(np.float32) * c[-1]])
        want = np.asarray(jnp.searchsorted(jnp.asarray(c), jnp.asarray(q)))
        got = transac.searchsorted_as_jax(torch.from_numpy(c), torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_minimal_sets_under_vmap_equals_each_stream():
    """The streams' step draws under ``torch.func.vmap``: each stream's sets equal its
    own call (and so the JAX package's stream s)."""
    rng = np.random.default_rng(3)
    S, n = 3, 341
    v = torch.from_numpy(rng.random((S, n)) < 0.6)
    u = uniforms_fn(64, "cpu")(np.asarray(jax.random.split(jax.random.PRNGKey(2), S)))
    got = torch.func.vmap(lambda uu, vv: transac.sample_minimal_sets(uu, n, vv))(u, v)
    for s in range(S):
        assert torch.equal(got[s], transac.sample_minimal_sets(u[s], n, v[s]))

"""``lcvo_tpu_torch/ops/interp.py`` against ``lcvo_tpu/ops/interp.py`` on the same seeded
numpy inputs, to 1e-6: bilinear sampling (on the grid, between samples, past every
border), the patch grid, patch gathers with and without central-difference gradients,
integer block extraction with XLA's start clamp, and the static-shift block resampler."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.ops import interp as jinterp
from lcvo_tpu_torch.ops import interp

TOL = 1e-6


def _img(rng, H=48, W=64):
    return (rng.normal(size=(H, W)) * 40 + 128).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL * 256)


def test_bilinear_sample_exact_on_grid(rng):
    img = rng.normal(size=(16, 16)).astype(np.float32)
    s = interp.bilinear_sample(torch.from_numpy(img), torch.tensor([[3.0, 5.0]]),
                               torch.tensor([[2.0, 7.0]]))
    np.testing.assert_allclose(s.numpy(), [[img[3, 2], img[5, 7]]], atol=TOL)


def test_bilinear_sample_interpolates():
    img = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    s = interp.bilinear_sample(img, torch.tensor([1.5]), torch.tensor([1.5]))
    np.testing.assert_allclose(s.numpy(), [(5 + 6 + 9 + 10) / 4.0], atol=TOL)


@pytest.mark.parametrize("shape", [(200,), (7, 9), (3, 5, 5)])
def test_bilinear_sample_matches_jax(rng, shape):
    """Coordinates over the whole image and past every border (the clamp)."""
    img = _img(rng)
    ys = rng.uniform(-3, 51, shape).astype(np.float32)
    xs = rng.uniform(-3, 67, shape).astype(np.float32)
    got = interp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    want = jinterp.bilinear_sample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("window", [1, 4, 15])
def test_patch_grid_matches_jax(window):
    dy, dx = interp.patch_grid(window)
    jdy, jdx = jinterp.patch_grid(window)
    np.testing.assert_array_equal(dy.numpy(), np.asarray(jdy))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("window", [7, 15])
def test_gather_patches_matches_jax(rng, window):
    img = _img(rng)
    pts = rng.uniform([-5, -5], [70, 54], (33, 2)).astype(np.float32)
    got = interp.gather_patches(torch.from_numpy(img), torch.from_numpy(pts), window)
    want = jinterp.gather_patches(jnp.asarray(img), jnp.asarray(pts), window)
    assert got.shape == (33, window, window)
    _close(got, want)


@pytest.mark.parametrize("size", [1, 8, 21])
def test_extract_blocks_matches_jax(rng, size):
    """Origins inside, past every edge and at the corners: a negative start counts from
    the end and every start clamps into the image, as ``lax.dynamic_slice`` does."""
    img = _img(rng)
    H, W = img.shape
    origins = np.concatenate([
        rng.integers([0, 0], [W - size + 1, H - size + 1], (20, 2)),
        np.array([[-7, -3], [W, H], [W - size + 3, 5], [4, H - size + 9], [-1, H + 2]]),
    ]).astype(np.int32)
    got = interp.extract_blocks(torch.from_numpy(img), torch.from_numpy(origins), size)
    want = jinterp.extract_blocks(jnp.asarray(img), jnp.asarray(origins), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_blocks_bilinear_matches_jax(rng):
    blocks = rng.normal(size=(19, 21, 21)).astype(np.float32)
    frac = rng.uniform(0, 1, (19, 2)).astype(np.float32)
    got = interp.sample_blocks_bilinear(torch.from_numpy(blocks), torch.from_numpy(frac), 15)
    want = jinterp.sample_blocks_bilinear(jnp.asarray(blocks), jnp.asarray(frac), 15)
    assert got.shape == (19, 15, 15)
    _close(got, want)


def test_gather_patches_with_grad_matches_jax(rng):
    img = _img(rng)
    pts = rng.uniform([2, 2], [62, 46], (25, 2)).astype(np.float32)
    got = interp.gather_patches_with_grad(torch.from_numpy(img), torch.from_numpy(pts), 9)
    want = jinterp.gather_patches_with_grad(jnp.asarray(img), jnp.asarray(pts), 9)
    for g, w in zip(got, want):
        _close(g, w)


def test_gather_patches_with_grad_is_differentiable(rng):
    """Autograd through the patches and the central differences, in the image and in
    the points, against finite differences (float64)."""
    img = torch.from_numpy(rng.normal(size=(12, 14))).requires_grad_()
    pts = torch.from_numpy(rng.uniform([4.2, 4.2], [9.3, 7.3], (3, 2))).requires_grad_()

    def f(im, p):
        return interp.gather_patches_with_grad(im, p, 3)

    assert torch.autograd.gradcheck(f, (img, pts), eps=1e-6, atol=1e-5)

"""KLT block extraction: the port's plain version against the JAX package's two paths.

The CUDA kernel (``lcvo_tpu_torch/csrc/extract_blocks.cu``) cannot run on the CPU; it
is held bit for bit against the plain version by ``chip_smoke.py`` on the card. Here
the plain version, which the kernel copies, is held against ``klt._extract_blocks``
(the XLA path the JAX package runs on CPU and GPU) and against the Pallas kernel in
interpret mode. Tolerance everywhere: exact (a block extraction is a copy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.ops import klt as jklt
from lcvo_tpu.ops.klt_pallas import extract_blocks_pallas
from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.ops import klt as tklt
from lcvo_tpu_torch.ops.klt_extract import extract_blocks, extract_blocks_plain


def _image(rng, H, W):
    return (rng.uniform(0, 255, size=(H, W))).astype(np.float32)


def _centers_all_borders(rng, n, H, W, S):
    """Random centers over [-S, W+S] x [-S, H+S], plus ones past each border and
    corner, so origins clamp at all four borders."""
    c = rng.uniform([-S, -S], [W + S, H + S], size=(n, 2)).astype(np.float32)
    far = 3.0 * S
    fixed = np.array([[-far, -far], [W + far, H + far], [-far, H + far], [W + far, -far],
                      [W / 2, -far], [W / 2, H + far], [-far, H / 2], [W + far, H / 2]],
                     np.float32)
    c[: len(fixed)] = fixed
    return c


@pytest.mark.parametrize("H,W,S,N", [(50, 70, 15, 40), (94, 310, 21, 64),
                                     (128, 344, 33, 63), (61, 97, 29, 17)])
def test_plain_matches_xla_path_all_borders(rng, H, W, S, N):
    img = _image(rng, H, W)
    c = _centers_all_borders(rng, N, H, W, S)
    jb, jo = jklt._extract_blocks(jnp.asarray(img), jnp.asarray(c), S)
    tb, to = extract_blocks_plain(torch.from_numpy(img), torch.from_numpy(c), S)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.dtype == torch.float32
    # every border was clamped
    o = to.numpy()
    assert o[:, 0].min() == 0 and o[:, 0].max() == W - S
    assert o[:, 1].min() == 0 and o[:, 1].max() == H - S


@pytest.mark.parametrize("H,W,S", [(50, 70, 15), (72, 150, 21), (60, 140, 29)])
def test_plain_matches_pallas_interpret_in_range(rng, H, W, S):
    """Pallas kernel (interpret mode on CPU) against the plain version, for centers
    whose origins lie inside [0, W-S] x [0, H-S], where the two paths agree."""
    N = 24
    img = _image(rng, H, W)
    half = (S - 1) // 2
    c = rng.uniform([half, half], [W - S + half + 0.99, H - S + half + 0.99],
                    size=(N, 2)).astype(np.float32)
    pb, po = extract_blocks_pallas(jnp.asarray(img), jnp.asarray(c), S)
    tb, to = extract_blocks_plain(torch.from_numpy(img), torch.from_numpy(c), S)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(pb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(po))


def test_quirk1_pallas_diverges_past_right_bottom_border():
    """ROADMAP §C quirk 1: the Pallas kernel clamps origins against its
    alignment-padded image, the XLA path against the caller's. The port follows the
    XLA semantics."""
    H, W, S = 50, 70, 15
    img = np.arange(H * W, dtype=np.float32).reshape(H, W)
    c = np.tile(np.array([[68.3, 48.7]], np.float32), (8, 1))
    _, po = extract_blocks_pallas(jnp.asarray(img), jnp.asarray(c), S)
    _, xo = jklt._extract_blocks(jnp.asarray(img), jnp.asarray(c), S)
    _, to = extract_blocks_plain(torch.from_numpy(img), torch.from_numpy(c), S)
    assert np.asarray(po)[0].tolist() == [61.0, 41.0]
    assert np.asarray(xo)[0].tolist() == [55.0, 35.0]
    assert to[0].tolist() == [55.0, 35.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_runs_plain_version_without_counting(rng, dtype):
    """On CPU tensors the wrapper is the plain version (any N, f32 or bf16) and adds
    nothing to the launch counter, which counts kernel launches only."""
    H, W, S = 64, 96, 21
    img = torch.from_numpy(_image(rng, H, W)).to(dtype)
    c = torch.from_numpy(_centers_all_borders(rng, 13, H, W, S))
    kernels.reset_launches()
    b, o = extract_blocks(img, c, S)
    bp, op = extract_blocks_plain(img, c, S)
    assert b.dtype == dtype and b.shape == (13, S, S)
    assert torch.equal(b, bp) and torch.equal(o, op)
    assert tklt._extract_blocks(img, c, S)[0].equal(bp)
    assert kernels.LAUNCHES == {"extract_blocks": 0}


def test_nan_and_inf_centers_clamp_like_the_kernel():
    """The kernel's fmaxf/fminf clamp maps NaN to origin 0 and infinities to the
    nearest edge; the plain version does the same."""
    img = torch.arange(40 * 50, dtype=torch.float32).reshape(40, 50)
    c = torch.tensor([[float("nan"), 10.0], [float("inf"), float("-inf")]])
    _, o = extract_blocks_plain(img, c, 9)
    assert o.tolist() == [[0.0, 6.0], [41.0, 0.0]]


def test_wrapper_rejects_bad_arguments():
    img = torch.zeros(20, 30)
    with pytest.raises(ValueError):
        extract_blocks(img[None], torch.zeros(4, 2), 5)
    with pytest.raises(ValueError):
        extract_blocks(img, torch.zeros(4, 3), 5)
    with pytest.raises(ValueError):
        extract_blocks(img, torch.zeros(4, 2), 21)
    with pytest.raises(ValueError):
        extract_blocks(img, torch.zeros(4, 2, device="meta"), 5)

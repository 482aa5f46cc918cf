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
from torch.utils._python_dispatch import TorchDispatchMode

from lcvo_tpu.ops import klt as jklt
from lcvo_tpu.ops.klt_pallas import extract_blocks_pallas
from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.ops import klt as tklt
from lcvo_tpu_torch.ops.klt_extract import (extract_blocks, extract_blocks_layered,
                                           extract_blocks_layered_plain, extract_blocks_plain,
                                           slab_plan)


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
    assert kernels.LAUNCHES == {"extract_blocks": 0, "extract_blocks_layered": 0, "svd": 0,
                                "p3p": 0, "klt_iterate": 0}


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


# ---- the edge padding folded into the extraction (``pad=``) ----

def _centers_pad_cases(rng, n, H, W, S, nan=True):
    """Centers past every border and corner, centers just below an integer (so that
    ``cx + pad`` rounds up across it in f32) and just below zero, infinities and, with
    ``nan``, NaNs."""
    c = _centers_all_borders(rng, n, H, W, S)
    below = [np.nextafter(np.float32(k), np.float32(0)) for k in (1, 2, 8)]
    inf = np.inf
    extra = [[b, b] for b in below] + [[below[0], H / 2], [W / 2, below[1]],
                                       [-1e-8, -1e-8], [-1e-30, 5.0], [0.0, 0.0],
                                       [W - 1.0, H - 1.0], [inf, -inf], [-inf, inf]]
    if nan:
        extra += [[np.nan, 10.0], [10.0, np.nan], [np.nan, np.nan]]
    c[8: 8 + len(extra)] = np.array(extra, np.float32)
    return c


_PAD_CASES = [(50, 70, 15, 8, 40), (94, 310, 33, 17, 64), (47, 155, 29, 15, 63),
              (29, 155, 29, 15, 33), (61, 97, 30, 15, 40), (20, 24, 33, 17, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,W,S,p,N", _PAD_CASES)
def test_plain_with_pad_equals_pad_then_extract(rng, H, W, S, p, N, dtype):
    """``extract_blocks_plain(img, c, S, pad=p)`` is, exactly, the composition the
    tracker used before the pad was folded in: extract from the edge-padded copy at
    ``c + p`` and take ``p`` off the origins."""
    img = torch.from_numpy(_image(rng, H, W)).to(dtype)
    c = torch.from_numpy(_centers_pad_cases(rng, N, H, W, S))
    b, o = extract_blocks_plain(img, c, S, pad=p)
    padded = torch.nn.functional.pad(img[None, None], (p, p, p, p), mode="replicate")[0, 0]
    bp, op = extract_blocks_plain(padded, c + p, S)
    assert torch.equal(b, bp) and torch.equal(o, op - p)
    assert b.dtype == dtype and o.dtype == torch.float32
    # origins in the coordinates of the image given; every border was clamped
    assert o[:, 0].min() == -p and o[:, 0].max() == W + p - S
    assert o[:, 1].min() == -p and o[:, 1].max() == H + p - S
    # each element is the edge-clamped read the kernel does
    oy = (o[:, 1].long()[:, None] + torch.arange(S)[None, :]).clamp(0, H - 1)
    ox = (o[:, 0].long()[:, None] + torch.arange(S)[None, :]).clamp(0, W - 1)
    assert torch.equal(b, img[oy[:, :, None], ox[:, None, :]])


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,W,S,p,N", _PAD_CASES)
def test_plain_with_pad_matches_xla_path_on_padded_image(rng, H, W, S, p, N, dtype):
    """Against the JAX package as ``klt._track_level`` calls it: edge-pad, extract at
    ``c + p``, take ``p`` off the origins."""
    img = _image(rng, H, W)
    c = _centers_pad_cases(rng, N, H, W, S, nan=False)
    jimg = jnp.asarray(img).astype(dtype)
    jb, jo = jklt._extract_blocks(jnp.pad(jimg, p, mode="edge"), jnp.asarray(c) + p, S)
    timg = torch.from_numpy(np.array(jimg.astype(jnp.float32)))
    if dtype is not np.float32:
        timg = timg.to(torch.bfloat16)
    tb, to = extract_blocks_plain(timg, torch.from_numpy(c), S, pad=p)
    np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb.astype(jnp.float32)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo) - p)


def test_pad_is_added_in_f32_before_the_floor():
    """``floor(cx + p)`` in f32 is not ``floor(cx) + p`` for every cx: the largest f32
    below 1 plus 15 rounds to 16. Both packages add first; so does the kernel."""
    H, W, S, p = 40, 60, 9, 15
    cx = float(np.nextafter(np.float32(1), np.float32(0)))
    img = torch.arange(H * W, dtype=torch.float32).reshape(H, W)
    c = torch.tensor([[cx, 20.0], [-1e-8, 20.0]])
    _, o = extract_blocks_plain(img, c, S, pad=p)
    _, jo = jklt._extract_blocks(jnp.pad(jnp.asarray(img.numpy()), p, mode="edge"),
                                 jnp.asarray(c.numpy()) + p, S)
    assert o[:, 0].tolist() == [1.0 - 4, 0.0 - 4]          # not floor(cx) - 4 = [-4, -5]
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo) - p)


@pytest.mark.parametrize("H,W,S,N", [(50, 70, 15, 40), (61, 97, 29, 27)])
def test_pad_zero_is_the_unpadded_function(rng, H, W, S, N):
    img = _image(rng, H, W)
    c = _centers_pad_cases(rng, N, H, W, S, nan=False)
    b0, o0 = extract_blocks_plain(torch.from_numpy(img), torch.from_numpy(c), S, pad=0)
    b, o = extract_blocks_plain(torch.from_numpy(img), torch.from_numpy(c), S)
    jb, jo = jklt._extract_blocks(jnp.asarray(img), jnp.asarray(c), S)
    assert torch.equal(b0, b) and torch.equal(o0, o)
    np.testing.assert_array_equal(b0.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(o0.numpy(), np.asarray(jo))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pad", [0, 11, 40])
def test_cpu_wrapper_with_pad_runs_plain_version_without_counting(rng, dtype, pad):
    H, W, S = 64, 96, 21
    img = torch.from_numpy(_image(rng, H, W)).to(dtype)
    c = torch.from_numpy(_centers_pad_cases(rng, 37, H, W, S))
    kernels.reset_launches()
    b, o = extract_blocks(img, c, S, pad=pad)
    bp, op = extract_blocks_plain(img, c, S, pad=pad)
    assert torch.equal(b, bp) and torch.equal(o, op)
    assert kernels.LAUNCHES == {"extract_blocks": 0, "extract_blocks_layered": 0, "svd": 0,
                                "p3p": 0, "klt_iterate": 0}


@pytest.mark.parametrize("S,pad,exc", [(5, -1, ValueError), (5, 1.5, ValueError),
                                       (5, None, ValueError), (23, 1, ValueError),
                                       (33, 1, ValueError)])
def test_wrapper_rejects_bad_pad(S, pad, exc):
    """pad must be an int >= 0, and the block must fit the padded image (20x30 here:
    S = 23 needs pad >= 2)."""
    with pytest.raises(exc):
        extract_blocks(torch.zeros(20, 30), torch.zeros(4, 2), S, pad=pad)


def test_wrapper_accepts_block_larger_than_image_when_padded():
    b, o = extract_blocks(torch.ones(20, 30), torch.zeros(4, 2), 23, pad=2)
    assert b.shape == (4, 23, 23) and bool((b == 1).all())
    assert o.tolist() == [[-2.0, -2.0]] * 4


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("S", [21, 29, 30, 32, 33, 7])
@pytest.mark.parametrize("N", [1, 5, 2047, 2048])
def test_slab_plan_aligned_slabs_cover_every_track_once(N, S, itemsize):
    """The kernel's cut of the output: slabs of G tracks that are multiples of 16
    bytes (so each starts 16-byte aligned), then a tail of fewer than G single
    tracks."""
    G, n_groups = slab_plan(N, S, itemsize)
    assert 1 <= G <= 32                       # kMaxGroup of the kernel
    assert (G * S * S * itemsize) % 16 == 0
    assert 0 <= N - n_groups * G < G
    covered = [n for g in range(n_groups) for n in range(g * G, (g + 1) * G)]
    covered += list(range(n_groups * G, N))
    assert covered == list(range(N))


# ---- the layered entry and the batching rule (``torch.func.vmap``) ----

def _layered_case(rng, L, H, W, S, N):
    img = np.stack([_image(rng, H, W) for _ in range(L)])
    c = _centers_pad_cases(rng, N, H, W, S)
    layer = rng.integers(0, L, size=N).astype(np.int32)
    layer[:L] = np.arange(L)                  # every layer used
    return torch.from_numpy(img), torch.from_numpy(c), torch.from_numpy(layer)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("H,W,S,pad_y,pad_x,N", [(50, 70, 15, 8, 8, 40), (47, 155, 29, 15, 15, 63),
                                                 (61, 97, 21, 11, 0, 40), (40, 30, 29, 0, 15, 33),
                                                 (29, 155, 29, 3, 17, 37)])
def test_layered_equals_the_per_layer_call(rng, dtype, L, H, W, S, pad_y, pad_x, N):
    """Block n of the layered call is the 2-D call on layer ``layer[n]``: with one pad,
    ``extract_blocks`` itself; with a pad per axis, the extraction from the layer
    edge-padded by (pad_y, pad_x) at ``c + (pad_x, pad_y)`` with the pads taken off the
    origins. Mixed layers, centers past every edge, NaN and infinite centers; exact. On
    CPU tensors the wrapper is the plain version and counts no launch."""
    img, c, layer = _layered_case(rng, L, H, W, S, N)
    img = img.to(dtype)
    kernels.reset_launches()
    b, o = extract_blocks_layered(img, c, layer, S, pad_y=pad_y, pad_x=pad_x)
    bp, op = extract_blocks_layered_plain(img, c, layer, S, pad_y, pad_x)
    assert torch.equal(b, bp) and torch.equal(o, op)
    assert kernels.LAUNCHES == {"extract_blocks": 0, "extract_blocks_layered": 0, "svd": 0,
                                "p3p": 0, "klt_iterate": 0}
    assert b.shape == (N, S, S) and b.dtype == dtype and o.dtype == torch.float32
    shift = torch.tensor([float(pad_x), float(pad_y)])
    for n in range(N):
        one = img[int(layer[n])]
        if pad_y == pad_x:
            want_b, want_o = extract_blocks(one, c[n: n + 1], S, pad=pad_y)
        else:
            padded = torch.nn.functional.pad(one[None, None], (pad_x, pad_x, pad_y, pad_y),
                                             mode="replicate")[0, 0]
            want_b, want_o = extract_blocks_plain(padded, c[n: n + 1] + shift, S)
            want_o = want_o - shift
        assert torch.equal(b[n: n + 1], want_b) and torch.equal(o[n: n + 1], want_o), n


class _OpCalls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("batched", ["both", "centers", "image"])
@pytest.mark.parametrize("pad", [0, 15])
def test_vmap_of_extract_blocks_is_one_call_and_equals_the_loop(rng, batched, pad):
    """``torch.func.vmap`` of ``extract_blocks`` over B = 4 images and/or sets of
    centers equals the per-image loop, exactly, and reaches the backend as ONE call of
    the layered entry (layer b for the centers of call b; an image that is not batched
    is broadcast to the B layers)."""
    B, H, W, S, N = 4, 47, 155, 29, 37
    imgs = torch.from_numpy(np.stack([_image(rng, H, W) for _ in range(B)]))
    cs = torch.from_numpy(np.stack([_centers_pad_cases(rng, N, H, W, S) for _ in range(B)]))
    img_dim = None if batched == "centers" else 0
    c_dim = None if batched == "image" else 0
    args = (imgs if img_dim == 0 else imgs[0], cs if c_dim == 0 else cs[0])
    with _OpCalls() as calls:
        vb, vo = torch.func.vmap(lambda i, c: extract_blocks(i, c, S, pad=pad),
                                 in_dims=(img_dim, c_dim))(*args)
    ops = [n for n in calls.names if n.startswith("lcvo.")]
    assert ops == ["lcvo.extract_blocks_layered"]
    for k in range(B):
        b, o = extract_blocks(imgs[k] if img_dim == 0 else imgs[0],
                              cs[k] if c_dim == 0 else cs[0], S, pad=pad)
        assert torch.equal(vb[k], b) and torch.equal(vo[k], o), k


def test_layered_clamps_a_layer_outside_the_stack(rng):
    """A layer index below 0 reads layer 0 and one of L or more reads layer L-1, as the
    kernel clamps it (no wrap-around, no error); exact."""
    L, H, W, S, N = 3, 40, 30, 15, 24
    img, c, _ = _layered_case(rng, L, H, W, S, N)
    layer = torch.tensor([-1, -7, 0, 1, L - 1, L, L + 5, -2 ** 31] * 3, dtype=torch.int32)
    b, o = extract_blocks_layered(img, c, layer, S, pad_y=8, pad_x=8)
    want = extract_blocks_layered(img, c, layer.clamp(0, L - 1), S, pad_y=8, pad_x=8)
    assert torch.equal(b, want[0]) and torch.equal(o, want[1])
    for n, li in enumerate((0, 0, 0, 1, L - 1, L - 1, L - 1, 0) * 3):
        wb, wo = extract_blocks(img[li], c[n: n + 1], S, pad=8)
        assert torch.equal(b[n: n + 1], wb) and torch.equal(o[n: n + 1], wo), n


def test_layered_rejects_bad_arguments():
    img, c = torch.zeros(2, 20, 30), torch.zeros(4, 2)
    with pytest.raises(ValueError):
        extract_blocks_layered(img[0], c, torch.zeros(4, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        extract_blocks_layered(img, c, torch.zeros(4, dtype=torch.int64), 5)
    with pytest.raises(ValueError):
        extract_blocks_layered(img, c, torch.zeros(3, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        extract_blocks_layered(img, c, torch.zeros(4, dtype=torch.int32), 31, pad_y=6)

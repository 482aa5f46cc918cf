"""The ``lcvo::klt_iterate`` operator on the CPU: the plain IC-LK tail of a KLT level
behind the operator that launches ``csrc/klt_iterate.cu`` on the card.

The CPU path must be the tracker as it was before the operator existed, bit for bit:
that code is ``ops/klt.py::_iterate_level_plain``, moved there unchanged, and the JAX
parity tests of ``tests/test_torch_ops.py`` hold it to the JAX package. This file keeps a
frozen copy of the level as it was (``_track_level_frozen``) and holds the operator and
``pyramidal_klt`` to it. The kernel itself runs only on a card (``chip_smoke.py``,
``[kernel] klt_iterate``)."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.ops import klt as tklt
from lcvo_tpu_torch.ops.pyramid import build_pyramid, gaussian_blur


def _track_level_frozen(prev_img, next_img, pts_l, d, window, iters, eps,
                        iter_dtype=torch.float32, margin: int = 6):
    """``ops/klt.py::_track_level`` before the operator, verbatim but for the helpers'
    module prefix; returns its blocks too."""
    w = window
    r = (w - 1) // 2
    S = w + 2 + 2 * margin
    S_t = w + 2 + 2 * 2
    p = (S + 1) // 2
    tblocks, torig = tklt._extract_blocks(prev_img, pts_l, S_t, pad=p)
    nblocks, norig = tklt._extract_blocks(next_img, pts_l + d, S, pad=p)
    blocks = (tblocks, torig, nblocks, norig)

    qt = pts_l - torig
    T2 = tklt._sample_blocks(tblocks, qt[:, 0], qt[:, 1], w + 2)
    T = T2[:, 1: 1 + w, 1: 1 + w]
    gx = 0.5 * (T2[:, 1: 1 + w, 2: 2 + w] - T2[:, 1: 1 + w, 0:w])
    gy = 0.5 * (T2[:, 2: 2 + w, 1: 1 + w] - T2[:, 0:w, 1: 1 + w])
    hxx = torch.sum(gx * gx, dim=(1, 2))
    hxy = torch.sum(gx * gy, dim=(1, 2))
    hyy = torch.sum(gy * gy, dim=(1, 2))
    det = hxx * hyy - hxy * hxy
    det_ok = det > 1e-6
    safe_det = torch.where(det_ok, det, torch.ones_like(det))

    nblocks = nblocks.to(iter_dtype)
    T = T.to(iter_dtype)
    gx_i = gx.to(iter_dtype)
    gy_i = gy.to(iter_dtype)

    dd_min = norig + (r + 1) - pts_l
    dd_max = norig + (S - r - 2) - pts_l

    for _ in range(iters):
        q = pts_l + d - norig
        I = tklt._sample_blocks(nblocks, q[:, 0], q[:, 1], w)
        e = I - T
        bx = torch.sum(gx_i * e, dim=(1, 2))
        by = torch.sum(gy_i * e, dim=(1, 2))
        ddx = (hyy * bx - hxy * by) / safe_det
        ddy = (-hxy * bx + hxx * by) / safe_det
        step = torch.stack([ddx, ddy], dim=-1)
        live = det_ok & (torch.sum(step * step, dim=-1) >= eps * eps)
        d = d - torch.where(live[:, None], step, torch.zeros_like(step))
        d = torch.minimum(torch.maximum(d, dd_min), dd_max)
    q = pts_l + d - norig
    I = tklt._sample_blocks(nblocks, q[:, 0], q[:, 1], w)
    residual = torch.mean(torch.abs(I - T), dim=(1, 2))
    sat = torch.any((d <= dd_min + 1e-3) | (d >= dd_max - 1e-3), dim=-1)
    return (d, det_ok, sat, residual), blocks


def _frames(seed=0, H=96, W=128, shift=(2.3, -1.4)):
    """A textured frame and the same frame moved by ``shift`` (x, y), with a flat patch
    at the top left, f32."""
    rng = np.random.default_rng(seed)
    img = gaussian_blur(torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32)), 1.5)
    img = (img * 50 + 128).numpy()
    img[4:30, 4:30] = 77.0
    nxt = ndimage.shift(img, (shift[1], shift[0]), order=1, mode="nearest").astype(np.float32)
    return torch.from_numpy(img), torch.from_numpy(nxt)


def _points(H=96, W=128, n=61, seed=1):
    """``n`` points: textured ones, a NaN center, one whose displacement starts far
    outside its block (pinned at the margin) and two on the flat patch."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(30, W - 10, n), rng.uniform(30, H - 10, n)], -1)
    d = rng.normal(0, 1.0, (n, 2))
    pts[0] = np.nan                  # a NaN center
    d[1] = (40.0, -35.0)             # far off: clamped, sat
    pts[2], pts[3] = (15.0, 15.0), (17.5, 14.25)    # flat: det <= 1e-6
    return torch.from_numpy(pts.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("window", [15, 21])
@pytest.mark.parametrize("img_dtype,iter_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_klt_iterate_on_cpu_is_the_frozen_tail(window, img_dtype, iter_dtype):
    """The operator on the frozen level's own blocks = the frozen level's tail, bit for
    bit, at f32 and bf16 and windows 15 and 21; the NaN center, the pinned displacement
    and the flat patch come out as the plain code has them."""
    img, nxt = _frames()
    pts, d = _points()
    prev, nxt = img.to(img_dtype), nxt.to(img_dtype)
    want, blocks = _track_level_frozen(prev, nxt, pts, d, window, 6, 0.01, iter_dtype)
    got = tklt.klt_iterate(*blocks, pts, d, window, 6, 0.01, iter_dtype)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    d_out, det_ok, sat, residual = got
    assert d_out.isnan().all(-1)[0] and residual[0].isnan() and not det_ok[0]
    assert sat[1] and det_ok[1]
    assert not det_ok[2] and not det_ok[3]
    assert det_ok[4:].float().mean() > 0.9
    assert d_out.dtype == torch.float32 and det_ok.dtype == torch.bool and sat.dtype == torch.bool


@pytest.mark.parametrize("case", ["tracker", "zero_start_21", "bf16_iter", "iters_coarse"])
def test_pyramidal_klt_on_cpu_is_the_frozen_code(case, monkeypatch):
    """``pyramidal_klt`` through the operator = ``pyramidal_klt`` with the frozen level,
    bit for bit: the step's joint tracker (per-level margins, a motion prior, 2 coarse
    iterations), a zero-start window-21 bootstrap hop, the bf16 loop and full coarse
    iterations."""
    img, nxt = _frames(seed=3, H=128, W=160, shift=(5.6, 3.1))
    pts = _points(128, 160, n=96, seed=4)[0]
    kw = {"tracker": dict(window=15, iters=6, margin=(6, 6, 8), iters_coarse=2,
                          init_d=torch.full((96, 2), 4.0)),
          "zero_start_21": dict(window=21, iters=10),
          "bf16_iter": dict(window=15, iters=6, iter_dtype="bfloat16"),
          "iters_coarse": dict(window=15, iters=6, eps=0.003)}[case]
    pyr0, pyr1 = build_pyramid(img, 3), build_pyramid(nxt, 3)
    got = tklt.pyramidal_klt(pyr0, pyr1, pts, **kw)
    monkeypatch.setattr(tklt, "_track_level", lambda *a, **k: _track_level_frozen(*a, **k)[0])
    want = tklt.pyramidal_klt(pyr0, pyr1, pts, **kw)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    assert got[1].float().mean() > 0.5


def _level_inputs(B=3, N=40):
    """The blocks and points of B streams' level-0 calls, stacked."""
    outs = []
    for s in range(B):
        img, nxt = _frames(seed=10 + s)
        pts, d = _points(n=N, seed=20 + s)
        outs.append((*_track_level_frozen(img, nxt, pts, d, 15, 5, 0.01)[1], pts, d))
    return [torch.stack(x) for x in zip(*outs)]


@pytest.mark.parametrize("in_dims", [(0,) * 6, (0, 0, 0, 0, None, 0), (1,) * 6])
def test_klt_iterate_vmap_rule_equals_the_stream_loop(in_dims):
    """Under ``torch.func.vmap`` (the batched streams' step) B calls are one call on the
    B * N tracks, equal to calling each stream alone."""
    args = _level_inputs()
    if in_dims[4] is None:
        args[4] = args[4][0]
    per_stream = [tklt.klt_iterate(*(a if dim is None else a[s] for a, dim in zip(args, in_dims)),
                                   15, 5, 0.01) for s in range(3)]
    if in_dims[0] == 1:
        args = [a.movedim(0, 1) for a in args]
    got = torch.func.vmap(lambda *a: tklt.klt_iterate(*a, 15, 5, 0.01), in_dims=in_dims)(*args)
    for k in range(4):
        assert _bits_equal(got[k], torch.stack([r[k] for r in per_stream]))


def test_klt_iterate_vmap_is_one_call_of_the_operator(monkeypatch):
    """The batching rule calls the operator once with the streams folded into the tracks."""
    calls = []
    real = tklt._iterate_level_plain
    monkeypatch.setattr(tklt, "_iterate_level_plain",
                        lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    args = _level_inputs(B=4, N=8)
    torch.func.vmap(lambda *a: tklt.klt_iterate(*a, 15, 2, 0.01))(*args)
    assert calls == [(32,) + tuple(args[0].shape[2:])]


def test_klt_iterate_without_iterations_returns_a_new_tensor():
    """With ``iters`` 0 the displacement comes back equal to the input, not the input."""
    args = [a[0] for a in _level_inputs(B=1, N=8)]
    d, *_ = tklt.klt_iterate(*args, 15, 0, 0.01)
    assert torch.equal(d, args[5]) and d.data_ptr() != args[5].data_ptr()


@pytest.mark.parametrize("case,exc", [
    ("f64_blocks", TypeError), ("mixed_blocks", TypeError), ("f64_points", TypeError),
    ("f16_iter", TypeError), ("rows", ValueError), ("flat_blocks", ValueError),
    ("even_window", ValueError), ("window_too_large", ValueError),
    ("negative_iters", ValueError), ("devices", ValueError)])
def test_klt_iterate_wrapper_raises(case, exc):
    tb, to, nb, no, p, d = [a[0] for a in _level_inputs(B=1, N=8)]
    args, w, iters, idt = [tb, to, nb, no, p, d], 15, 3, torch.float32
    if case == "f64_blocks":
        args[0], args[2] = tb.double(), nb.double()
    elif case == "mixed_blocks":
        args[0] = tb.bfloat16()
    elif case == "f64_points":
        args[4] = p.double()
    elif case == "f16_iter":
        idt = torch.float16
    elif case == "rows":
        args[5] = d[:5]
    elif case == "flat_blocks":
        args[2] = nb.flatten(1)
    elif case == "even_window":
        w = 14
    elif case == "window_too_large":
        w = tb.shape[1] - 1
    elif case == "negative_iters":
        iters = -1
    elif case == "devices":
        args[2] = nb.to("meta")
    with pytest.raises(exc):
        tklt.klt_iterate(*args, w, iters, 0.01, idt)


def test_klt_launch_counter_is_zero_on_cpu():
    """The counter exists and counts kernel launches only: a CPU call adds nothing."""
    assert "klt_iterate" in kernels.LAUNCHES
    kernels.reset_launches()
    args = [a[0] for a in _level_inputs(B=1, N=8)]
    tklt.klt_iterate(*args, 15, 3, 0.01)
    torch.func.vmap(lambda *a: tklt.klt_iterate(*a, 15, 3, 0.01))(*(a[None] for a in args))
    assert kernels.LAUNCHES["klt_iterate"] == 0

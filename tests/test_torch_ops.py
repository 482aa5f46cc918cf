"""Pyramid, corner detection and pyramidal KLT: the port against the JAX package on the
same inputs (made with numpy from a seed; the JAX side runs on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.ops import harris as jharris
from lcvo_tpu.ops import interp as jinterp
from lcvo_tpu.ops import klt as jklt
from lcvo_tpu.ops import pyramid as jpyr
from lcvo_tpu_torch.ops import harris as tharris
from lcvo_tpu_torch.ops import klt as tklt
from lcvo_tpu_torch.ops import pyramid as tpyr


def synth_texture(rng, H, W, smooth=1.5):
    img = rng.normal(size=(H, W)).astype(np.float32)
    img = np.asarray(jpyr.gaussian_blur(jnp.asarray(img), smooth)) * 50 + 128
    return img.astype(np.float32)


def shifted(img, shift):
    """``img`` moved by (dx, dy), bilinear (the construction of tests/test_ops.py)."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.asarray(jinterp.bilinear_sample(jnp.asarray(img), jnp.asarray(yy - shift[1]),
                                              jnp.asarray(xx - shift[0])))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


@pytest.mark.parametrize("H,W,levels", [(128, 192, 3), (376 // 2, 1240 // 4, 3), (95, 133, 4)])
def test_build_pyramid_matches_jax(rng, H, W, levels):
    """Per level, relative error <= 1e-5 (fp32 band products, summation order)."""
    img = rng.uniform(0, 255, size=(H, W)).astype(np.float32)
    jp = jpyr.build_pyramid(jnp.asarray(img), levels)
    tp = tpyr.build_pyramid(torch.from_numpy(img), levels)
    assert [tuple(t.shape) for t in tp] == [tuple(j.shape) for j in jp]
    for j, t in zip(jp, tp):
        assert rel_err(t.numpy(), j) <= 1e-5


@pytest.mark.parametrize("fn", ["sobel", "box", "blur"])
def test_separable_filters_match_jax(rng, fn):
    """Shift-and-add filters with zero padding: relative error <= 1e-6."""
    img = rng.uniform(0, 255, size=(37, 53)).astype(np.float32)
    if fn == "sobel":
        j = jpyr.sobel_gradients(jnp.asarray(img))
        t = tpyr.sobel_gradients(torch.from_numpy(img))
    elif fn == "box":
        j = (jpyr.box_filter(jnp.asarray(img), 3),)
        t = (tpyr.box_filter(torch.from_numpy(img), 3),)
    else:
        j = (jpyr.gaussian_blur(jnp.asarray(img), 1.5),)
        t = (tpyr.gaussian_blur(torch.from_numpy(img), 1.5),)
    for a, b in zip(t, j):
        assert rel_err(a.numpy(), b) <= 1e-6


@pytest.mark.parametrize("method", ["shi", "harris"])
def test_corner_score_matches_jax(rng, method):
    """Relative error (to the largest score) <= 1e-4."""
    img = synth_texture(rng, 96, 160)
    j = jharris.corner_score(jnp.asarray(img), window=3, method=method)
    t = tharris.corner_score(torch.from_numpy(img), window=3, method=method)
    assert rel_err(t.numpy(), j) <= 1e-4


@pytest.mark.parametrize("H,W,cells_topk,max_corners", [(128, 320, 4, 128), (160, 416, 8, 512),
                                                        (96, 128, 4, 100)])
def test_detect_corners_same_point_set(rng, H, W, cells_topk, max_corners):
    """The same set of valid points (top-k ties may order differently)."""
    img = synth_texture(rng, H, W)
    kw = dict(max_corners=max_corners, quality_level=0.03, cells_y=12, cells_x=32,
              cells_topk=cells_topk, border=12)
    jp, _, jv = jharris.detect_corners(jnp.asarray(img), **kw)
    tp, _, tv = tharris.detect_corners(torch.from_numpy(img), **kw)
    js = {tuple(p) for p in np.asarray(jp)[np.asarray(jv)].tolist()}
    ts = {tuple(p) for p in tp.numpy()[tv.numpy()].tolist()}
    assert len(js) > 10
    assert ts == js


def test_detect_corners_checkerboard():
    """A checkerboard scores many pixels exactly alike, so the two top-k orders pick
    different tied pixels: the port must find as many corners as the JAX package, all
    near a 16-px grid crossing (the check of tests/test_ops.py)."""
    H, W = 96, 128
    yy, xx = np.mgrid[0:H, 0:W]
    img = (((yy // 16) + (xx // 16)) % 2).astype(np.float32) * 255
    _, _, jv = jharris.detect_corners(jnp.asarray(img), max_corners=100, border=4)
    tp, _, tv = tharris.detect_corners(torch.from_numpy(img), max_corners=100, border=4)
    pts = tp.numpy()[tv.numpy()]
    assert len(pts) == int(np.sum(np.asarray(jv))) > 10
    d = np.abs((pts + 8) % 16 - 8)
    assert np.max(d) <= 3.5 and np.mean(d) < 2.5


def test_suppress_near_existing_matches_jax(rng):
    pts = rng.uniform(0, 100, size=(64, 2)).astype(np.float32)
    ex = rng.uniform(0, 100, size=(48, 2)).astype(np.float32)
    pv = rng.random(64) > 0.2
    ev = rng.random(48) > 0.3
    j = jharris.suppress_near_existing(jnp.asarray(pts), jnp.asarray(pv), jnp.asarray(ex),
                                       jnp.asarray(ev), 10.0)
    t = tharris.suppress_near_existing(torch.from_numpy(pts), torch.from_numpy(pv),
                                       torch.from_numpy(ex), torch.from_numpy(ev), 10.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _klt_case(name, rng):
    """Inputs of tests/test_ops.py:54-160 (pyramids, points, keyword arguments)."""
    if name == "zero_start":
        img = synth_texture(rng, 160, 224)
        nxt, levels = shifted(img, (3.4, -2.2)), 3
        pts = rng.uniform([40, 40], [180, 120], size=(64, 2))
        kw = dict(window=15, iters=10)
    elif name == "large_motion":
        img = synth_texture(rng, 192, 256, smooth=2.5)
        nxt, levels = shifted(img, (14.0, 9.0)), 4
        pts = rng.uniform([60, 60], [200, 140], size=(48, 2))
        kw = dict(window=15, iters=15)
    elif name == "bf16_iter":
        img = synth_texture(rng, 160, 224)
        nxt, levels = shifted(img, (3.4, -2.2)), 3
        pts = rng.uniform([40, 40], [180, 120], size=(64, 2))
        kw = dict(window=15, iters=10, iter_dtype="bfloat16")
    elif name == "init_d":
        img = synth_texture(rng, 192, 256, smooth=2.5)
        shift = (26.0, -3.0)
        nxt, levels = shifted(img, shift), 3
        pts = rng.uniform([50, 40], [190, 140], size=(48, 2))
        prior = np.tile([[shift[0] - 2.0, shift[1] + 1.5]], (48, 1)).astype(np.float32)
        kw = dict(window=15, iters=10, margin=3, init_d=prior)
    elif name == "level_margins":
        H, W = 192, 256
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        img = np.zeros((H, W), np.float32)
        pts = np.random.default_rng(5).uniform([60, 60], [190, 130], size=(12, 2))
        for cx, cy in pts:
            img += 200.0 * np.exp(-(((xx - cx) / 20.0) ** 2 + ((yy - cy) / 20.0) ** 2))
        nxt, levels = img, 3
        prior = np.tile([[38.0, 0.0]], (12, 1)).astype(np.float32)
        kw = dict(window=15, iters=8, margin=(6, 6, 8), init_d=prior)
    elif name == "pipeline_tracker":
        # the in-pipeline tracker's settings: warm start, coarse margin, iters_coarse
        img = synth_texture(rng, 160, 224)
        nxt, levels = shifted(img, (5.3, 1.1)), 3
        pts = rng.uniform([30, 30], [190, 130], size=(96, 2))
        prior = np.tile([[4.0, 0.0]], (96, 1)).astype(np.float32)
        kw = dict(window=15, iters=6, margin=(6, 6, 8), init_d=prior, iters_coarse=2)
    elif name == "flat":
        img = np.full((128, 128), 100.0, np.float32)
        nxt, levels = img, 3
        pts = np.array([[64.0, 64.0]])
        kw = dict(window=15, iters=5)
    return img.astype(np.float32), nxt.astype(np.float32), levels, pts.astype(np.float32), kw


@pytest.mark.parametrize("case", ["zero_start", "large_motion", "bf16_iter", "init_d",
                                  "level_margins", "pipeline_tracker", "flat"])
def test_pyramidal_klt_matches_jax(rng, case):
    """<= 1e-3 px on tracks both report as tracked; status agrees on >= 99%.

    The bf16 case stores the loop's blocks, template and gradients in bf16, and the two
    frameworks round the products' intermediates at different places: there the
    median stays <= 1e-3 px and the largest deviation <= 0.1 px (test_ops.py holds
    bf16 against f32 to 0.05 px at the 90th percentile)."""
    img, nxt, levels, pts, kw = _klt_case(case, rng)
    jp0 = jpyr.build_pyramid(jnp.asarray(img), levels)
    jp1 = jpyr.build_pyramid(jnp.asarray(nxt), levels)
    jkw = dict(kw)
    tkw = dict(kw)
    if "init_d" in kw:
        jkw["init_d"] = jnp.asarray(kw["init_d"])
        tkw["init_d"] = torch.from_numpy(kw["init_d"])
    jn, js, jr = jklt.pyramidal_klt(jp0, jp1, jnp.asarray(pts), **jkw)
    # the same pyramids on both sides, so the comparison isolates the tracker
    tp0 = tuple(torch.from_numpy(np.array(p)) for p in jp0)
    tp1 = tuple(torch.from_numpy(np.array(p)) for p in jp1)
    tn, ts, tr = tklt.pyramidal_klt(tp0, tp1, torch.from_numpy(pts), **tkw)
    js, ts = np.asarray(js), ts.numpy()
    assert np.mean(js == ts) >= 0.99
    both = js & ts
    if case != "flat":
        assert both.mean() > 0.5
    if both.any():
        d = np.abs(tn.numpy()[both] - np.asarray(jn)[both])
        if case == "bf16_iter":
            assert np.median(d) <= 1e-3 and d.max() <= 0.1
        else:
            assert d.max() <= 1e-3
    assert tr.shape == (len(pts),)

"""The port's SIFT frontend and descriptor matcher against the JAX package on the same
inputs (numpy arrays made from a seed), on the CPU.

Stated tolerances: scale-space levels <= 1e-5 absolute (values in [0, 1]); keypoint
sets agree on >= 98% within 1e-2 px, at the same sigma, with valid counts within 2%;
blocks and origins exact; orientation <= 1e-3 rad on >= 99%; descriptors <= 1e-4 per
element with the JAX package's keypoints carried across, <= 1e-3 L2 on >= 98% of the
matched keypoints of a whole ``sift()``; matcher ``ok`` identical and ``idx`` identical
where ``ok``. Top-k and argmax ties may resolve differently between the frameworks, so
keypoints are compared as sets and the inputs have no exact ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.frontend import match as jmatch
from lcvo_tpu.frontend import sift as jsift
from lcvo_tpu_torch.core import constants
from lcvo_tpu_torch.data.synthetic import value_noise
from lcvo_tpu_torch.frontend import match as tmatch
from lcvo_tpu_torch.frontend import sift as tsift


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


def blob_image(H=128, W=192, blobs=((40, 60, 3.0), (90, 140, 5.0), (30, 150, 2.5))):
    """Dark background with bright Gaussian blobs at (y, x, sigma)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W))
    for y, x, s in blobs:
        img += 200.0 * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def textured(H=160, W=160, seed=3):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    return (value_noise(xx * 0.08, yy * 0.08, seed, octaves=4) * 255.0).astype(np.float32)


IMAGES = {
    "blobs": lambda: blob_image(),
    "texture": lambda: textured(),
    "texture_odd": lambda: textured(101, 157, seed=5),
}


@pytest.fixture(scope="module", params=sorted(IMAGES))
def image(request):
    return request.param, IMAGES[request.param]()


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,sigma", [(7, 0.4), (33, 1.226), (64, 3.2), (19, 6.0)])
def test_gauss_band_matches_jax(n, sigma):
    """Band matrices are built by the same numpy code: equal, and every row sums to 1
    (the border rows are renormalised)."""
    m = tsift._gauss_band(n, sigma)
    np.testing.assert_array_equal(m, jsift._gauss_band(n, sigma))
    np.testing.assert_allclose(m.sum(1), 1.0, atol=1e-6)


def test_build_scale_space_matches_jax(image):
    name, img = image
    jsp = jsift.build_scale_space(jnp.asarray(img), 3, 3)
    tsp = tsift.build_scale_space(T(img), 3, 3)
    assert len(tsp) == 3
    for a, b in zip(jsp, tsp):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5, name


def test_scale_space_constants_are_cached_and_prepared_ahead():
    """prepare() builds the band matrices of every octave; build_scale_space then
    finds them and adds nothing."""
    tsift.prepare(40, 56, "cpu", octaves=2, scales_per_octave=3, patch_size=8)
    before = set(constants._CACHE)
    assert any(k[0][:2] == ("sift_band_y", 40) for k in before)
    assert any(k[0][:2] == ("sift_band_xT", 28) for k in before)
    assert any(k[0] == ("sift_patch_grid", 8) for k in before)
    tsift.build_scale_space(torch.zeros(40, 56), 2, 3)
    assert set(constants._CACHE) == before


def test_stack_gradients_match_jax(rng):
    st = rng.random((4, 9, 11)).astype(np.float32)
    for a, b in zip(jsift._stack_gradients(jnp.asarray(st)), tsift._stack_gradients(T(st))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------


def _partners(pa, pb, tol):
    """For each row of pa, whether pb holds a point within tol, and its index."""
    if len(pa) == 0 or len(pb) == 0:
        return np.zeros(len(pa), bool), np.zeros(len(pa), int)
    d = np.linalg.norm(pa[:, None, :] - pb[None, :, :], axis=-1)
    return d.min(1) <= tol, d.argmin(1)


def _check_keypoint_sets(jf, tf, k_oct, octaves, frac=0.98):
    """Per octave block: each side's valid keypoints have a partner on the other side
    within 1e-2 px at the same sigma; valid counts within 2%."""
    jv, tv = np.asarray(jf.valid), tf.valid.numpy()
    assert abs(int(jv.sum()) - int(tv.sum())) <= max(1, 0.02 * jv.sum())
    n = hits = 0
    for o in range(octaves):
        sl = slice(o * k_oct, (o + 1) * k_oct)
        ja = np.concatenate([np.asarray(jf.pts)[sl], np.asarray(jf.sigma)[sl, None]], 1)[jv[sl]]
        tb = np.concatenate([tf.pts.numpy()[sl], tf.sigma.numpy()[sl, None]], 1)[tv[sl]]
        for a, b in ((ja, tb), (tb, ja)):
            ok, j = _partners(a[:, :2], b[:, :2], 1e-2)
            same_sigma = np.zeros(len(a), bool)
            if len(b):
                same_sigma = np.abs(a[:, 2] - b[j, 2]) <= 1e-5 * a[:, 2]
            hits += int(np.sum(ok & same_sigma))
            n += len(a)
    assert n > 0 and hits >= frac * n, (hits, n)


def test_sift_detection_matches_jax(image):
    name, img = image
    kw = dict(max_keypoints=96, octaves=3, compute_desc=False)
    jf = jsift.sift(jnp.asarray(img), **kw)
    tf = tsift.sift(T(img), **kw)
    assert tf.pts.shape == (96, 2) and tf.desc.shape == (96, 128)
    assert float(tf.desc.abs().max()) == 0.0
    _check_keypoint_sets(jf, tf, 32, 3)
    # score is the |DoG| response, -inf on invalid rows
    assert torch.all(torch.isfinite(tf.score) == tf.valid)


@pytest.mark.parametrize("octave", [0, 1])
def test_detect_octave_matches_jax(octave):
    """One octave in isolation: same layer, position and response per keypoint."""
    img = textured()
    jst = jsift.build_scale_space(jnp.asarray(img), 2, 3)[octave]
    jxy, jli, jval, jvalid = jsift._detect_octave(jst, 48, 0.04, 10.0, 3, 8)
    txy, tli, tval, tvalid = tsift._detect_octave(T(np.asarray(jst)), 48, 0.04, 10.0, 3, 8)
    jv, tv = np.asarray(jvalid), tvalid.numpy()
    assert jv.sum() == tv.sum() and jv.sum() >= 10
    ja = np.concatenate([np.asarray(jxy), np.asarray(jli)[:, None], np.asarray(jval)[:, None]], 1)[jv]
    tb = np.concatenate([txy.numpy(), tli.numpy()[:, None], tval.numpy()[:, None]], 1)[tv]
    ok, j = _partners(ja[:, :2], tb[:, :2], 1e-3)
    assert ok.mean() >= 0.98
    np.testing.assert_array_equal(ja[ok, 2], tb[j[ok], 2])
    np.testing.assert_allclose(ja[ok, 3], tb[j[ok], 3], atol=1e-6)


# ---------------------------------------------------------------------------
# Blocks, orientation, descriptors: the JAX package's keypoints carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """Octave 0 of the textured image: the JAX package's stack, keypoints, gradient
    blocks and orientation, as numpy arrays."""
    img = textured()
    gstack = jsift.build_scale_space(jnp.asarray(img), 1, 3)[0]
    xy, li, _, valid = jsift._detect_octave(gstack, 64, 0.04, 10.0, 3, 8)
    S = min(59, gstack.shape[2])
    sig_rel = 1.6 * 2.0 ** (li.astype(jnp.float32) / 3)
    gx_st, gy_st = jsift._stack_gradients(gstack)
    gxB, ox, oy = jsift._extract_stack_blocks(gx_st, li, xy, S)
    gyB, _, _ = jsift._extract_stack_blocks(gy_st, li, xy, S)
    ori = jsift._orientation(gxB, gyB, ox, oy, xy, sig_rel, valid, S)
    out = dict(gstack=gstack, xy=xy, li=li, valid=valid, sig_rel=sig_rel, gx_st=gx_st,
               gy_st=gy_st, gxB=gxB, gyB=gyB, ox=ox, oy=oy, ori=ori)
    out = {k: np.asarray(v) for k, v in out.items()}
    assert out["valid"].sum() >= 40
    out["S"] = S
    return out


def _edge_keypoints(L, H, W, rng):
    """Keypoints the detector would not give: on the first and last rows of a layer,
    at x past both borders, in every layer."""
    xy = np.array([[5.3, 0.0], [W / 2, H - 1.0], [-7.5, 3.2], [W + 9.0, H - 2.5],
                   [0.0, 0.0], [W - 1.0, H - 1.0], [W / 3, H / 2]], np.float32)
    xy = np.concatenate([xy, rng.uniform([0, 0], [W, H], size=(30, 2)).astype(np.float32)])
    li = rng.integers(0, L, size=len(xy)).astype(np.int32)
    li[:6] = [0, L - 1, 0, L - 1, L - 1, 0]
    return xy, li


@pytest.mark.parametrize("shape,S", [((6, 40, 70), 21), ((6, 33, 59), 59), ((5, 64, 64), 30)],
                         ids=["S21", "S_eq_W", "even_S"])
def test_extract_stack_blocks_exact(rng, shape, S):
    """Blocks and origins equal the JAX package's exactly, on random stacks with
    keypoints on the first and last rows of a layer and x past both borders; N = 37 is
    not a multiple of 8 (the JAX side fills its centers up, the port does not)."""
    L, H, W = shape
    st = rng.random(shape).astype(np.float32)
    xy, li = _edge_keypoints(L, H, W, rng)
    jB, jox, joy = jsift._extract_stack_blocks(jnp.asarray(st), jnp.asarray(li), jnp.asarray(xy), S)
    tB, tox, toy = tsift._extract_stack_blocks(T(st), T(li).long(), T(xy), S)
    assert tuple(tB.shape) == (len(xy), S, S)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    np.testing.assert_array_equal(tox.numpy(), np.asarray(jox))
    np.testing.assert_array_equal(toy.numpy(), np.asarray(joy))
    # a block never crosses into a neighbouring layer: it equals the layer's own
    # edge-replicated rows
    n = 1  # keypoint on the last row of the last layer
    oy, ox = int(toy[n]), int(tox[n])
    rows = np.clip(np.arange(oy, oy + S), 0, H - 1)
    np.testing.assert_array_equal(tB[n].numpy(), st[li[n]][rows][:, ox: ox + S])


def test_extract_stack_blocks_on_detected_keypoints_exact(carried):
    c = carried
    for name in ("gx_st", "gy_st"):
        tB, tox, toy = tsift._extract_stack_blocks(T(c[name]), T(c["li"]).long(), T(c["xy"]),
                                                   c["S"])
        np.testing.assert_array_equal(tB.numpy(), c["gxB" if name == "gx_st" else "gyB"])
        np.testing.assert_array_equal(tox.numpy(), c["ox"])
        np.testing.assert_array_equal(toy.numpy(), c["oy"])


def test_sample_blocks_equals_the_weight_products(rng):
    """The port reads four pixels per sample; the JAX package multiplies by two-tap
    weight rows. Same bilinear value (<= 1e-6), with positions past the block edge
    clamped alike."""
    N, K, S = 9, 40, 17
    B = rng.random((N, S, S)).astype(np.float32)
    qx = rng.uniform(-3, S + 2, size=(N, K)).astype(np.float32)
    qy = rng.uniform(-3, S + 2, size=(N, K)).astype(np.float32)
    (j,) = jsift._sample_blocks_nk([jnp.asarray(B)], jnp.asarray(qx), jnp.asarray(qy), S)
    (t,) = tsift._sample_blocks_nk([T(B)], T(qx), T(qy), S)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_orientation_matches_jax(carried):
    c = carried
    ori = tsift._orientation(T(c["gxB"]), T(c["gyB"]), T(c["ox"]), T(c["oy"]), T(c["xy"]),
                             T(c["sig_rel"]), T(c["valid"]), c["S"]).numpy()
    v = c["valid"]
    d = np.abs(ori - c["ori"])
    d = np.minimum(d, 2 * np.pi - d)[v]
    assert np.mean(d <= 1e-3) >= 0.99, d.max()
    assert np.all(ori[~v] == 0.0)


def test_describe_matches_jax(carried):
    c = carried
    args = [c[k] for k in ("gxB", "gyB", "ox", "oy", "xy", "sig_rel", "ori", "valid")]
    jd = np.asarray(jsift._describe(*[jnp.asarray(a) for a in args], c["S"]))
    td = tsift._describe(*[T(a) for a in args], c["S"]).numpy()
    assert td.shape == (64, 128)
    assert np.abs(td - jd).max() <= 1e-4
    v = c["valid"]
    np.testing.assert_allclose(np.linalg.norm(td[v], axis=1), 1.0, atol=1e-5)
    assert np.all(td[~v] == 0.0)


@pytest.mark.parametrize("P", [16, 8])
def test_describe_patch_matches_jax(carried, P):
    """P = 16 mean-pools 256 samples to 128 dims, P = 8 zero-pads 64."""
    c = carried
    li, xy = c["li"], c["xy"]
    jB, jox, joy = jsift._extract_stack_blocks(jnp.asarray(c["gstack"]), jnp.asarray(li),
                                               jnp.asarray(xy), c["S"])
    tB, tox, toy = tsift._extract_stack_blocks(T(c["gstack"]), T(li).long(), T(xy), c["S"])
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    rest = [c[k] for k in ("xy", "sig_rel", "ori", "valid")]
    jd = np.asarray(jsift._describe_patch(jB, jox, joy, *[jnp.asarray(a) for a in rest],
                                          c["S"], P))
    td = tsift._describe_patch(tB, tox, toy, *[T(a) for a in rest], c["S"], P).numpy()
    assert np.abs(td - jd).max() <= 1e-4


# ---------------------------------------------------------------------------
# sift() whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["sift", "patch"])
def test_sift_whole_matches_jax(image, method):
    """Keypoint sets as above; descriptors of matched keypoints <= 1e-3 L2 apart and
    orientations <= 1e-3 rad on >= 98%. On the blob image only the keypoint sets are
    held: a radially symmetric blob has a flat orientation histogram whose argmax is
    decided by rounding, on either side (an exact tie in exact arithmetic)."""
    name, img = image
    kw = dict(max_keypoints=96, octaves=3, desc_method=method)
    jf = jsift.sift(jnp.asarray(img), **kw)
    tf = tsift.sift(T(img), **kw)
    _check_keypoint_sets(jf, tf, 32, 3)
    if name == "blobs":
        return
    jv, tv = np.asarray(jf.valid), tf.valid.numpy()
    ok, j = _partners(np.asarray(jf.pts)[jv], tf.pts.numpy()[tv], 1e-2)
    dd = np.linalg.norm(np.asarray(jf.desc)[jv][ok] - tf.desc.numpy()[tv][j[ok]], axis=1)
    do = np.abs(np.asarray(jf.ori)[jv][ok] - tf.ori.numpy()[tv][j[ok]])
    do = np.minimum(do, 2 * np.pi - do)
    assert ok.sum() >= 3
    assert np.mean(dd <= 1e-3) >= 0.98, (name, dd.max())
    assert np.mean(do <= 1e-3) >= 0.98, (name, do.max())


def test_sift_pads_to_capacity():
    """max_keypoints not a multiple of the octave count: the tail rows are invalid."""
    f = tsift.sift(T(textured(96, 96)), max_keypoints=50, octaves=3)
    assert f.pts.shape == (50, 2) and f.desc.shape == (50, 128) and f.valid.shape == (50,)
    assert not bool(f.valid[48:].any()) and bool(torch.all(f.score[48:] == float("-inf")))


# the behavioural tests of tests/test_sift.py, on the port


def test_port_sift_detects_blobs():
    blobs = ((40, 60, 3.0), (90, 140, 5.0), (30, 150, 2.5))
    f = tsift.sift(T(blob_image(blobs=blobs)), max_keypoints=96, octaves=3)
    pts = f.pts.numpy()[f.valid.numpy()]
    assert pts.shape[0] >= len(blobs)
    for y, x, s in blobs:
        d = np.sqrt(((pts - [x, y]) ** 2).sum(1)).min()
        assert d < 2.0, f"blob at ({x},{y}) missed by {d:.2f}px"


def test_port_sift_scale_assignment():
    f = tsift.sift(T(blob_image(blobs=((64, 96, 6.0),))), max_keypoints=96, octaves=4)
    pts = f.pts.numpy()[f.valid.numpy()]
    sig = f.sigma.numpy()[f.valid.numpy()]
    d = np.sqrt(((pts - [96, 64]) ** 2).sum(1))
    i = d.argmin()
    assert d[i] < 2.0
    assert 2.0 < sig[i] < 14.0


@pytest.mark.parametrize("method,min_matches,min_good", [("sift", 20, 0.8), ("patch", 15, 0.7)])
def test_port_descriptor_rotation_matching(method, min_matches, min_good):
    """Descriptors must match under a 90-degree rotation of the scene."""
    img = textured()
    W = img.shape[1]
    rot = np.rot90(img).copy()  # (x, y) -> (y, W-1-x)
    f0 = tsift.sift(T(img), max_keypoints=192, octaves=3, desc_method=method)
    f1 = tsift.sift(T(rot), max_keypoints=192, octaves=3, desc_method=method)
    n = np.linalg.norm(f0.desc.numpy()[f0.valid.numpy()], axis=1)
    np.testing.assert_allclose(n, 1.0, atol=1e-4)
    idx, ok = tmatch.mutual_match(f0.desc, f0.valid, f1.desc, f1.valid, ratio=0.8)
    ok = ok.numpy()
    assert ok.sum() >= min_matches
    p0 = f0.pts.numpy()[ok]
    p1 = f1.pts.numpy()[idx.numpy()[ok]]
    exp = np.stack([p0[:, 1], W - 1 - p0[:, 0]], axis=1)
    err = np.sqrt(((p1 - exp) ** 2).sum(1))
    assert (err < 3.0).mean() > min_good


# ---------------------------------------------------------------------------
# Matcher
# ---------------------------------------------------------------------------


def _descriptors(rng, nq, nt, invalid_q=0, invalid_t=0, all_t_invalid=False):
    """Random unit descriptors; the first min(nq, nt) targets are noisy copies of the
    queries in a shuffled order, so that some pass the ratio test and some do not."""
    q = rng.normal(size=(nq, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(nt, 128)).astype(np.float32)
    m = min(nq, nt)
    t[:m] = q[:m] + rng.uniform(0.02, 0.5, size=(m, 1)).astype(np.float32) * t[:m]
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t = t[rng.permutation(nt)]
    vq = np.ones(nq, bool)
    vt = np.ones(nt, bool)
    vq[rng.choice(nq, invalid_q, replace=False)] = False
    vt[rng.choice(nt, invalid_t, replace=False)] = False
    if all_t_invalid:
        vt[:] = False
    return q, vq, t, vt


MATCH_CASES = {
    "square": dict(nq=60, nt=60),
    "more_queries": dict(nq=80, nt=45),
    "more_targets": dict(nq=37, nt=90),
    "invalid_rows": dict(nq=64, nt=70, invalid_q=9, invalid_t=13),
    "all_targets_invalid": dict(nq=20, nt=30, all_t_invalid=True),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_knn_match_ratio_matches_jax(rng, case):
    q, vq, t, vt = _descriptors(rng, **MATCH_CASES[case])
    jidx, jok = jmatch.knn_match_ratio(jnp.asarray(q), jnp.asarray(vq), jnp.asarray(t),
                                       jnp.asarray(vt), ratio=0.8)
    tidx, tok = tmatch.knn_match_ratio(T(q), T(vq), T(t), T(vt), ratio=0.8)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(tidx.numpy()[jok], np.asarray(jidx)[jok])
    assert tidx.shape == (len(q),) and tok.dtype == torch.bool
    if case == "all_targets_invalid":
        assert not tok.any()
    else:
        assert 0 < jok.sum() < vq.sum()      # the ratio test both passes and rejects
        assert not tok.numpy()[~vq].any()


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_mutual_match_matches_jax(rng, case):
    q, vq, t, vt = _descriptors(rng, **MATCH_CASES[case])
    jidx, jok = jmatch.mutual_match(jnp.asarray(q), jnp.asarray(vq), jnp.asarray(t),
                                    jnp.asarray(vt), ratio=0.8)
    tidx, tok = tmatch.mutual_match(T(q), T(vq), T(t), T(vt), ratio=0.8)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(tidx.numpy()[jok], np.asarray(jidx)[jok])
    # a mutual match points at a valid target
    assert vt[tidx.numpy()[jok]].all()


def test_port_knn_ratio_match_synthetic():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(40, 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    noisy = base + 0.05 * rng.normal(size=base.shape).astype(np.float32)
    noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)
    perm = rng.permutation(40)
    ones = torch.ones(40, dtype=torch.bool)
    idx, ok = tmatch.knn_match_ratio(T(base), ones, T(noisy[perm]), ones, ratio=0.8)
    idx, ok = idx.numpy(), ok.numpy()
    inv = np.empty(40, int)
    inv[perm] = np.arange(40)
    assert ok.mean() > 0.9
    assert (idx[ok] == inv[ok]).all()


def test_port_knn_ratio_rejects_ambiguous():
    """Two identical targets: best == second best, so the ratio test rejects."""
    q = torch.ones((1, 128))
    t = torch.ones((2, 128))
    _, ok = tmatch.knn_match_ratio(q, torch.ones(1, dtype=torch.bool), t,
                                   torch.ones(2, dtype=torch.bool))
    assert not bool(ok[0])

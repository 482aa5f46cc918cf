"""The port's kernels against OpenCV's on synthetic scenes (counterparts of
``tests/test_opencv_golden.py``, with its tolerances): KLT, essential matrix + pose,
PnP, triangulation, SIFT keypoints, SIFT descriptor matches and Shi-Tomasi corners.
OpenCV is the oracle here, never a dependency of the port; the tests skip where it is
not installed. Tolerances are behavioural (same tracks, inliers and poses within
noise), not bitwise."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from lcvo_tpu_torch.core import geometry as geo  # noqa: E402
from lcvo_tpu_torch.ops import epipolar, harris, klt, pnp, pyramid  # noqa: E402
from lcvo_tpu_torch.utils import jax_random  # noqa: E402


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def synth_texture(rng, H, W, smooth=1.5):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = int(3 * smooth) | 1
    img = cv2.GaussianBlur(img, (k, k), smooth)
    return (img - img.min()) * (255.0 / (img.max() - img.min()))


def test_klt_matches_opencv(rng):
    img = synth_texture(rng, 240, 320, smooth=2.0)
    shift = (7.3, -4.6)
    M = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    nxt = cv2.warpAffine(img, M, (320, 240))

    pts = rng.uniform([40, 40], [280, 200], (64, 2)).astype(np.float32)
    cv_pts, cv_st, _ = cv2.calcOpticalFlowPyrLK(
        img.astype(np.uint8), nxt.astype(np.uint8), pts.reshape(-1, 1, 2), None,
        winSize=(21, 21), maxLevel=2)
    cv_pts = cv_pts.reshape(-1, 2)
    cv_st = cv_st.reshape(-1).astype(bool)

    pyr0 = pyramid.build_pyramid(T(img), 3)
    pyr1 = pyramid.build_pyramid(T(nxt), 3)
    our_pts, our_st, _ = klt.pyramidal_klt(pyr0, pyr1, T(pts), window=21, iters=10)
    our_pts = our_pts.numpy()
    our_st = our_st.numpy()

    both = cv_st & our_st
    assert both.mean() > 0.7
    d = np.abs(our_pts[both] - cv_pts[both])
    assert np.percentile(d, 90) < 0.35, f"90pct deviation vs OpenCV {np.percentile(d, 90):.3f}px"


def _two_view_scene(rng, n=120, noise=0.3, fx=500.0):
    K = np.array([[fx, 0, 320], [0, fx, 240], [0, 0, 1]])
    X = rng.uniform([-4, -2, 6], [4, 2, 16], (n, 3))
    R = cv2.Rodrigues(np.array([0.02, -0.04, 0.01]))[0]
    t = np.array([0.6, 0.05, 0.1])
    uv1 = (K @ X.T).T
    uv1 = uv1[:, :2] / uv1[:, 2:]
    Xc = (R @ X.T).T + t
    uv2 = (K @ Xc.T).T
    uv2 = uv2[:, :2] / uv2[:, 2:]
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    return K, R, t, X, uv1.astype(np.float32), uv2.astype(np.float32)


def _uniforms(seed, shape):
    """The uniforms of ``jax.random.PRNGKey(seed)``: a draw of the JAX package's stream."""
    return torch.from_numpy(jax_random.uniform(jax_random.PRNGKey(seed), shape))


def test_essential_pose_matches_opencv(rng):
    K, R_gt, t_gt, X, uv1, uv2 = _two_view_scene(rng)
    E_cv, _ = cv2.findEssentialMat(uv1, uv2, K, method=cv2.RANSAC, prob=0.999, threshold=1.0)
    _, R_cv, t_cv, _ = cv2.recoverPose(E_cv, uv1, uv2, K)

    Kt = T(K)
    x1 = geo.normalize_points(T(uv1), Kt)
    x2 = geo.normalize_points(T(uv2), Kt)
    E, inl, n_inl = epipolar.essential_ransac(
        _uniforms(0, (256, 8)), x1, x2, torch.ones(len(uv1), dtype=torch.bool),
        thresh=1.0 / 500, n_hyp=256)
    R_o, t_o, _ = epipolar.recover_pose(E, x1, x2, inl)
    R_o = R_o.numpy()
    t_o = t_o.numpy()

    # both recover the true rotation and translation direction (0.3 px of noise over a
    # 0.6 m baseline leaves a few degrees of direction; OpenCV lands ~3 deg off here)
    for name, Rx, tx in (("opencv", R_cv, t_cv.reshape(-1)), ("ours", R_o, t_o)):
        ang = np.degrees(np.arccos(np.clip((np.trace(Rx @ R_gt.T) - 1) / 2, -1, 1)))
        assert ang < 0.5, f"{name} rotation off by {ang:.2f} deg"
        cos = abs(np.dot(tx / np.linalg.norm(tx), t_gt / np.linalg.norm(t_gt)))
        assert cos > np.cos(np.radians(5.0)), f"{name} direction off: cos={cos:.5f}"


def test_pnp_matches_opencv(rng):
    K, R_gt, t_gt, X, uv1, uv2 = _two_view_scene(rng, noise=0.2)
    n_out = len(uv2) * 15 // 100   # 15% of the observations corrupted
    uv2c = uv2.copy()
    uv2c[:n_out] += rng.uniform(15, 40, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))

    okcv, rvec, tvec, inl_cv = cv2.solvePnPRansac(
        X.astype(np.float32), uv2c.reshape(-1, 1, 2), K, None,
        reprojectionError=2.0, confidence=0.99999, flags=cv2.SOLVEPNP_ITERATIVE)
    R_cv = cv2.Rodrigues(rvec)[0]

    x_obs = geo.normalize_points(T(uv2c), T(K))
    R_o, t_o, inl_o, n_inl = pnp.pnp_ransac(
        _uniforms(1, (256, 3)), T(X), x_obs, torch.ones(len(X), dtype=torch.bool),
        thresh=2.0 / 500, n_hyp=256)

    for Rx, tx in ((R_cv, tvec.reshape(-1)), (R_o.numpy(), t_o.numpy())):
        ang = np.degrees(np.arccos(np.clip((np.trace(Rx @ R_gt.T) - 1) / 2, -1, 1)))
        assert ang < 0.5
        assert np.linalg.norm(tx - t_gt) < 0.05
    # the inlier sets agree on the clean points
    assert inl_o.numpy()[n_out:].mean() > 0.9
    assert int(n_inl) >= len(inl_cv) - 10


def test_triangulation_matches_opencv(rng):
    K, R_gt, t_gt, X, uv1, uv2 = _two_view_scene(rng, noise=0.0)
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R_gt, t_gt.reshape(3, 1)])
    Xh = cv2.triangulatePoints(P1, P2, uv1.T, uv2.T)
    X_cv = (Xh[:3] / Xh[3]).T

    Kt = T(K)
    x1 = geo.normalize_points(T(uv1), Kt)
    x2 = geo.normalize_points(T(uv2), Kt)
    X_o = geo.triangulate_linear(torch.eye(3), torch.zeros(3), T(R_gt), T(t_gt), x1, x2).numpy()
    np.testing.assert_allclose(X_o, X_cv, atol=2e-2)
    np.testing.assert_allclose(X_o, X, atol=2e-2)


def _octave_of(kp):
    o = kp.octave & 255
    return o - 256 if o >= 128 else o


def test_sift_keypoints_match_opencv(rng):
    """On textured content the port's detector recovers the bulk of cv2.SIFT's
    keypoints in its octave range (it has no 2x-upsampled octave, as the JAX package),
    with consistent scale and orientation."""
    from lcvo_tpu_torch.frontend.sift import sift as our_sift

    img = synth_texture(rng, 240, 320, smooth=1.5)
    s = cv2.SIFT_create(nfeatures=300)
    kps = s.detect(img.astype(np.uint8), None)
    arr = np.array([(kp.pt[0], kp.pt[1], kp.size / 2, kp.angle) for kp in kps])
    octs = np.array([_octave_of(kp) for kp in kps])
    cvk = arr[octs >= 0]
    assert len(cvk) >= 20, "oracle found too few octave>=0 keypoints"

    f = our_sift(T(img), max_keypoints=512, octaves=3)
    v = f.valid.numpy()
    ours = f.pts.numpy()[v]
    osig = f.sigma.numpy()[v]
    oori = f.ori.numpy()[v]

    d = np.linalg.norm(cvk[:, None, :2] - ours[None, :, :], axis=-1)
    nn, dm = d.argmin(1), d.min(1)
    recall = (dm < 2.0).mean()
    assert recall > 0.6, f"keypoint recall@2px vs cv2.SIFT only {recall:.0%}"

    m = dm < 2.0
    ratio = np.median(osig[nn[m]] / cvk[m, 2])
    assert 0.7 < ratio < 1.4, f"scale ratio vs cv2.SIFT off: {ratio:.2f}"
    dth = np.degrees(np.angle(np.exp(1j * (np.deg2rad(cvk[m, 3]) - oori[nn[m]]))))
    med = np.median(np.abs(dth))
    assert med < 15.0, f"median orientation delta vs cv2.SIFT {med:.1f} deg"


def test_sift_descriptor_match_overlap_vs_opencv(rng):
    """Under a known rotation + shift, the port's detect -> describe -> ratio-match
    chain gives a healthy number of matches, nearly all consistent with the warp, and
    a sane share of cv2's own chain on the same frames."""
    from lcvo_tpu_torch.frontend.match import mutual_match
    from lcvo_tpu_torch.frontend.sift import sift as our_sift

    img = synth_texture(rng, 240, 320, smooth=1.5)
    H, W = img.shape
    M = cv2.getRotationMatrix2D((W / 2, H / 2), 20.0, 1.0)
    M[:, 2] += [5.0, -3.0]
    warp = cv2.warpAffine(img, M, (W, H))

    def gt_map(p):
        return p @ M[:, :2].T + M[:, 2]

    f0 = our_sift(T(img), max_keypoints=512, octaves=3)
    f1 = our_sift(T(warp), max_keypoints=512, octaves=3)
    idx, ok = mutual_match(f0.desc, f0.valid, f1.desc, f1.valid, ratio=0.8)
    ok = ok.numpy()
    p0 = f0.pts.numpy()[ok]
    p1 = f1.pts.numpy()[idx.numpy()[ok]]
    err = np.linalg.norm(p1 - gt_map(p0), axis=1)
    assert ok.sum() >= 30, f"only {ok.sum()} ratio matches under warp"
    assert (err < 3.0).mean() > 0.85, f"match consistency {(err < 3.0).mean():.0%}"

    s = cv2.SIFT_create(nfeatures=512)
    k0, d0 = s.detectAndCompute(img.astype(np.uint8), None)
    k1, d1 = s.detectAndCompute(warp.astype(np.uint8), None)
    mm = cv2.BFMatcher().knnMatch(d0, d1, k=2)
    good = [m for m, n in mm if m.distance < 0.8 * n.distance]
    assert ok.sum() >= 0.2 * len(good), (ok.sum(), len(good))


def test_shi_tomasi_matches_opencv(rng):
    """A checkerboard: both detectors must find the interior corners.

    The JAX file's board (one grey level per colour) is the next test: its corner
    maxima tie, and which 96 are kept is a matter of rounding. Here each square gets its
    own level (from the test's seeded ``rng``), which leaves no ties: the port's corners
    must equal the JAX package's exactly, and recover the JAX file's share of OpenCV's."""
    import jax.numpy as jnp

    from lcvo_tpu.ops import harris as jharris

    H, W, sq = 200, 280, 28
    yy, xx = np.mgrid[0:H, 0:W]
    level = rng.uniform(-25, 25, (H // sq + 1, W // sq + 1))
    img = (((yy // sq) + (xx // sq)) % 2 * 180.0 + 30.0 + level[yy // sq, xx // sq]).astype(np.float32)
    img = cv2.GaussianBlur(img, (5, 5), 1.2)

    cv_pts = cv2.goodFeaturesToTrack(
        img.astype(np.uint8), maxCorners=60, qualityLevel=0.05, minDistance=10)
    cv_pts = cv_pts.reshape(-1, 2)
    # away from the frame: OpenCV's border is 3 px, the port's a setting (8 px here)
    margin = 12
    inb = ((cv_pts[:, 0] > margin) & (cv_pts[:, 0] < W - margin)
           & (cv_pts[:, 1] > margin) & (cv_pts[:, 1] < H - margin))
    cv_pts = cv_pts[inb]

    kw = dict(max_corners=96, quality_level=0.05, cells_y=8, cells_x=11, cells_topk=4,
              method="shi", window=3, border=8)
    pts, score, ok = harris.detect_corners(T(img), **kw)
    jpts, _, jok = jharris.detect_corners(jnp.asarray(img), **kw)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(pts.numpy()[ok.numpy()], np.asarray(jpts)[np.asarray(jok)])
    ours = pts.numpy()[ok.numpy()]

    d = np.linalg.norm(cv_pts[:, None, :] - ours[None, :, :], axis=-1).min(axis=1)
    assert (d < 3.0).mean() > 0.9, f"only {(d < 3.0).mean():.0%} of OpenCV corners recovered"


def _jax_file_board():
    H, W, sq = 200, 280, 28
    yy, xx = np.mgrid[0:H, 0:W]
    img = (((yy // sq) + (xx // sq)) % 2 * 180.0 + 30.0).astype(np.float32)
    return cv2.GaussianBlur(img, (5, 5), 1.2)


def test_shi_tomasi_on_the_jax_files_board_keeps_tied_maxima():
    """The JAX file's checkerboard, one grey level per colour. Every interior corner has
    the same Shi-Tomasi score up to rounding: 216 local maxima lie within 1e-4 of the
    highest, and nothing else comes near. Which 96 of them each package keeps is decided
    by the last bits of its arithmetic (the two score maps differ by ~3e-8 of their
    peak; XLA fuses the score into multiply-adds), so the two kept sets differ, and so
    does the share of OpenCV's corners each lies within 3 px of (the port 42 of 51, the
    JAX package 47 of 51 with cv2 5.0). What both must do: keep 96 corners, all from
    that tied set, with the same scores; and the tied set must hold the JAX file's share
    (> 0.9) of OpenCV's corners within 3 px."""
    import jax.numpy as jnp

    from lcvo_tpu.ops import harris as jharris

    img = _jax_file_board()
    H, W = img.shape
    cv_pts = cv2.goodFeaturesToTrack(
        img.astype(np.uint8), maxCorners=60, qualityLevel=0.05, minDistance=10).reshape(-1, 2)
    margin = 12
    inb = ((cv_pts[:, 0] > margin) & (cv_pts[:, 0] < W - margin)
           & (cv_pts[:, 1] > margin) & (cv_pts[:, 1] < H - margin))
    cv_pts = cv_pts[inb]

    kw = dict(max_corners=96, quality_level=0.05, cells_y=8, cells_x=11, cells_topk=4,
              method="shi", window=3, border=8)
    pts, score, ok = (t.numpy() for t in harris.detect_corners(T(img), **kw))
    jpts, jscore, jok = (np.asarray(t) for t in jharris.detect_corners(jnp.asarray(img), **kw))
    smap = harris.corner_score(T(img), window=3, method="shi").numpy()
    jsmap = np.asarray(jharris.corner_score(jnp.asarray(img), window=3, method="shi"))
    np.testing.assert_allclose(smap, jsmap, rtol=0, atol=1e-6 * float(jsmap.max()))

    # the tied set: local maxima inside the border within 1e-4 of the highest score
    border = kw["border"]
    yy, xx = np.mgrid[0:H, 0:W]
    inside = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    is_max = harris._local_max(T(jsmap)).numpy() & inside
    top = float(jsmap[is_max].max())
    tied = is_max & (jsmap >= top * (1 - 1e-4))
    assert not np.any(is_max & ~tied & (jsmap >= top * 0.5)), "no score between the tie and half"
    assert tied.sum() > kw["max_corners"], tied.sum()

    for name, p, s, k in (("port", pts, score, ok), ("jax", jpts, jscore, jok)):
        assert k.sum() == kw["max_corners"], (name, k.sum())
        xy = p[k].astype(int)
        assert np.all(tied[xy[:, 1], xy[:, 0]]), f"{name} kept a corner outside the tied set"
        np.testing.assert_allclose(s[k], top, rtol=1e-4)

    tied_xy = np.argwhere(tied)[:, ::-1].astype(np.float32)
    d = np.linalg.norm(cv_pts[:, None, :] - tied_xy[None, :, :], axis=-1).min(axis=1)
    assert (d < 3.0).mean() > 0.9, f"only {(d < 3.0).mean():.0%} of OpenCV corners in the tied set"

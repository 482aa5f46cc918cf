"""Essential-matrix estimation: batched RANSAC + cheirality pose recovery (port of
``lcvo_tpu/ops/epipolar.py``).

All hypotheses are solved in parallel: minimal 8-point sets → SVD right singular
vector → rank-2 projection → Sampson scoring of every hypothesis against
every correspondence (MSAC) → cheirality decomposition → Gauss-Newton polish on the
Sampson objective. Point inputs are normalized image coordinates; thresholds are
``thresh_px / fx``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from vo_bench.reference.core import geometry as geo
from vo_bench.reference.core.constants import on_device
from vo_bench.reference.ops import ransac
from vo_bench.reference.ops import svd as svd_mod


# made on the device once (a host copy inside a step cannot be captured into a graph)
_RANK2 = np.array([1.0, 1.0, 0.0], np.float32)
_W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
_EX = np.array([1.0, 0, 0], np.float32)
_EY = np.array([0.0, 1, 0], np.float32)


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], dim=-1)


def eight_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None):
    """Least-squares essential/fundamental fit from correspondences.

    x1, x2: (..., N, 2) normalized coords with x2^T E x1 = 0; optional weights (..., N).
    Returns E (..., 3, 3), not yet projected to rank 2.

    The vector taken is the LAST row of the thin SVD's Vh, as in the JAX package. For a
    minimal (8, 9) system the thin Vh is (8, 9), so that row is the 8th right singular
    vector, not the null vector (ROADMAP §C). RANSAC and the Sampson polish downstream
    are tuned around it, so the port keeps it.
    """
    h1 = _homogeneous(x1)
    h2 = _homogeneous(x2)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*h1.shape[:-1], 9)
    if w is not None:
        A = A * w[..., None]
    _, _, Vh = svd_mod.svd(A, full_matrices=False, site="eight_point")
    e = Vh[..., -1, :]
    return e.reshape(*e.shape[:-1], 3, 3)


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values → (1, 1, 0)."""
    U, _, Vh = svd_mod.svd(E, site="project_to_essential")
    d = on_device(_RANK2, E.device).to(E.dtype)
    return U @ (d[:, None] * Vh)


def decompose_essential(E: torch.Tensor):
    """E → four (R, t) candidates (cam1→cam2), ||t|| = 1. Returns R (4,3,3), t (4,3)."""
    U, _, Vh = svd_mod.svd(E, site="decompose_essential")
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = on_device(_W, E.device).to(E.dtype)
    Ra = U @ W @ Vh
    Rb = U @ W.T @ Vh
    u3 = U[..., :, 2]
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([u3, -u3, u3, -u3])


def recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor):
    """Cheirality-disambiguated pose from E: triangulate under all 4 decompositions and
    pick the one with the most points in front of both cameras.

    Returns (R (3,3), t (3,), n_good) with pose cam1→cam2 (x2 = R x1 + t)."""
    R4, t4 = decompose_essential(E)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    zero = torch.zeros((3,), dtype=E.dtype, device=E.device)
    counts = []
    for i in range(4):
        X = geo.triangulate_linear(eye, zero, R4[i], t4[i], x1, x2)
        z2 = geo.se3_apply(R4[i], t4[i], X)[..., 2]
        counts.append(torch.sum((X[..., 2] > 0) & (z2 > 0) & valid))
    counts = torch.stack(counts)
    best = torch.argmax(counts)
    return ransac.take(R4, best), ransac.take(t4, best), ransac.take(counts, best)


def _sampson_residuals(E, h1, h2):
    """Signed first-order geometric (Sampson) residuals, (N,)."""
    Eh1 = h1 @ E.T
    Eth2 = h2 @ E
    s = torch.sum(h2 * Eh1, dim=-1)
    g = Eh1[:, 0] ** 2 + Eh1[:, 1] ** 2 + Eth2[:, 0] ** 2 + Eth2[:, 1] ** 2
    return s / torch.sqrt(torch.clamp(g, min=1e-12))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v), min=1e-12)


def refine_pose_sampson(R, t, x1, x2, w, iters: int = 8, damping: float = 1e-8):
    """Gauss-Newton polish of a relative pose on the essential manifold: weighted
    Sampson error over 5 dof (rotation tangent + unit-translation tangent). The
    Jacobian is forward-mode autodiff of the residual vector (``torch.func.jacfwd``)."""
    h1 = _homogeneous(x1)
    h2 = _homogeneous(x2)
    ex = on_device(_EX, t.device).to(t.dtype)
    ey = on_device(_EY, t.device).to(t.dtype)
    eye5 = torch.eye(5, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        t = _unit(t)
        # orthonormal basis of the tangent plane at t
        a = torch.where(torch.abs(t[0]) < 0.9, ex, ey)
        b1 = _unit(torch.linalg.cross(t, a))
        b2 = torch.linalg.cross(t, b1)

        def residuals(p, R=R, t=t, b1=b1, b2=b2):
            Rp = geo.rodrigues(p[:3]) @ R
            tp = _unit(t + b1 * p[3] + b2 * p[4])
            return w * _sampson_residuals(geo.hat(tp) @ Rp, h1, h2)

        p0 = torch.zeros((5,), dtype=R.dtype, device=R.device)
        r = residuals(p0)
        J = jacfwd(residuals)(p0)  # (N, 5)
        delta = -torch.linalg.solve_ex(J.T @ J + damping * eye5, J.T @ r)[0]
        R = geo.rodrigues(delta[:3]) @ R
        t = _unit(t + b1 * delta[3] + b2 * delta[4])
    return R, t


def draw_shape(n_hyp: int, solver: str) -> tuple[int, int]:
    """The shape of :func:`essential_ransac`'s minimal sets, and of the uniforms they
    are drawn from: ``(n_hyp, 8)`` for eight-point, ``(max(n_hyp // 10, 1), 5)`` for
    five-point."""
    return (max(n_hyp // 10, 1), 5) if solver == "five_point" else (n_hyp, 8)


def essential_ransac(
    u: torch.Tensor | None,
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    n_hyp: int = 512,
    solver: str = "eight_point",
    idx: torch.Tensor | None = None,
):
    """Robust essential matrix from normalized correspondences.

    Returns (E (3,3), inliers (N,) bool, n_inliers). ``thresh`` is the Sampson distance
    threshold in normalized units (pixel_thresh / fx). ``solver``: the minimal solver,
    "eight_point" (batched DLT) only; the port's "five_point" has no cell. ``u``: the
    uniforms of the draw's ``jax.random`` key, of
    :func:`draw_shape`, from which the minimal sets are drawn as the JAX package draws
    them; ``idx`` of the same shape injects the minimal sets instead.
    """
    N = x1.shape[0]
    h1 = _homogeneous(x1)
    h2 = _homogeneous(x2)
    if solver == "eight_point":
        if idx is None:
            idx = ransac.sample_minimal_sets(u, N, valid)  # (H, 8)
        E_h = project_to_essential(eight_point(x1[idx], x2[idx]))      # (H, 3, 3)
        err = geo.sampson_error(E_h, h1, h2)                            # (H, N)
    else:
        # five-point (configs/reference.yaml) has no cell: its copy comes with one
        raise ValueError(f"the reference has no essential solver {solver!r}")
    thr2 = thresh * thresh
    score, _ = ransac.msac_score(err, valid, thr2)
    E_best = ransac.take(E_h, ransac.best_hypothesis(score))
    inl = (geo.sampson_error(E_best, h1, h2) < thr2) & valid

    # nonlinear polish on the inliers: cheirality decomposition, Gauss-Newton on the
    # Sampson objective, rebuild E; keep the refit only if it didn't lose inliers
    R0, t0, _ = recover_pose(E_best, x1, x2, inl)
    Rr, tr = refine_pose_sampson(R0, t0, x1, x2, inl.to(x1.dtype))
    E_ref = geo.hat(tr) @ Rr
    inl_ref = (geo.sampson_error(E_ref, h1, h2) < thr2) & valid
    use_ref = torch.sum(inl_ref) >= torch.sum(inl)
    E_out = torch.where(use_ref, E_ref, E_best)
    inl_out = torch.where(use_ref, inl_ref, inl)
    return E_out, inl_out, torch.sum(inl_out)

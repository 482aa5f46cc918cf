"""Batched geometry primitives (port of ``lcvo_tpu/core/geometry.py``).

Pose convention: poses are **world→camera** extrinsics ``T_cw = [R | t]`` with
``x_cam = R @ x_world + t``; the camera center in world coordinates is ``-R^T t``.
Everything is batched over leading dimensions; no Python loops over points.
"""

from __future__ import annotations

import math

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x for w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) → rotation matrix (..., 3, 3), sinc-stable at 0."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)[..., None]  # (...,1,1)
    theta = torch.sqrt(theta2 + 1e-24)
    W = hat(rvec)
    W2 = W @ W
    a = torch.sinc(theta / math.pi)            # sin(theta)/theta
    b = torch.where(theta2 > 1e-12, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24),
                    torch.full_like(theta2, 0.5))
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(W.shape)
    return eye + a * W + b * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → rotation vector (..., 3). Stable near 0."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)[..., None]
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    # w = 2 sin(theta) * axis ; scale = theta / (2 sin theta), sinc-stable
    s = torch.where(theta > 1e-6, theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12), 0.5)
    return s * w


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [w,x,y,z] → rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def se3_compose(Ra, ta, Rb, tb):
    """T_a ∘ T_b : first apply T_b, then T_a. Returns (R, t)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_matrix(R, t):
    """(R (...,3,3), t (...,3)) → homogeneous (...,4,4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_apply(R, t, X):
    """Apply world→camera transform to points X (..., 3)."""
    return (R @ X[..., None])[..., 0] + t


def camera_center(R, t):
    """Camera center in world coordinates: -R^T t."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def _guard(z: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(z) > eps, z, torch.full_like(z, eps))


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """Project world points X (N, 3) with pose (R, t) and intrinsics K (3, 3).

    Returns (uv (N, 2), depth (N,)). Points behind the camera get negative depth."""
    Xc = se3_apply(R, t, X)
    z = Xc[..., 2]
    zs = _guard(z, 1e-8)
    x = Xc[..., 0] / zs
    y = Xc[..., 1] / zs
    u = K[0, 0] * x + K[0, 1] * y + K[0, 2]
    v = K[1, 1] * y + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def backproject(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords (N, 2) → unit-z camera rays (N, 3): K^-1 [u, v, 1]^T."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    # as the JAX package's compiled steps compute it: K is a constant there, and XLA's
    # algebraic simplifier turns a division by a constant into a product with its
    # reciprocal, which rounds otherwise in the last bit (enough to swap the winner of an
    # eight-point MSAC, whose hypotheses are ill-conditioned: ROADMAP §C, quirk 2)
    y = (uv[..., 1] - cy) * torch.reciprocal(fy)
    x = (uv[..., 0] - cx - s * y) * torch.reciprocal(fx)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def normalize_points(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels → normalized image coordinates (x, y) with z=1 dropped."""
    return backproject(K, uv)[..., :2]


def essential_from_pose(R, t):
    """E = [t]_x R for relative pose (cam1→cam2: x2 = R x1 + t)."""
    tn = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return hat(tn) @ R


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared first-order geometric (Sampson) error of E (..., 3, 3) for homogeneous
    normalized points x1, x2 (N, 3). Returns (..., N)."""
    Ex1 = torch.einsum("...ij,nj->...ni", E, x1)
    Etx2 = torch.einsum("...ji,nj->...ni", E, x2)
    x2Ex1 = torch.einsum("ni,...ni->...n", x2, Ex1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return (x2Ex1 * x2Ex1) / torch.clamp(denom, min=1e-12)


def triangulate_linear(R1, t1, R2, t2, x1, x2):
    """Batched linear (DLT) triangulation in normalized coordinates.

    x1, x2: (N, 2) normalized coords seen by cameras (R1, t1), (R2, t2) (world→camera;
    shared (3, 3)/(3,) or per-point (N, 3, 3)/(N, 3)). Returns X (N, 3) world points.
    Solves the normal equations (BᵀB) X = −Bᵀb of A = [B | b] with a closed-form 3x3
    adjugate; near-singular (zero-parallax) systems map to huge depths, which the
    callers' depth and reprojection gates reject.
    """
    P1 = torch.cat([R1, t1[..., None]], dim=-1)  # (..., 3, 4)
    P2 = torch.cat([R2, t2[..., None]], dim=-1)

    def rows(P, x):
        r0 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    r0a, r1a = rows(P1, x1)
    r0b, r1b = rows(P2, x2)
    A = torch.stack(torch.broadcast_tensors(r0a, r1a, r0b, r1b), dim=-2)  # (N, 4, 4)
    B = A[..., :3]
    b = A[..., 3]
    H = torch.einsum("...ki,...kj->...ij", B, B)            # (N, 3, 3) symmetric
    g = -torch.einsum("...ki,...k->...i", B, b)             # (N, 3)
    h0, h1, h2 = H[..., 0, :], H[..., 1, :], H[..., 2, :]
    c12 = torch.linalg.cross(h1, h2)
    det = torch.sum(h0 * c12, dim=-1)
    adj = torch.stack([c12, torch.linalg.cross(h2, h0), torch.linalg.cross(h0, h1)], dim=-1)
    tiny = torch.where(det < 0, torch.full_like(det, -1e-12), torch.full_like(det, 1e-12))
    safe_det = torch.where(torch.abs(det) > 1e-12, det, tiny)
    return torch.einsum("...ij,...j->...i", adj, g) / safe_det[..., None]


def bearing_angle(R1, t1, R2, t2, uv1, uv2, K):
    """True parallax angle (radians) between the two world-frame viewing rays."""
    r1 = backproject(K, uv1)
    r2 = backproject(K, uv2)
    w1 = (R1.transpose(-1, -2) @ r1[..., None])[..., 0]
    w2 = (R2.transpose(-1, -2) @ r2[..., None])[..., 0]
    w1 = w1 / torch.clamp(torch.linalg.norm(w1, dim=-1, keepdim=True), min=1e-12)
    w2 = w2 / torch.clamp(torch.linalg.norm(w2, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.clamp(torch.sum(w1 * w2, dim=-1), -1.0, 1.0)
    return torch.arccos(cosang)

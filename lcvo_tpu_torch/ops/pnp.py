"""Perspective-n-Point localization: batched P3P (Grunert) RANSAC + Gauss-Newton
polish (port of ``lcvo_tpu/ops/pnp.py``).

- Grunert's P3P system is reduced to a quartic whose coefficients are recovered
  numerically: evaluate the defining identity at 5 nodes, invert a constant
  Vandermonde matrix.
- Quartic roots by batched Durand-Kerner iteration in complex64 (40 fixed iterations).
- Each of the ≤4 roots of every sample is a hypothesis; all are scored against all
  points at once (MSAC), then fixed-iteration Gauss-Newton polishes the winner.

:func:`p3p_grunert` is the ``torch.library`` operator ``lcvo::p3p``: CUDA tensors launch
``csrc/p3p.cu`` (the whole solve, Durand-Kerner loop included, in one launch; counted
in ``kernels.LAUNCHES["p3p"]``), CPU tensors run :func:`p3p_grunert_plain`. Its batching
rule folds a vmapped stream dimension into the batch of minimal sets, so the batched
streams' step is one launch for all streams.

Image measurements are normalized coordinates (K^-1 pixels); thresholds are pixel
thresholds divided by fx.
"""

from __future__ import annotations

import numpy as np
import torch

from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.core import geometry as geo
from lcvo_tpu_torch.core.constants import on_device as _const
from lcvo_tpu_torch.ops import ransac
from lcvo_tpu_torch.ops import svd as svd_mod

_DK_ITERS = 40
_DK_SEED = np.array([(0.4 + 0.9j) ** k for k in range(1, 5)], np.complex64)

# Vandermonde nodes for recovering the 5 quartic coefficients from evaluations
_NODES = np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
_VANDERMONDE_INV = np.linalg.inv(
    np.stack([_NODES ** k for k in range(4, -1, -1)], axis=-1)).astype(np.float32)


def quartic_roots(coeffs: torch.Tensor) -> torch.Tensor:
    """Roots of A v^4 + B v^3 + C v^2 + D v + E, batched.

    coeffs: (..., 5) [A, B, C, D, E] real. Returns (..., 4) complex64 roots."""
    c = coeffs.to(torch.complex64)
    lead = c[..., 0:1]
    tiny = torch.full_like(lead, 1e-12)
    lead = torch.where(torch.abs(lead) > 1e-12, lead, tiny)
    p = c / lead  # monic: v^4 + p1 v^3 + p2 v^2 + p3 v + p4
    p1, p2, p3, p4 = p[..., 1:2], p[..., 2:3], p[..., 3:4], p[..., 4:5]
    z = _const(_DK_SEED, c.device).expand(p.shape[:-1] + (4,))
    eye = torch.eye(4, dtype=torch.complex64, device=c.device)
    for _ in range(_DK_ITERS):
        pz = (((z + p1) * z + p2) * z + p3) * z + p4
        diff = z[..., :, None] - z[..., None, :] + eye  # (..., 4, 4); 1 on the diagonal
        denom = diff[..., 0] * diff[..., 1] * diff[..., 2] * diff[..., 3]
        denom = torch.where(torch.abs(denom) > 1e-12, denom, torch.full_like(denom, 1e-12))
        z = z - pz / denom
    return z


def _kabsch(Pc: torch.Tensor, Pw: torch.Tensor):
    """Rigid transform world→camera from 3 paired points: Pc ≈ R Pw + t.

    Batched Kabsch via 3x3 SVD (``ops/svd.py``: a matrix whose SVD fails gives NaN, as
    in the JAX package). Pc, Pw: (..., 3, 3) rows = points. The P3P path uses
    :func:`_triad_align` (no SVD); this is the least-squares alternative."""
    muc = torch.mean(Pc, dim=-2, keepdim=True)
    muw = torch.mean(Pw, dim=-2, keepdim=True)
    H = torch.einsum("...ni,...nj->...ij", Pw - muw, Pc - muc)
    U, _, Vt = svd_mod.svd(H, site="kabsch")
    d = torch.sign(torch.linalg.det((U @ Vt).transpose(-1, -2)))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    # R maps world → camera: R = V diag(1,1,d) U^T (from H = U S V^T of the w→c covariance)
    R = torch.einsum("...ji,...j,...jk->...ik", Vt, D, U.transpose(-1, -2))
    t = (muc - torch.einsum("...ij,...nj->...ni", R, muw))[..., 0, :]
    return R, t


def _triad_align(Pc: torch.Tensor, Pw: torch.Tensor):
    """Rigid world→camera transform from 3 exactly corresponding points (rows):
    orthonormal triads of both triangles, composed as ``R = M_c M_w^T``."""

    def triad(P):
        u = P[..., 1, :] - P[..., 0, :]
        v = P[..., 2, :] - P[..., 0, :]
        e1 = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-12)
        n = torch.linalg.cross(e1, v)
        e3 = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        e2 = torch.linalg.cross(e3, e1)
        return torch.stack([e1, e2, e3], dim=-1)  # columns

    Mc = triad(Pc)
    Mw = triad(Pw)
    R = torch.einsum("...ij,...kj->...ik", Mc, Mw)
    t = Pc[..., 0, :] - torch.einsum("...ij,...j->...i", R, Pw[..., 0, :])
    return R, t


def p3p_grunert_plain(Pw: torch.Tensor, f: torch.Tensor):
    """Grunert P3P, plain PyTorch: world points Pw (..., 3, 3) + unit bearings
    f (..., 3, 3) → up to 4 poses. Returns (R (..., 4, 3, 3), t (..., 4, 3), ok (..., 4))."""
    P1, P2, P3 = Pw[..., 0, :], Pw[..., 1, :], Pw[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, -1)
    b2 = torch.sum((P1 - P3) ** 2, -1)
    c2 = torch.sum((P1 - P2) ** 2, -1)
    ca = torch.sum(f2 * f3, -1)  # cos alpha (rays 2-3)
    cb = torch.sum(f1 * f3, -1)  # cos beta  (rays 1-3)
    cg = torch.sum(f1 * f2, -1)  # cos gamma (rays 1-2)

    b2s = torch.clamp(b2, min=1e-12)
    k_ac = (a2 - c2) / b2s
    k_c = c2 / b2s

    def G(v):
        B = 1.0 + v * v - 2.0 * v * cb
        num = 1.0 - v * v + k_ac * B
        den = 2.0 * (cg - v * ca)
        Dv = 1.0 - k_c * B
        # quartic identity: num^2 - 2 num cg den + Dv den^2 = 0
        return num * num - 2.0 * num * cg * den + Dv * den * den

    evals = torch.stack([G(float(n)) for n in _NODES], dim=-1)  # (..., 5)
    Vinv = _const(_VANDERMONDE_INV, evals.device).to(evals.dtype)
    coeffs = torch.einsum("ij,...j->...i", Vinv, evals)
    roots = quartic_roots(coeffs)  # (..., 4) complex

    v = roots.real
    root_ok = (torch.abs(roots.imag) < 1e-3 * (1.0 + torch.abs(v))) & (v > 1e-6)

    Bv = 1.0 + v * v - 2.0 * v * cb[..., None]
    num = 1.0 - v * v + k_ac[..., None] * Bv
    den = 2.0 * (cg[..., None] - v * ca[..., None])
    u = num / torch.where(torch.abs(den) > 1e-9, den, torch.full_like(den, 1e-9))
    s1 = torch.sqrt(torch.clamp(b2[..., None], min=1e-12) / torch.clamp(Bv, min=1e-9))
    s2 = u * s1
    s3 = v * s1
    depth_ok = (s1 > 0) & (s2 > 0) & (s3 > 0) & (Bv > 1e-9)

    Pc = torch.stack(
        [
            s1[..., None] * f1[..., None, :],
            s2[..., None] * f2[..., None, :],
            s3[..., None] * f3[..., None, :],
        ],
        dim=-2,
    )  # (..., 4, 3, 3)
    Pw4 = Pw[..., None, :, :].expand(Pc.shape)
    R, t = _triad_align(Pc, Pw4)
    return R, t, root_ok & depth_ok


def p3p_grunert(Pw: torch.Tensor, f: torch.Tensor):
    """Grunert P3P: world points Pw (..., 3, 3) + unit bearings f (..., 3, 3), f32, one
    device → up to 4 poses. Returns (R (..., 4, 3, 3), t (..., 4, 3), ok (..., 4)).

    CUDA tensors go through ``csrc/p3p.cu`` (one launch for any batch shape), CPU
    tensors through :func:`p3p_grunert_plain`."""
    if Pw.device != f.device:
        raise ValueError(f"p3p: Pw on {Pw.device}, f on {f.device}: both must be on one device")
    if Pw.dtype != torch.float32 or f.dtype != torch.float32:
        raise TypeError(f"p3p takes f32 points and bearings, got {Pw.dtype} and {f.dtype}")
    if Pw.dim() < 2 or Pw.shape[-2:] != (3, 3) or f.shape != Pw.shape:
        raise ValueError(f"p3p: Pw and f must both be (..., 3, 3), got {tuple(Pw.shape)} and "
                         f"{tuple(f.shape)}")
    return torch.ops.lcvo.p3p(Pw, f)


@torch.library.custom_op("lcvo::p3p", mutates_args=(), device_types="cpu")
def _p3p_op(Pw: torch.Tensor, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return p3p_grunert_plain(Pw, f)


@_p3p_op.register_kernel("cuda")
def _p3p_cuda(Pw, f):
    """Launch ``csrc/p3p.cu`` once over every minimal set of the batch."""
    batch = Pw.shape[:-2]
    B = Pw.numel() // 9
    R = torch.empty(batch + (4, 3, 3), dtype=torch.float32, device=Pw.device)
    t = torch.empty(batch + (4, 3), dtype=torch.float32, device=Pw.device)
    ok = torch.empty(batch + (4,), dtype=torch.bool, device=Pw.device)
    if B == 0:
        return R, t, ok
    if B >= 2 ** 29:
        raise ValueError(f"p3p kernel indexes its threads with 32 bits, got {B} minimal sets")
    lib = kernels.library()
    Pw = Pw.contiguous()
    f = f.contiguous()
    vinv = _const(_VANDERMONDE_INV, Pw.device)
    seed = _const(_DK_SEED, Pw.device)
    with torch.cuda.device(Pw.device):
        stream = torch.cuda.current_stream(Pw.device).cuda_stream
        code = lib.lcvo_p3p_f32(Pw.data_ptr(), f.data_ptr(), B, vinv.data_ptr(),
                                seed.data_ptr(), R.data_ptr(), t.data_ptr(), ok.data_ptr(),
                                stream)
    kernels.check(code, "p3p")
    kernels.LAUNCHES["p3p"] += 1
    return R, t, ok


def _p3p_vmap(info, in_dims, Pw, f):
    """B calls are one call on the stacked batch; an unbatched argument is broadcast."""
    B = info.batch_size
    Pw = Pw.expand((B,) + Pw.shape) if in_dims[0] is None else Pw.movedim(in_dims[0], 0)
    f = f.expand((B,) + f.shape) if in_dims[1] is None else f.movedim(in_dims[1], 0)
    return torch.ops.lcvo.p3p(Pw, f), (0, 0, 0)


torch.library.register_vmap("lcvo::p3p", _p3p_vmap)


def reproj_sq_error(R, t, X, x_obs):
    """Squared reprojection error in normalized coords. R (..., 3, 3), t (..., 3),
    X (N, 3) world, x_obs (N, 2). Returns (..., N); points behind the camera get +inf."""
    Xc = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    proj = Xc[..., :2] / zs[..., None]
    err = torch.sum((proj - x_obs) ** 2, dim=-1)
    return torch.where(z > 1e-6, err, torch.full_like(err, float("inf")))


def gauss_newton_pose(R, t, X, x_obs, weights, iters: int = 8, damping: float = 1e-6):
    """Fixed-iteration damped Gauss-Newton pose polish.

    Left-multiplicative se(3) perturbation: Xc' = exp(w^)(R X + t) + dt. ``weights``
    (N,) is the inlier mask; zero-weight points contribute nothing. The 6x6 solve uses
    ``solve_ex`` so that nothing waits on the host."""
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        Xc = X @ R.T + t
        z = torch.clamp(Xc[..., 2], min=1e-6)
        proj = Xc[..., :2] / z[..., None]
        r = proj - x_obs  # (N, 2)
        inv_z = 1.0 / z
        x_, y_ = Xc[..., 0], Xc[..., 1]
        zero = torch.zeros_like(z)
        Jp = torch.stack(
            [
                torch.stack([inv_z, zero, -x_ * inv_z * inv_z], -1),
                torch.stack([zero, inv_z, -y_ * inv_z * inv_z], -1),
            ],
            dim=-2,
        )  # (N, 2, 3)
        Jx = torch.cat([-geo.hat(Xc), eye3.expand(Xc.shape[:-1] + (3, 3))], dim=-1)  # (N, 3, 6)
        J = torch.einsum("nij,njk->nik", Jp, Jx)  # (N, 2, 6)
        Jw = J * weights[:, None, None]
        JtJ = torch.einsum("nik,nil->kl", Jw, J)
        Jtr = torch.einsum("nik,ni->k", Jw, r)
        delta = -torch.linalg.solve_ex(JtJ + damping * eye6, Jtr)[0]
        dR = geo.rodrigues(delta[:3])
        R, t = dR @ R, dR @ t + delta[3:]
    return R, t


def pnp_ransac(
    u: torch.Tensor | None,
    X: torch.Tensor,
    x_obs: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    n_hyp: int = 512,
    refine_iters: int = 8,
    idx: torch.Tensor | None = None,
):
    """Robust world→camera pose from 2D-3D correspondences.

    X (N, 3) world points; x_obs (N, 2) normalized observations; thresh in normalized
    units (pixel_thresh / fx). ``u`` (n_hyp, 3): the uniforms of the draw's
    ``jax.random`` key (``utils/jax_random.py``), from which the minimal sets are drawn
    as the JAX package draws them; ``idx`` (n_hyp, 3) injects the minimal sets instead.
    Returns (R, t, inliers (N,), n_inliers)."""
    N = X.shape[0]
    if idx is None:
        idx = ransac.sample_minimal_sets(u, N, valid)  # (H, 3)
    Pw = X[idx]  # (H, 3, 3)
    xo = x_obs[idx]  # (H, 3, 2)
    f = torch.cat([xo, torch.ones(xo.shape[:-1] + (1,), dtype=xo.dtype, device=xo.device)], -1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    R_h, t_h, ok_h = p3p_grunert(Pw, f)  # (H, 4, 3, 3), (H, 4, 3), (H, 4)
    R_h = R_h.reshape(-1, 3, 3)
    t_h = t_h.reshape(-1, 3)
    ok_h = ok_h.reshape(-1)

    err = reproj_sq_error(R_h, t_h, X, x_obs)  # (H*4, N)
    err = torch.where(ok_h[:, None], err, torch.full_like(err, float("inf")))
    thr2 = thresh * thresh
    score, _ = ransac.msac_score(err, valid, thr2)
    best = ransac.best_hypothesis(score)
    R0, t0 = ransac.take(R_h, best), ransac.take(t_h, best)
    inl0 = (reproj_sq_error(R0, t0, X, x_obs) < thr2) & valid

    Rr, tr = gauss_newton_pose(R0, t0, X, x_obs, inl0.to(X.dtype), iters=refine_iters)
    inl = (reproj_sq_error(Rr, tr, X, x_obs) < thr2) & valid
    # keep the refined pose only if it didn't lose inliers
    use_ref = torch.sum(inl) >= torch.sum(inl0)
    R_out = torch.where(use_ref, Rr, R0)
    t_out = torch.where(use_ref, tr, t0)
    inl_out = torch.where(use_ref, inl, inl0)
    return R_out, t_out, inl_out, torch.sum(inl_out)

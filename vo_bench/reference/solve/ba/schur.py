"""Sliding-window bundle adjustment: Schur-complement Levenberg-Marquardt (port of
``lcvo_tpu/solve/ba/schur.py``).

The observation set is a **dense (W, K) grid**: keyframe w observes landmark slot k,
masked. Every assembly step is then a fixed-shape einsum or reduction:

- ``H_pp``  (W, 6, 6)    block-diagonal pose Hessian (poses couple only via points)
- ``H_ll``  (K, 3, 3)    block-diagonal landmark Hessian
- ``U``     (W, K, 6, 3) pose-landmark coupling blocks
- Schur:    ``S = H_pp - U H_ll^-1 U^T`` reduced to the (W*6, W*6) camera system,
  landmarks marginalized in parallel per 3x3 block (one batched closed-form inverse);
  back-substitution recovers the landmark updates.

Pose parametrization: left-multiplicative se(3) tangent on the world→camera transform,
``T ← exp(δ) ∘ T`` with δ = (ω, v). Gauge freedom is removed by freezing poses (their δ
is forced to zero through the reduced system).

Nothing here reads a value back to the host: the LM accept/reject is a ``torch.where``
on a 0-d tensor, the reduced solve is ``solve_ex``, and every reduction is a dense
einsum (no atomics), so a refine gives the same bits from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_bench.reference.core import geometry as geo


class BAProblem(NamedTuple):
    """Dense-grid BA inputs. All tensors fixed-shape; invalid entries masked."""

    R: torch.Tensor        # (W, 3, 3) world→camera rotations
    t: torch.Tensor        # (W, 3)
    X: torch.Tensor        # (K, 3) world landmarks
    obs: torch.Tensor      # (W, K, 2) normalized image coords (K^-1 applied)
    mask: torch.Tensor     # (W, K) bool — keyframe w observes landmark k


class BAResult(NamedTuple):
    R: torch.Tensor        # (W, 3, 3) refined
    t: torch.Tensor        # (W, 3)
    X: torch.Tensor        # (K, 3)
    cost0: torch.Tensor    # () initial robust cost
    cost: torch.Tensor     # () final robust cost


def _residuals_jacobians(R, t, X, obs, mask, huber: float):
    """Per-(w,k) robust-weighted residuals and Jacobians.

    Returns r (W,K,2), Jp (W,K,2,6) wrt pose tangent (ω,v), Jx (W,K,2,3) wrt X,
    all pre-multiplied by sqrt(huber weight) * mask, plus the robust cost.
    """
    # camera points p = R_w X_k + t_w → (W, K, 3)
    p = torch.einsum("wij,kj->wki", R, X) + t[:, None, :]
    z = p[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    xy = p[..., :2] / z_safe[..., None]
    r = xy - obs  # (W, K, 2)

    # behind-camera observations carry no information
    mask = mask & (z > 1e-3)

    # Huber weights on the residual norm
    rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    over = rn > huber
    w_rob = torch.where(over, huber / rn, 1.0)
    cost = 0.5 * torch.sum(
        torch.where(mask, torch.where(over, huber * (2 * rn - huber), rn * rn), 0.0)
    )
    sw = torch.sqrt(w_rob) * mask.to(r.dtype)

    # J_pi = d(xy)/dp : (W, K, 2, 3)
    iz = 1.0 / z_safe
    zero = torch.zeros_like(iz)
    Jpi = torch.stack(
        [
            torch.stack([iz, zero, -p[..., 0] * iz * iz], dim=-1),
            torch.stack([zero, iz, -p[..., 1] * iz * iz], dim=-1),
        ],
        dim=-2,
    )
    # dp/dδ = [-hat(p) | I]  (3, 6); dp/dX = R_w
    hp = geo.hat(p)  # (W, K, 3, 3)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device).expand(hp.shape)
    Jdelta = torch.cat([-hp, eye3], dim=-1)  # (W, K, 3, 6)
    Jp = torch.einsum("wkab,wkbc->wkac", Jpi, Jdelta)  # (W, K, 2, 6)
    Jx = torch.einsum("wkab,wbc->wkac", Jpi, R)        # (W, K, 2, 3)

    r = r * sw[..., None]
    Jp = Jp * sw[..., None, None]
    Jx = Jx * sw[..., None, None]
    return r, Jp, Jx, cost


def _inv3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def assemble_blocks(R, t, X, obs, mask, huber, lam):
    """BA assembly: everything that is O(K).

    Returns the pieces of the Schur-reduced camera system plus what landmark
    back-substitution needs: ``(S (W,6,W,6), rhs (W,6), U (W,K,6,3), Hll_inv (K,3,3),
    bl (K,3), cost ())``. ``S`` and ``rhs`` are sums over the landmark axis, so this is
    also the function a landmark-sharded variant runs per shard before it reduces them.
    ``lam`` is a 0-d tensor (or a float).
    """
    r, Jp, Jx, cost = _residuals_jacobians(R, t, X, obs, mask, huber)
    W, K = mask.shape
    f = dict(dtype=r.dtype, device=r.device)

    Hpp = torch.einsum("wkai,wkaj->wij", Jp, Jp)            # (W, 6, 6)
    bp = torch.einsum("wkai,wka->wi", Jp, r)                # (W, 6)
    Hll = torch.einsum("wkai,wkaj->kij", Jx, Jx)            # (K, 3, 3)
    bl = torch.einsum("wkai,wka->ki", Jx, r)                # (K, 3)
    U = torch.einsum("wkai,wkaj->wkij", Jp, Jx)             # (W, K, 6, 3)

    # LM damping on the landmark blocks before inversion
    Hll_inv = _inv3(Hll + lam * torch.eye(3, **f))          # (K, 3, 3)

    # Schur contractions over the landmark axis: U·Hll^-1 first (W, K, 6, 3), then one
    # (6W x 3K)·(3K x 6W) product; contracting the two U's first would build a
    # (W, 6, W, 6, K, 3, 3) intermediate
    UH = torch.einsum("wkij,kjl->wkil", U, Hll_inv)
    UH_m = UH.permute(0, 2, 1, 3).reshape(W * 6, K * 3)
    U_m = U.permute(0, 2, 1, 3).reshape(W * 6, K * 3)
    S_corr = (UH_m @ U_m.T).reshape(W, 6, W, 6)             # "wkij,kjl,vkml->wivm"
    b_corr = (UH_m @ bl.reshape(K * 3)).reshape(W, 6)       # "wkij,kjl,kl->wi"

    # the (W, 6, 6) blocks on the block diagonal, zeros elsewhere; a select, not a write
    # into a fresh buffer, which torch.func.vmap refuses
    diag = torch.eye(W, dtype=torch.bool, device=r.device)[:, None, :, None]
    D = (Hpp + lam * torch.eye(6, **f))[:, :, None, :]
    Hpp_full = torch.where(diag, D, torch.zeros((), **f))
    S = Hpp_full - S_corr
    rhs = bp - b_corr
    return S, rhs, U, Hll_inv, bl, cost


def _solve_reduced(S, rhs, fix_mask):
    """Solve the (W*6, W*6) reduced camera system with frozen poses masked out.
    ``solve_ex`` does not read cuSOLVER's status back, so nothing waits on the host."""
    W = rhs.shape[0]
    free = (~fix_mask).to(S.dtype)      # (W,)
    fm = free[:, None]                  # (W, 1) per-dof mask (all 6 dofs together)
    M = S * fm[:, :, None, None] * fm[None, None, :, :]
    Sm = M.reshape(W * 6, W * 6)
    # unit diagonal on frozen dofs keeps the system non-singular with δ = 0 there
    diag_fix = fix_mask[:, None].expand(W, 6).reshape(W * 6).to(S.dtype)
    Sm = Sm + torch.diag_embed(diag_fix)
    rhs_m = (rhs * fm).reshape(W * 6)
    delta = torch.linalg.solve_ex(Sm, rhs_m)[0].reshape(W, 6)
    return delta * free[:, None]


def _apply_pose_delta(R, t, delta):
    """T ← exp(-δ) ∘ T (GN step is -H^-1 b with b = J^T r)."""
    omega, v = delta[:, :3], delta[:, 3:]
    dR = geo.rodrigues(-omega)
    R_new = torch.einsum("wij,wjk->wik", dR, R)
    t_new = torch.einsum("wij,wj->wi", dR, t) - v
    return R_new, t_new


def ba_solve(
    problem: BAProblem,
    iters: int = 5,
    n_fix: int = 2,
    huber: float = 3e-3,
    lam0: float = 1e-4,
    fix_rows=None,
) -> BAResult:
    """Run ``iters`` LM iterations on the window: a Python loop of ``iters`` steps with
    accept/reject by value (no data-dependent control flow).

    ``huber`` is in normalized-coordinate units (≈ px / fx). Frozen poses: the first
    ``n_fix`` window slots (gauge anchor), or an explicit ``fix_rows`` (W,) bool mask.
    Callers whose problem rows include EMPTY slots (a partially-filled keyframe ring)
    must pass ``fix_rows`` marking real keyframes: freezing empty rows leaves the live
    window's 7-DoF gauge, monocular scale included, anchored by nothing but LM damping,
    and each refine then injects null-space drift (see ``window.refine_window``).
    """
    R0, t0, X0, obs, mask = problem
    W = R0.shape[0]
    dev = R0.device
    fix_mask = (torch.arange(W, device=dev) < n_fix) if fix_rows is None else fix_rows

    def cost_of(R, t, X):
        return _residuals_jacobians(R, t, X, obs, mask, huber)[3]

    cost_init = cost_of(R0, t0, X0)
    R, t, X, cost = R0, t0, X0, cost_init
    # filled on the device: a tensor made from a Python value would be a copy from the
    # host that waits
    lam = torch.full((), lam0, dtype=R0.dtype, device=dev)
    for _ in range(iters):
        S, rhs, U, Hll_inv, bl, _ = assemble_blocks(R, t, X, obs, mask, huber, lam)
        dp = _solve_reduced(S, rhs, fix_mask)                        # (W, 6)
        # landmark back-substitution: δx_k = Hll_k^-1 (bl_k - Σ_w U_wk^T δp_w)
        u_dp = torch.einsum("wkij,wi->kj", U, dp)                    # (K, 3)
        dx = torch.einsum("kij,kj->ki", Hll_inv, bl - u_dp)          # (K, 3)
        R_new, t_new = _apply_pose_delta(R, t, dp)
        X_new = X - dx
        cost_new = cost_of(R_new, t_new, X_new)
        accept = cost_new < cost
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        lam = torch.where(accept, lam * 0.3, lam * 8.0)
        cost = torch.where(accept, cost_new, cost)
    return BAResult(R=R, t=t, X=X, cost0=cost_init, cost=cost)

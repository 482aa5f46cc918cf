"""Batched Nistér five-point minimal solver for the essential matrix (port of
``lcvo_tpu/ops/five_point.py``).

The equivalent of the minimal solver inside ``cv2.findEssentialMat``. The 8-point DLT
(:mod:`lcvo_tpu_torch.ops.epipolar`) remains the default solver; this module gives
exact minimal-sample parity with the reference: 5 correspondences → up to 10
essential-matrix solutions.

Everything is fixed-shape and batched over hypotheses, with no data-dependent control
flow and no read-back:

1. null space of the 5x9 epipolar constraint matrix (batched SVD) →
   ``E = x E1 + y E2 + z E3 + E4``;
2. the 10 cubic constraints (det(E)=0 and 2 E Eᵀ E − tr(E Eᵀ) E = 0) expanded over
   the 20-monomial basis of degree ≤3 in (x, y, z) via constant sparse
   multiplication tensors (einsum);
3. Gauss-Jordan reduction (batched 10x10 solve) and Nistér's row elimination →
   a degree-10 polynomial in z;
4. roots via fixed-iteration Durand-Kerner in complex64 (the same trick as the P3P
   quartic, :func:`lcvo_tpu_torch.ops.pnp.quartic_roots`);
5. back-substitution of (x, y) from the 3x3 polynomial system at each real root.

Spurious/non-converged roots are masked, not branched on: RANSAC scoring ignores them
via the validity mask.
"""

from __future__ import annotations

import numpy as np
import torch

from lcvo_tpu_torch.core.constants import on_device
from lcvo_tpu_torch.ops import svd as svd_mod

# ---------------------------------------------------------------------------
# Monomial bases and multiplication tensors (numpy, built once at import; copied to
# each device on first use)
# ---------------------------------------------------------------------------

# degree-≤1 monomials in (x, y, z): exponent triples, order (x, y, z, 1)
_D1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# degree-≤2 monomials
_D2 = [
    (2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1),
    (0, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
# degree-≤3 monomials, Nistér's column order: the first 10 get eliminated by
# Gauss-Jordan; the last 10 factor as {x, y, 1} x polynomials in z.
_D3 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _mult_tensor(a_basis, b_basis, out_basis):
    out_index = {e: i for i, e in enumerate(out_basis)}
    T = np.zeros((len(a_basis), len(b_basis), len(out_basis)), np.float32)
    for i, ea in enumerate(a_basis):
        for j, eb in enumerate(b_basis):
            T[i, j, out_index[tuple(np.add(ea, eb))]] = 1.0
    return T


_M11 = _mult_tensor(_D1, _D1, _D2)   # deg1 * deg1 -> deg2
_M21 = _mult_tensor(_D2, _D1, _D3)   # deg2 * deg1 -> deg3


def _conv_tensor(la, lb):
    T = np.zeros((la, lb, la + lb - 1), np.float32)
    for i in range(la):
        for j in range(lb):
            T[i, j, i + j] = 1.0
    return T


# 1-D polynomial products (coefficients highest-degree first) used by det(B)
_C44 = _conv_tensor(4, 4)
_C45 = _conv_tensor(4, 5)
_C54 = _conv_tensor(5, 4)
_C48 = _conv_tensor(4, 8)
_C57 = _conv_tensor(5, 7)


def _pmul(a: torch.Tensor, b: torch.Tensor, T: np.ndarray) -> torch.Tensor:
    return torch.einsum("...i,...j,ijk->...k", a, b, on_device(T, a.device))


def _polyval(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of coefficient array c (..., L), highest-degree first."""
    res = c[..., 0] + torch.zeros_like(z)
    for i in range(1, c.shape[-1]):
        res = res * z + c[..., i]
    return res


# ---------------------------------------------------------------------------
# Constraint-matrix construction
# ---------------------------------------------------------------------------


def _constraint_matrix(Ec: torch.Tensor) -> torch.Tensor:
    """Ec (..., 3, 3, 4): each entry of E as a degree-1 polynomial over (x,y,z,1).
    Returns the 10x20 cubic-constraint matrix over the Nistér monomial basis."""

    def m(i, j):
        return Ec[..., i, j, :]

    def p11(a, b):
        return _pmul(a, b, _M11)

    def p21(a, b):
        return _pmul(a, b, _M21)

    # det(E) = 0
    c0 = p11(m(1, 1), m(2, 2)) - p11(m(1, 2), m(2, 1))
    c1 = p11(m(1, 0), m(2, 2)) - p11(m(1, 2), m(2, 0))
    c2 = p11(m(1, 0), m(2, 1)) - p11(m(1, 1), m(2, 0))
    det = p21(c0, m(0, 0)) - p21(c1, m(0, 1)) + p21(c2, m(0, 2))

    # 2 E Eᵀ E − tr(E Eᵀ) E = 0 (nine equations)
    EEt = [[sum(p11(m(i, k), m(j, k)) for k in range(3)) for j in range(3)] for i in range(3)]
    tr = EEt[0][0] + EEt[1][1] + EEt[2][2]
    rows = [det]
    for i in range(3):
        for j in range(3):
            acc = sum(p21(EEt[i][k], m(k, j)) for k in range(3))
            rows.append(2.0 * acc - p21(tr, m(i, j)))
    return torch.stack(rows, dim=-2)  # (..., 10, 20)


# ---------------------------------------------------------------------------
# Degree-10 root solve (Durand-Kerner, fixed iterations)
# ---------------------------------------------------------------------------

_DK_ITERS = 100
_DK_SEED = np.array([1.3 * (0.4 + 0.9j) ** k for k in range(1, 11)], np.complex64)
_EYE10 = np.eye(10, dtype=np.complex64)
_POW_1_10 = np.arange(1, 11, dtype=np.float32)
_POW_0_10 = np.arange(0, 11, dtype=np.float32)


def poly_roots_deg10(coeffs: torch.Tensor) -> torch.Tensor:
    """All 10 complex roots of a degree-10 polynomial, batched. coeffs (..., 11)
    real, highest-degree first. Fixed-iteration Durand-Kerner in complex64.

    f32-safe: the variable is rescaled by a Fujiwara-type root bound so every root
    of the scaled polynomial lies in ~the unit disk. Horner then never overflows
    (a naive Cauchy-bound seeding puts |z|~1e4 for near-degenerate leading
    coefficients and z^10 overflows f32, stalling the iteration)."""
    dev = coeffs.device
    c = coeffs.to(torch.complex64)
    c = c / torch.clamp(torch.amax(torch.abs(c), dim=-1, keepdim=True), min=1e-30)
    lead = c[..., :1]
    lead = torch.where(torch.abs(lead) > 1e-10, lead, torch.full_like(lead, 1e-10))
    p = c / lead  # monic, (..., 11)

    # Fujiwara bound: 2 * max_k |p_k|^(1/k) bounds every root magnitude
    mag = torch.abs(p[..., 1:]) ** (1.0 / on_device(_POW_1_10, dev))
    s = torch.clamp(2.0 * torch.amax(mag, dim=-1, keepdim=True), min=1e-6)
    # substitute z = s*u: q_k = p_k / s^k is monic with all roots |u| <= 1
    q = p / s ** on_device(_POW_0_10, dev)

    u = on_device(_DK_SEED, dev).expand(q.shape[:-1] + (10,))
    eye = on_device(_EYE10, dev)
    qk = q[..., None, :]
    for _ in range(_DK_ITERS):
        pu = _polyval(qk, u)
        diff = u[..., :, None] - u[..., None, :] + eye
        denom = torch.prod(diff, dim=-1)
        denom = torch.where(torch.abs(denom) > 1e-18, denom, torch.full_like(denom, 1e-18))
        delta = pu / denom
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        u = u - delta
    return u * s


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


def five_point(x1: torch.Tensor, x2: torch.Tensor):
    """Nistér 5-point solutions, batched over leading dims.

    x1, x2: (..., 5, 2) *normalized* coordinates with x2ᵀ E x1 = 0.
    Returns (E (..., 10, 3, 3), valid (..., 10)): up to 10 unit-Frobenius essential
    matrices per sample; invalid slots (complex roots, degenerate samples) masked.
    """
    dtype = x1.dtype
    ones = torch.ones(x1.shape[:-1] + (1,), dtype=dtype, device=x1.device)
    h1 = torch.cat([x1, ones], dim=-1)
    h2 = torch.cat([x2, ones], dim=-1)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*h1.shape[:-2], 5, 9)
    _, _, Vh = svd_mod.svd(A, full_matrices=True, site="five_point")  # Vh (..., 9, 9)
    basis = Vh[..., 5:9, :].reshape(*Vh.shape[:-2], 4, 3, 3)   # E1..E4
    Ec = torch.movedim(basis, -3, -1)                          # (..., 3, 3, 4)

    C = _constraint_matrix(Ec)                                 # (..., 10, 20)
    # Gauss-Jordan: reduce to [I | G]. A degenerate sample gives a singular system:
    # solve_ex neither raises nor reads the status back, its NaN/inf are masked below
    G = torch.linalg.solve_ex(C[..., :, :10], C[..., :, 10:], check_errors=False)[0]
    bad = ~torch.all(torch.isfinite(G).flatten(-2), dim=-1)
    G = torch.nan_to_num(G)

    # Nistér elimination: rows 4..9 carry monomials x²z, x², y²z, y², xyz, xy.
    # (row_a − z·row_b) cancels the leading monomial, leaving a polynomial row over
    # the last-10 columns, which factor as x·(z²,z,1), y·(z²,z,1), (z³,z²,z,1).
    def combo(a, b):
        Ga, Gb = G[..., a, :], G[..., b, :]
        bx = torch.stack([-Gb[..., 0], Ga[..., 0] - Gb[..., 1], Ga[..., 1] - Gb[..., 2],
                          Ga[..., 2]], dim=-1)
        by = torch.stack([-Gb[..., 3], Ga[..., 3] - Gb[..., 4], Ga[..., 4] - Gb[..., 5],
                          Ga[..., 5]], dim=-1)
        b1 = torch.stack([-Gb[..., 6], Ga[..., 6] - Gb[..., 7], Ga[..., 7] - Gb[..., 8],
                          Ga[..., 8] - Gb[..., 9], Ga[..., 9]], dim=-1)
        return bx, by, b1

    bxk, byk, b1k = combo(4, 5)
    bxl, byl, b1l = combo(6, 7)
    bxm, bym, b1m = combo(8, 9)

    # det of the 3x3 polynomial system B(z)·(x, y, 1)ᵀ = 0 → degree-10 in z
    p1 = _pmul(byl, b1m, _C45) - _pmul(b1l, bym, _C54)
    p2 = _pmul(bxl, b1m, _C45) - _pmul(b1l, bxm, _C54)
    p3 = _pmul(bxl, bym, _C44) - _pmul(byl, bxm, _C44)
    det10 = _pmul(bxk, p1, _C48) - _pmul(byk, p2, _C48) + _pmul(b1k, p3, _C57)  # (..., 11)

    roots = poly_roots_deg10(det10)                            # (..., 10) complex
    zr = roots.real.to(dtype)
    realish = torch.abs(roots.imag) < 1e-2 * (1.0 + torch.abs(roots.real))

    # back-substitute (x, y): evaluate B(z) and take the best cross-product null vector
    BX = torch.stack([bxk, bxl, bxm], dim=-2)                  # (..., 3, 4)
    BY = torch.stack([byk, byl, bym], dim=-2)
    B1 = torch.stack([b1k, b1l, b1m], dim=-2)                  # (..., 3, 5)
    zb = zr[..., :, None]                                      # (..., 10, 1)
    Bxv = _polyval(BX[..., None, :, :], zb)                    # (..., 10, 3)
    Byv = _polyval(BY[..., None, :, :], zb)
    B1v = _polyval(B1[..., None, :, :], zb)
    M = torch.stack([Bxv, Byv, B1v], dim=-1)                   # (..., 10, 3rows, 3cols)
    v01 = torch.linalg.cross(M[..., 0, :], M[..., 1, :], dim=-1)
    v02 = torch.linalg.cross(M[..., 0, :], M[..., 2, :], dim=-1)
    v12 = torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1)
    vs = torch.stack([v01, v02, v12], dim=-2)                  # (..., 10, 3, 3)
    nrm = torch.linalg.norm(vs, dim=-1)
    pick = torch.argmax(nrm, dim=-1)
    v = torch.gather(vs, -2, pick[..., None, None].expand(*pick.shape, 1, 3))[..., 0, :]
    w = v[..., 2]
    w_ok = torch.abs(w) > 1e-9
    safe_w = torch.where(w_ok, w, torch.full_like(w, 1e-9))
    xs = v[..., 0] / safe_w
    ys = v[..., 1] / safe_w

    coeff = torch.stack([xs, ys, zr, torch.ones_like(zr)], dim=-1)        # (..., 10, 4)
    E = torch.einsum("...rc,...cij->...rij", coeff, basis)                # (..., 10, 3, 3)
    fro = torch.linalg.norm(E.flatten(-2), dim=-1)[..., None, None]
    E = E / torch.clamp(fro, min=1e-12)

    valid = realish & w_ok & torch.isfinite(E).flatten(-2).all(dim=-1) & ~bad[..., None]
    return E, valid

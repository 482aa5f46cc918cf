"""Trajectory accuracy: ATE after Sim(3) alignment (port of the ``ate_rmse`` part of
``lcvo_tpu/metrics.py``). Host-side numpy. Monocular VO has a free global scale, so ATE
uses a Sim(3) (Umeyama) alignment before the RMSE.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning est → gt.

    est, gt: (N, 3). Returns (s, R, t) with gt ≈ s * R @ est + t."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (xe**2).sum() / len(est)
    s = float(np.trace(np.diag(d) @ S) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned positions), meters."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))

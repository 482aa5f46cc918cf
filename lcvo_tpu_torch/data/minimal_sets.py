"""Synthetic P3P minimal sets, for checks of the P3P solve (``ops/pnp.py``).

Three kinds, as (Pw, f) pairs of (n, 3, 3) float32 arrays, world points and unit
bearings, one row a point:

- ``scene``: sets drawn from one scene of 1024 points seen with 0.5 px of noise at
  fx = 718, as PnP-RANSAC draws them;
- ``double``: sets whose quartic has a double root (an equilateral triangle seen from
  its axis), where Durand-Kerner's roots cluster and round apart most easily;
- ``near_double``: the same with the points moved by 1e-4 of the triangle's size.

Host-side numpy, shared by the tests and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np

KINDS = ("scene", "double", "near_double")


def rotations(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    """(n, 3, 3) rotations about random axes by angles of about ``scale`` radians."""
    w = rng.normal(size=(n, 3)) * scale
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = w / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def p3p_sets(kind: str, n: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """``n`` minimal sets of ``kind`` (one of :data:`KINDS`): (Pw, f), (n, 3, 3) f32."""
    if kind == "scene":
        X = rng.normal(size=(1024, 3)) * np.array([5, 3, 4]) + np.array([0, 0, 15.0])
        Xc = X @ rotations(rng, 1, 0.1)[0].T + rng.normal(size=3) * 0.5
        x = Xc[:, :2] / Xc[:, 2:] + rng.normal(size=(1024, 2)) * 0.5 / 718.0
        idx = np.stack([rng.choice(1024, 3, replace=False) for _ in range(n)])
        Pw, fb = X[idx], np.concatenate([x, np.ones((1024, 1))], -1)[idx]
    elif kind in ("double", "near_double"):
        eps = 0.0 if kind == "double" else 1e-4
        ang = rng.uniform(0, 2 * np.pi, size=(n, 1)) + np.array([0, 2 * np.pi / 3, 4 * np.pi / 3])
        r = rng.uniform(1, 3, size=(n, 1))
        fb = np.stack([r * np.cos(ang), r * np.sin(ang),
                       np.broadcast_to(rng.uniform(5, 20, size=(n, 1)), (n, 3))], -1)
        fb = fb + rng.normal(size=fb.shape) * eps * r[..., None]
        R, t = rotations(rng, n, 2.0), rng.normal(size=(n, 3))
        Pw = np.einsum("nji,nkj->nki", R, fb - t[:, None, :])
    else:
        raise ValueError(f"unknown kind of minimal set {kind!r}; one of {KINDS}")
    f = fb / np.linalg.norm(fb, axis=-1, keepdims=True)
    return Pw.astype(np.float32), f.astype(np.float32)

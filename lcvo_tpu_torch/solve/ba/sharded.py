"""Sliding-window BA with the landmarks sharded over the ranks of a mesh (port of
``lcvo_tpu/solve/ba/sharded.py``).

The O(K) work (residuals, Jacobians, the per-landmark 3x3 blocks and both Schur
contractions) is cut over the mesh's axis: each rank runs
:func:`~lcvo_tpu_torch.solve.ba.schur.assemble_blocks` on its K/n landmarks, and the
partial reduced camera systems are summed with one ``all_reduce``. The (6W)^2 reduced
solve then runs replicated, and each rank back-substitutes its own landmarks. The JAX
package does the same inside ``shard_map`` with ``lax.psum``.

The reduction is a plain sum over landmarks, so the result is the single-device
solver's up to the order of that sum. Every rank decides accept or reject from the same
reduced cost, so every rank takes the same decision and holds the same poses.

The JAX package jits the whole ``shard_map`` (``jax.jit(run)``, nothing donated). Here
the whole LM loop with its ``all_reduce`` calls and the final ``all_gather`` is one
compiled step (``parallel/mesh.py::compile_sharded``): on NCCL one CUDA graph per
(mesh, axis, ``iters``, ``n_fix``, ``huber``, ``lam0``) and shapes, captured at its
first call and replayed after; on gloo, whose collectives cannot be captured, eager.
"""

from __future__ import annotations

import torch

from lcvo_tpu_torch.parallel.mesh import Mesh, all_gather, compile_sharded, psum
from lcvo_tpu_torch.solve.ba.schur import (BAProblem, BAResult, _apply_pose_delta,
                                           _residuals_jacobians, _solve_reduced,
                                           assemble_blocks)


def ba_solve_sharded(
    problem: BAProblem,
    mesh: Mesh,
    axis: str = "data",
    iters: int = 5,
    n_fix: int = 2,
    huber: float = 3e-3,
    lam0: float = 1e-4,
    fix_rows=None,
) -> BAResult:
    """LM window BA with the landmark dimension sharded over ``mesh``'s ``axis``.

    Every rank passes the whole problem (the JAX call's global semantics) and takes the
    landmarks of its coordinate along ``axis``: ``X`` (K, 3), ``obs`` (W, K, 2) and
    ``mask`` (W, K) cut on K, which must divide into the axis size; poses replicated.
    ``fix_rows`` (W,) bool overrides the leading-``n_fix`` gauge anchor, as in
    :func:`~lcvo_tpu_torch.solve.ba.schur.ba_solve`.

    Returns :class:`BAResult` with R, t, the costs and X (K, 3) (gathered) equal on every
    rank, so it stands in for ``ba_solve``'s result on any of them. Nothing waits on the
    host: the collectives are stream-ordered on NCCL. Runs through
    :func:`compiled_solver`'s step."""
    R0, t0, X0, obs, mask = problem
    n = mesh.shape[axis]
    if X0.shape[0] % n:
        raise ValueError(f"landmark capacity {X0.shape[0]} does not divide into the {n} ranks "
                         f"of mesh axis {axis!r}")
    return compiled_solver(mesh, axis, iters, n_fix, huber, lam0)(R0, t0, X0, obs, mask, fix_rows)


def compiled_solver(mesh: Mesh, axis: str = "data", iters: int = 5, n_fix: int = 2,
                    huber: float = 3e-3, lam0: float = 1e-4):
    """The compiled step :func:`ba_solve_sharded` runs with these arguments, kept by the
    mesh: ``step(R0, t0, X0, obs, mask, fix_rows) -> BAResult`` (``fix_rows`` None or
    (W,) bool); ``step.replayed`` tells whether its last call replayed a graph."""
    return compile_sharded(lambda: _sharded_solve(mesh, axis, iters, n_fix, huber, lam0), mesh,
                           axis, ("ba_solve_sharded", axis, iters, n_fix, huber, lam0))


def _sharded_solve(mesh: Mesh, axis: str, iters: int, n_fix: int, huber: float, lam0: float):
    """The LM loop on this rank's landmarks, its static arguments and the rank's
    coordinate constants of the capture."""
    n = mesh.shape[axis]
    rank = mesh.index(axis)

    def solve(R0, t0, X0, obs, mask, fix_rows):
        W = R0.shape[0]
        dev = R0.device
        fix_mask = (torch.arange(W, device=dev) < n_fix) if fix_rows is None else fix_rows
        m = X0.shape[0] // n
        X0 = X0[rank * m:(rank + 1) * m]
        obs = obs[:, rank * m:(rank + 1) * m]
        mask = mask[:, rank * m:(rank + 1) * m]

        def cost_of(R, t, X):
            return psum(_residuals_jacobians(R, t, X, obs, mask, huber)[3], mesh, axis)

        # assemble_blocks adds Hpp + lam*I on every shard: keep it on rank 0 only
        eye = torch.einsum("ij,wv->wivj", torch.eye(6, dtype=R0.dtype, device=dev),
                           torch.eye(W, dtype=R0.dtype, device=dev))
        cost_init = cost_of(R0, t0, X0)
        R, t, X, cost = R0, t0, X0, cost_init
        lam = torch.full((), lam0, dtype=R0.dtype, device=dev)
        for _ in range(iters):
            S, rhs, U, Hll_inv, bl, _ = assemble_blocks(R, t, X, obs, mask, huber, lam)
            if rank:
                S = S - lam * eye
            # one collective for the reduced system and its right-hand side
            red = psum(torch.cat([S.reshape(-1), rhs.reshape(-1)]), mesh, axis)
            S, rhs = red[:S.numel()].reshape(S.shape), red[S.numel():].reshape(rhs.shape)
            dp = _solve_reduced(S, rhs, fix_mask)                        # replicated
            u_dp = torch.einsum("wkij,wi->kj", U, dp)                    # this rank's landmarks
            dx = torch.einsum("kij,kj->ki", Hll_inv, bl - u_dp)
            R_new, t_new = _apply_pose_delta(R, t, dp)
            X_new = X - dx
            cost_new = cost_of(R_new, t_new, X_new)
            accept = cost_new < cost
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            X = torch.where(accept, X_new, X)
            lam = torch.where(accept, lam * 0.3, lam * 8.0)
            cost = torch.where(accept, cost_new, cost)
        return BAResult(R=R, t=t, X=all_gather(X, mesh, axis), cost0=cost_init, cost=cost)

    return solve

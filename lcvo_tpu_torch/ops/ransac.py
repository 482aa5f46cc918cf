"""Fixed-shape hypothesis-scoring RANSAC machinery (port of ``lcvo_tpu/ops/ransac.py``).

A fixed budget of hypotheses is solved in parallel, scored against all points at once,
and the MSAC argmin wins. Sampling draws from an explicit ``torch.Generator``; it cannot
reproduce JAX's PRNG, so parity tests inject the JAX package's indices instead.
"""

from __future__ import annotations

import torch


def sample_minimal_sets(gen: torch.Generator | None, n_points: int, valid: torch.Tensor,
                        n_hyp: int, k: int) -> torch.Tensor:
    """(n_hyp, k) int64 indices drawn from valid points, with replacement.

    Invalid points get zero probability. With no valid point at all the draw is
    uniform (every hypothesis then scores as garbage, as in the JAX package).
    Degenerate sets (repeated points) are allowed; they lose the MSAC argmin."""
    p = valid.to(torch.float32)
    p = torch.where(torch.sum(p) > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p, n_hyp * k, replacement=True, generator=gen)
    return idx.reshape(n_hyp, k)


def msac_score(sq_err: torch.Tensor, valid: torch.Tensor, thresh_sq: float):
    """MSAC truncated-loss score per hypothesis. sq_err (H, N); valid (N,).
    Returns (score (H,), inlier counts (H,)); lower score is better."""
    capped = torch.clamp(sq_err, max=thresh_sq)
    capped = torch.where(valid[None, :], capped, torch.zeros_like(capped))
    inl = valid[None, :] & (sq_err < thresh_sq)
    return torch.sum(capped, dim=-1), torch.sum(inl, dim=-1)


def best_hypothesis(score: torch.Tensor) -> torch.Tensor:
    """Index of the winning (minimum-score) hypothesis (first on ties)."""
    return torch.argmin(score)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor without reading it back to the host (indexing
    with a 0-dim tensor converts it to a Python int, which waits for the device)."""
    return x.index_select(0, i.reshape(1)).squeeze(0)

"""Fixed-shape hypothesis-scoring RANSAC machinery (port of ``lcvo_tpu/ops/ransac.py``).

A fixed budget of hypotheses is solved in parallel, scored against all points at once,
and the MSAC argmin wins. The minimal sets are the JAX package's draws: the caller
passes the uniforms of its ``jax.random`` key (``utils/jax_random.py``), and
:func:`sample_minimal_sets` turns them into indices as ``jax.random.choice`` does on the
CPU, bit for bit, on any device and with no read-back.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# XLA's CPU compiler rewrites a cumulative sum longer than this into blocks of this
# length (ReduceWindowRewriter): a sequential sum inside each block, the blocks' totals
# summed the same way, recursively, and each block's exclusive prefix added last
_SCAN_BLOCK = 16


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, left to right, one float32 rounding per step."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def cumsum_as_xla(p: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(p)`` along the last axis with the rounding of the JAX package on the
    CPU (jax 0.9.0's XLA): the blocked order of ``_SCAN_BLOCK``. Summed left to right
    instead, about one draw in 500 takes another index."""
    n = p.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_scan(p)
    m = -(-n // _SCAN_BLOCK)
    x = F.pad(p, (0, m * _SCAN_BLOCK - n)).reshape(p.shape[:-1] + (m, _SCAN_BLOCK))
    local = _sequential_scan(x)
    before = F.pad(cumsum_as_xla(local[..., -1])[..., :-1], (1, 0))
    return (local + before[..., None]).reshape(p.shape[:-1] + (m * _SCAN_BLOCK,))[..., :n]


def searchsorted_as_jax(c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(c, r)`` (side ``left``, method ``scan``) for 1-D ``c``: JAX's
    bisection of ``ceil(log2(n + 1))`` fixed steps, probing what it probes. The prefix
    sums are not sorted everywhere (rounding leaves one-ulp dips after invalid points),
    and there a lower bound of another probe order can end elsewhere."""
    n = c.shape[-1]
    q = r.reshape(-1)
    high = torch.full_like(q, n, dtype=torch.int64)
    steps = math.ceil(math.log2(n + 1))
    if n & (n - 1) == 0:
        # n a power of two: every probe halves the interval (high - low) alike, so the
        # probe is high minus half of it (then 1 when it is 1) and low need not be kept
        for i in range(steps):
            mid = high - max(n >> (i + 1), 1)
            high = torch.where(q <= torch.gather(c, 0, mid), mid, high)
        return high.reshape(r.shape)
    low = torch.zeros_like(q, dtype=torch.int64)
    for _ in range(steps):
        mid = (low + high) >> 1
        left = q <= torch.gather(c, 0, mid)
        low = torch.where(left, low, mid)
        high = torch.where(left, mid, high)
    return high.reshape(r.shape)


def sample_minimal_sets(u: torch.Tensor, n_points: int, valid: torch.Tensor) -> torch.Tensor:
    """(n_hyp, k) int64 indices drawn from valid points, with replacement, from the
    uniforms ``u`` (n_hyp, k) of the draw's key: ``jax.random.choice(key, n_points,
    (n_hyp, k), p=valid / max(sum(valid), 1))`` of the JAX package, bit for bit.

    Invalid points get zero probability; with no valid point at all every index is 0,
    as in the JAX package (every hypothesis then scores as garbage). Degenerate sets
    (repeated points) are allowed; they lose the MSAC argmin."""
    if valid.shape[-1] != n_points:
        raise ValueError(f"valid holds {valid.shape[-1]} points, not {n_points}")
    p = valid.to(torch.float32)
    p = p / torch.clamp(torch.sum(p), min=1.0)
    c = cumsum_as_xla(p)
    return searchsorted_as_jax(c, c[-1] * (1.0 - u))


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

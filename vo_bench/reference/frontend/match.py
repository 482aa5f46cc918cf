"""Brute-force descriptor matching (port of ``lcvo_tpu/frontend/match.py``).

The equivalent of ``cv2.BFMatcher.knnMatch(k=2)`` + Lowe's ratio test. The all-pairs
squared L2 distance matrix is one matrix product (|q|^2 + |t|^2 - 2 q.t); it sits
outside any kernel in the JAX package and goes to ``torch.matmul`` in full fp32 here.

The two nearest targets come from a ``min`` and a second ``min`` with the winner masked
out, as in the JAX package, not from ``torch.topk``: one ``torch.min`` gives value and
index together, an exact duplicate of the best distance still counts as the second
best (so the ratio test rejects it), and ties resolve to the first index on both sides.
"""

from __future__ import annotations

import torch



def knn_match_ratio(desc_q: torch.Tensor, valid_q: torch.Tensor, desc_t: torch.Tensor,
                    valid_t: torch.Tensor, ratio: float = 0.8):
    """For each query descriptor, its best match among the targets if it passes the
    ratio test (best < ratio * second-best, on L2 distance).

    Returns (idx (Nq,) int64, the best target index; ok (Nq,) bool). With no valid
    target every distance is inf and ``ok`` is False throughout."""
    qq = torch.sum(desc_q * desc_q, dim=1, keepdim=True)
    tt = torch.sum(desc_t * desc_t, dim=1)
    d2 = qq + tt[None, :] - 2.0 * torch.matmul(desc_q, desc_t.T)
    d2 = torch.clamp(d2, min=0.0)
    d2 = d2.masked_fill(~valid_t[None, :], float("inf"))
    d_best, idx = torch.min(d2, dim=1)
    d_second = torch.min(d2.scatter(1, idx[:, None], float("inf")), dim=1).values
    # ratio on distances -> squared ratio on squared distances
    ok = valid_q & torch.isfinite(d_best) & (d_best < (ratio ** 2) * d_second)
    return idx, ok


def mutual_match(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
                 valid_b: torch.Tensor, ratio: float = 0.8):
    """Ratio-test matches that are also mutual nearest neighbours (the descriptor-
    matching analog of OpenCV's crossCheck)."""
    idx_ab, ok_ab = knn_match_ratio(desc_a, valid_a, desc_b, valid_b, ratio)
    idx_ba, ok_ba = knn_match_ratio(desc_b, valid_b, desc_a, valid_a, ratio)
    back = idx_ba[idx_ab]
    here = torch.arange(desc_a.shape[0], device=desc_a.device)
    ok = ok_ab & ok_ba[idx_ab] & (back == here)
    return idx_ab, ok

"""The SVD of small batched matrices with JAX's failure semantics, plain (a copy of the
port's ``ops/svd.py::svd_plain``): ``torch.linalg.svd`` of the batch, a matrix whose SVD
fails (an entry not finite, or ``torch.linalg.svd`` raising for it) NaN in ``U``, ``S``
and ``Vh``, as ``jnp.linalg.svd`` gives it. Nothing raises.
"""

from __future__ import annotations

import torch

from vo_bench.reference.calls import recorded


def _finite(A: torch.Tensor) -> torch.Tensor:
    """Per matrix of ``A (..., m, n)``: every entry finite."""
    return torch.isfinite(A).flatten(-2).all(-1)


def _nan_where(failed: torch.Tensor, *outs):
    """Each output with the matrices where ``failed`` (batch shape) is set made NaN."""
    return tuple(torch.where(failed.reshape(failed.shape + (1,) * (x.dim() - failed.dim())),
                             torch.full_like(x, float("nan")), x) for x in outs)


def svd_plain(A: torch.Tensor, full_matrices: bool = True):
    """The plain version: ``torch.linalg.svd`` of the batch, with the matrices that fail
    (an entry not finite, or ``torch.linalg.svd`` raising for it) NaN in every output
    and the others bit for bit ``torch.linalg.svd``'s. On CUDA ``torch.linalg.svd``
    reads its convergence codes back, so this cannot be captured."""
    failed = ~_finite(A)
    clean = torch.where(failed[..., None, None], torch.zeros_like(A), A)
    try:
        out = torch.linalg.svd(clean, full_matrices=full_matrices)
    except torch.linalg.LinAlgError:
        # no convergence on a finite matrix: each matrix alone, as the batched call
        # computes it, and NaN for those that raise
        flat = clean.reshape((-1,) + clean.shape[-2:])
        parts, bad = [], []
        for a in flat:
            try:
                parts.append(torch.linalg.svd(a, full_matrices=full_matrices))
                bad.append(False)
            except torch.linalg.LinAlgError:
                parts.append(torch.linalg.svd(torch.zeros_like(a), full_matrices=full_matrices))
                bad.append(True)
        out = tuple(torch.stack(xs).reshape(A.shape[:-2] + xs[0].shape) for xs in zip(*parts))
        failed = failed | torch.tensor(bad, device=A.device).reshape(failed.shape)
    return _nan_where(failed, *out)


@recorded("svd")
def svd(A: torch.Tensor, full_matrices: bool = True, *, site: str):
    """``(U, S, Vh)`` of ``A (..., m, n)``: :func:`svd_plain` on any device (``site`` is
    the caller's name, kept for the call's signature)."""
    return svd_plain(A, full_matrices)

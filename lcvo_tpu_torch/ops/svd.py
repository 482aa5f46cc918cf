"""The SVD of small batched matrices, in a form a CUDA graph can hold, with JAX's
failure semantics.

The two-view bootstrap takes four SVDs (``ops/epipolar.py``: the eight-point fit, the
rank-2 projection and the essential decomposition; ``ops/five_point.py``: the null space
of the five-point system), which the JAX package leaves to XLA (``jnp.linalg.svd``).
On CUDA ``torch.linalg.svd`` runs cuSOLVER's ``gesvdjBatched`` for matrices of at most
32 x 32 and then copies the per-matrix convergence codes to the host to check them; no
CUDA graph can hold that copy, so ``two_view_init`` could not be captured.

:func:`svd` has ``torch.linalg.svd``'s signature and results. A CPU tensor runs
:func:`svd_plain`. A CUDA tensor launches ``csrc/svd.cu``, which makes torch's own
``gesvdjBatched`` call with torch's settings, so the bits are ``torch.linalg.svd``'s,
and leaves the codes on the device; anything else raises.

**A matrix whose SVD fails gives NaN** in its ``U``, ``S`` and ``Vh``, and the rest of
the batch is computed as it would be without it: what ``jnp.linalg.svd`` computes on
every backend (``_replace_not_ok_with_nan`` in ``jax/_src/lax/linalg.py``). A matrix
fails when an entry of it is not finite or the solver reports a code for it (cuSOLVER's
``info``; on the CPU, ``torch.linalg.svd`` raising for it). Nothing raises and nothing
is retried: a hypothesis whose SVD failed is scored like any other, as in the JAX package.

Each call also notes its failures in a per-device record (:func:`record`), one row per
call site: the failed matrices of the first call of that site that had one, the first
of them and its code (the solver's, or -1 where it gave none). The record is a tensor on
the device, written inside the graph; ``VisualOdometry.bootstrap`` reads it in the
read-back it makes anyway and reports the count.

On the card the handle, the parameter set, the workspace of each shape and the record
are made at the first call on a device, which must not be inside a capture (a compiled
step's warm-up is that first call).
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import torch

from lcvo_tpu_torch import kernels

# call sites, one row each of the record: [matrices that failed in the first call that
# had one, the first such matrix, its code]
SITES = ("eight_point", "project_to_essential", "decompose_essential", "five_point", "kabsch")
MAX_DIM = 32          # gesvdjBatched's limit on m and n

_handles: dict = {}   # (device index, sweep cap) -> (handle, params)
_work: dict = {}      # (device index, sweep cap, m, n, batch) -> (workspace, lwork)
_records: dict = {}   # (device type, index) -> (len(SITES), 3) int64
_sweep_cap = 0        # 0: cuSOLVER's default


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


def svd(A: torch.Tensor, full_matrices: bool = True, *, site: str):
    """``(U, S, Vh)`` of ``A (..., m, n)`` as ``torch.linalg.svd`` gives them, a matrix
    that fails NaN in all three; ``site`` (one of :data:`SITES`) names the caller in the
    record. CPU: :func:`svd_plain`. CUDA: the ``gesvdjBatched`` launcher (f32, m and n at
    most 32), or raise."""
    if site not in SITES:
        raise ValueError(f"svd: unknown call site {site!r}; one of {SITES}")
    if A.device.type == "cpu":
        out = svd_plain(A, full_matrices)
        # a matrix that succeeds has finite singular values
        failed = torch.isnan(out[1]).any(-1).reshape(-1)
        _note(A.device, site, failed, torch.full_like(failed, -1, dtype=torch.int64))
        return out
    if A.device.type != "cuda":
        raise ValueError(f"svd: a tensor on {A.device}: the CPU or a CUDA device")
    return _svd_cuda(A, full_matrices, site)


@contextlib.contextmanager
def sweep_cap(n: int):
    """Cap cuSOLVER's Jacobi sweeps at ``n`` for the CUDA calls inside the block (0:
    its default). A check forces a failure with it; a compiled step captured outside
    the block keeps the cap it was captured with."""
    global _sweep_cap
    old, _sweep_cap = _sweep_cap, int(n)
    try:
        yield
    finally:
        _sweep_cap = old


def _key(device) -> tuple:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def record(device) -> torch.Tensor | None:
    """The failure record of a device, ``(len(SITES), 3)`` int64 rows of [failed
    matrices, first failed matrix, its code] (zero: no failure), on that device; None
    before the first call there."""
    return _records.get(_key(device))


def reset(device) -> None:
    """Clear the device's record (on the device; nothing is read)."""
    rec = record(device)
    if rec is not None:
        rec.zero_()


def failures(rows) -> dict:
    """``{site: failed matrices}`` for the sites whose row of a record read back to the
    host (``record(device).cpu()``, any numeric dtype, flat or not) shows a failure."""
    return {site: int(n) for site, (n, _, _) in zip(SITES, np.asarray(rows).reshape(len(SITES), 3))
            if n > 0}


def _note(device: torch.device, site: str, failed: torch.Tensor, code: torch.Tensor) -> None:
    """Into the site's row of the record, unless it holds a failure already: the count
    of ``failed`` (B,), the first failed matrix and its ``code`` (B,) (all zero without
    a failure). On the device, nothing read."""
    rec = _record_of(device)
    first = torch.argmax(failed.to(torch.int32)).reshape(1)
    code = torch.where(failed, code, 0).index_select(0, first).to(torch.int64)
    new = torch.cat([failed.sum().reshape(1), first, code])
    row = rec[SITES.index(site)]
    row.copy_(torch.where(row[0] > 0, row, new))


def _outside_capture(device: torch.device, what: str):
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"svd: {what} on {device} would be made inside a CUDA graph "
                           f"capture: call svd once outside it first (a compiled step's "
                           f"warm-up does)")


def _handle(device: torch.device):
    key = (device.index, _sweep_cap)
    if key not in _handles:
        _outside_capture(device, "the cuSOLVER handle")
        lib = kernels.library()
        h, p = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            kernels.check(lib.lcvo_svd_create(_sweep_cap, ctypes.byref(h), ctypes.byref(p)),
                          "svd: making the cuSOLVER handle")
        _handles[key] = (h, p)
    return _handles[key]


def _record_of(device: torch.device) -> torch.Tensor:
    key = _key(device)
    if key not in _records:
        if device.type == "cuda":
            _outside_capture(device, "the failure record")
        _records[key] = torch.zeros((len(SITES), 3), dtype=torch.int64, device=device)
    return _records[key]


def _svd_cuda(A: torch.Tensor, full_matrices: bool, site: str):
    if A.dtype != torch.float32:
        raise TypeError(f"svd: the CUDA route takes float32, got {A.dtype}")
    if A.dim() < 2 or not (1 <= A.shape[-2] <= MAX_DIM and 1 <= A.shape[-1] <= MAX_DIM):
        raise ValueError(f"svd: the CUDA route takes (..., m, n) with 1 <= m, n <= {MAX_DIM}, "
                         f"got {tuple(A.shape)}")
    dev = A.device
    *batch, m, n = A.shape
    k = min(m, n)
    U, S, V, info = _gesvdj(A)
    # JAX's semantics: a matrix that did not converge, or whose input is not finite, is
    # NaN in every output; one select on the device, inside the graph
    failed = (info != 0) | ~_finite(A.reshape(info.shape + (m, n)))
    _note(dev, site, failed, torch.where(info != 0, info, -1))
    U = U.mT                         # column-major U is the transpose of the buffer
    Vh = V                           # and the buffer of column-major V is V^T = Vh
    if not full_matrices:
        U, Vh = U[..., :k], Vh[:, :k, :]
    U, S, Vh = _nan_where(failed, U, S, Vh)
    return (U.reshape(*batch, m, U.shape[-1]), S.reshape(*batch, k),
            Vh.reshape(*batch, Vh.shape[-2], n))


def _gesvdj(A: torch.Tensor):
    """One ``gesvdjBatched`` launch on ``A (..., m, n)`` f32 on the card: the buffers as
    cuSOLVER leaves them, ``U (B, m, m)`` and ``V (B, n, n)`` column-major, ``S (B,
    min(m, n))`` and its codes ``info (B,)`` int32, nothing else done with them."""
    dev = A.device
    *batch, m, n = A.shape
    B, k = math.prod(batch), min(m, n)
    handle, params = _handle(dev)
    # column-major copies, as cuSOLVER takes and gives them (A is overwritten)
    a = A.reshape(B, m, n).mT.contiguous()
    S = torch.empty((B, k), dtype=torch.float32, device=dev)
    U = torch.empty((B, m, m), dtype=torch.float32, device=dev)
    V = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    info = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = kernels.library()
    wkey = (dev.index, _sweep_cap, m, n, B)
    if wkey not in _work:
        _outside_capture(dev, f"the workspace of {B} matrices of {m} x {n}")
        lwork = ctypes.c_int(0)
        kernels.check(lib.lcvo_svd_workspace(handle, params, a.data_ptr(), m, n, B, S.data_ptr(),
                                             U.data_ptr(), V.data_ptr(), ctypes.byref(lwork)),
                      "svd: cuSOLVER workspace query")
        _work[wkey] = (torch.empty((max(lwork.value, 1),), dtype=torch.float32, device=dev),
                       lwork.value)
    work, lwork = _work[wkey]
    with torch.cuda.device(dev):
        code = lib.lcvo_svd_gesvdj_batched(
            handle, params, a.data_ptr(), m, n, B, S.data_ptr(), U.data_ptr(), V.data_ptr(),
            work.data_ptr(), lwork, info.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(code, f"svd of {B} matrices of {m} x {n}")
    kernels.LAUNCHES["svd"] += 1
    return U, S, V, info

"""The SVD of small batched matrices, in a form a CUDA graph can hold.

The two-view bootstrap takes four SVDs (``ops/epipolar.py``: the eight-point fit, the
rank-2 projection and the essential decomposition; ``ops/five_point.py``: the null space
of the five-point system), which the JAX package leaves to XLA (``jnp.linalg.svd``).
On CUDA ``torch.linalg.svd`` runs cuSOLVER's ``gesvdjBatched`` for matrices of at most
32 x 32 and then copies the per-matrix convergence codes to the host to check them; no
CUDA graph can hold that copy, so ``two_view_init`` could not be captured (ROADMAP §C.8).

:func:`svd` has ``torch.linalg.svd``'s signature and results. A CPU tensor runs
:func:`svd_plain` (``torch.linalg.svd`` itself). A CUDA tensor launches
``csrc/svd.cu``, which makes torch's own ``gesvdjBatched`` call with torch's settings,
so the bits are ``torch.linalg.svd``'s, and leaves the codes on the device; anything
else raises. Each call keeps the first failure of its call site in a per-device record
on the device (:func:`record`); ``VisualOdometry.bootstrap`` reads the record with its
inlier count, in the read-back it makes anyway, and :func:`raise_if_failed` raises there
naming the call site and the matrix (another caller on the card reads :func:`record`
itself). Nothing is retried.

The handle, the parameter set, the workspace of each shape and the record are made at
the first call on a device, which must not be inside a capture (a compiled step's
warm-up is that first call).
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import torch

from lcvo_tpu_torch import kernels

# call sites, one row each of the record: [matrices that did not converge in the first
# call that had one, the first such matrix, its cuSOLVER code]
SITES = ("eight_point", "project_to_essential", "decompose_essential", "five_point")
MAX_DIM = 32          # gesvdjBatched's limit on m and n

_handles: dict = {}   # (device index, sweep cap) -> (handle, params)
_work: dict = {}      # (device index, sweep cap, m, n, batch) -> (workspace, lwork)
_records: dict = {}   # device index -> (len(SITES), 3) int64
_shapes: dict = {}    # call site -> the last input shape it passed
_sweep_cap = 0        # 0: cuSOLVER's default


class SVDNotConverged(RuntimeError):
    """An SVD on the card did not converge under cuSOLVER's tolerance and sweep cap."""


def svd_plain(A: torch.Tensor, full_matrices: bool = True):
    """``torch.linalg.svd``: the plain version (on CUDA it reads its convergence codes
    back, so it cannot be captured)."""
    return torch.linalg.svd(A, full_matrices=full_matrices)


def svd(A: torch.Tensor, full_matrices: bool = True, *, site: str):
    """``(U, S, Vh)`` of ``A (..., m, n)`` as ``torch.linalg.svd`` gives them; ``site``
    (one of :data:`SITES`) names the caller in the convergence record. CPU: :func:`svd_plain`. CUDA: the
    ``gesvdjBatched`` launcher (f32, m and n at most 32), or raise."""
    if A.device.type == "cpu":
        return svd_plain(A, full_matrices)
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


def record(device) -> torch.Tensor | None:
    """The convergence record of a CUDA device, ``(len(SITES), 3)`` int64 rows of
    [failed matrices, first failed matrix, its code] (zero: no failure); None on the CPU
    or before the first call on the device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _records.get(torch.cuda.current_device() if device.index is None else device.index)


def reset(device) -> None:
    """Clear the device's record (on the device; nothing is read)."""
    rec = record(device)
    if rec is not None:
        rec.zero_()


def raise_if_failed(rows) -> None:
    """Raise :class:`SVDNotConverged` for the first call site whose row of a record read
    back to the host (``record(device).cpu()``, any numeric dtype) shows a failure."""
    for site, (n, first, code) in zip(SITES, np.asarray(rows).reshape(len(SITES), 3)):
        if n > 0:
            raise SVDNotConverged(
                f"svd ({site}): {int(n)} of the matrices of shape {_shapes.get(site)} did not "
                f"converge; the first is matrix {int(first)} (cuSOLVER gesvdjBatched code "
                f"{int(code)})")


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
    if device.index not in _records:
        _outside_capture(device, "the convergence record")
        _records[device.index] = torch.zeros((len(SITES), 3), dtype=torch.int64, device=device)
    return _records[device.index]


def _svd_cuda(A: torch.Tensor, full_matrices: bool, site: str):
    if A.dtype != torch.float32:
        raise TypeError(f"svd: the CUDA route takes float32, got {A.dtype}")
    if A.dim() < 2 or not (1 <= A.shape[-2] <= MAX_DIM and 1 <= A.shape[-1] <= MAX_DIM):
        raise ValueError(f"svd: the CUDA route takes (..., m, n) with 1 <= m, n <= {MAX_DIM}, "
                         f"got {tuple(A.shape)}")
    if site not in SITES:
        raise ValueError(f"svd: unknown call site {site!r}; one of {SITES}")
    dev = A.device
    *batch, m, n = A.shape
    B, k = math.prod(batch), min(m, n)
    handle, params = _handle(dev)
    rec = _record_of(dev)
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
    kernels.check(code, f"svd ({site}) of {B} matrices of {m} x {n}")
    kernels.LAUNCHES["svd"] += 1
    _shapes[site] = tuple(A.shape)

    # the call site's first failure, kept on the device: [failed, first, its code]
    bad = info != 0
    first = torch.argmax(bad.to(torch.int32)).reshape(1)
    new = torch.cat([bad.sum().reshape(1), first, info.index_select(0, first).to(torch.int64)])
    row = rec[SITES.index(site)]
    row.copy_(torch.where(row[0] > 0, row, new))

    U = U.mT                         # column-major U is the transpose of the buffer
    Vh = V                           # and the buffer of column-major V is V^T = Vh
    if not full_matrices:
        U, Vh = U[..., :k], Vh[:, :k, :]
    return (U.reshape(*batch, m, U.shape[-1]), S.reshape(*batch, k),
            Vh.reshape(*batch, Vh.shape[-2], n))

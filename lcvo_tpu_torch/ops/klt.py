"""Pyramidal Lucas-Kanade tracking, batched over all tracks (port of
``lcvo_tpu/ops/klt.py``).

Inverse-compositional LK for pure translation. Per pyramid level each track's
neighbourhood is extracted once into a fixed (S, S) block (``_extract_blocks``: the
hand-written CUDA kernel on the card, its plain version on the CPU); the fixed-count
iteration loop then samples those blocks with two small interpolation products per
track,

    patch = R_y(dy) @ block @ C_x(dx)^T ,

where R_y/C_x are (w, S) two-tap bilinear matrices built from the subpixel offset.
Tracks whose displacement wanders outside the per-level block margin are clamped and
flagged through the status gates, as in the JAX package.

A level is three launches on the card: the two extractions and :func:`klt_iterate`, the
``torch.library`` operator ``lcvo::klt_iterate``. CUDA tensors launch
``csrc/klt_iterate.cu`` (the template, its Hessian, every iteration and the residual of
all tracks in one launch; counted in ``kernels.LAUNCHES["klt_iterate"]``), CPU tensors
run :func:`_iterate_level_plain`, the interpolation products above in PyTorch. Its batching
rule folds a vmapped stream dimension into the tracks, so the batched streams' step is
one launch a level for all streams.
"""

from __future__ import annotations

import torch

from lcvo_tpu_torch import kernels
# (N, S, S) integer-aligned blocks around centers (x, y) and their clamped origins:
# the hand-written CUDA kernel for CUDA tensors, its plain version for CPU tensors
from lcvo_tpu_torch.ops.klt_extract import extract_blocks as _extract_blocks

# default per-level wander margin (px) around the incoming displacement estimate
_MARGIN = 6


def _interp_matrix(off: torch.Tensor, w: int, s: int) -> torch.Tensor:
    """(N, w, s) two-tap bilinear interpolation matrices. Row i of matrix n selects
    ``(1-f) * block[floor(off_n)+i] + f * block[...+1]``; off-range rows read 0."""
    i0 = torch.floor(off)
    f = (off - i0)[:, None, None]
    rows = i0[:, None] + torch.arange(w, dtype=off.dtype, device=off.device)[None, :]
    cols = torch.arange(s, dtype=off.dtype, device=off.device)[None, None, :]
    eq0 = (cols == rows[:, :, None]).to(off.dtype)
    eq1 = (cols == (rows[:, :, None] + 1)).to(off.dtype)
    return eq0 * (1 - f) + eq1 * f


def _sample_blocks(blocks: torch.Tensor, qx, qy, w: int) -> torch.Tensor:
    """(N, w, w) f32 patches sampled from (N, S, S) blocks, window centered at
    (qx, qy) in block coordinates (top-left sample at q - (w-1)/2). Blocks stored in
    bf16 (``iter_dtype``) are widened to f32 for the products."""
    S = blocks.shape[-1]
    r = (w - 1) // 2
    Ry = _interp_matrix(qy - r, w, S).to(blocks.dtype).float()
    Cx = _interp_matrix(qx - r, w, S).to(blocks.dtype).float()
    return torch.bmm(torch.bmm(Ry, blocks.float()), Cx.transpose(1, 2))


def _track_level(prev_img, next_img, pts_l, d, window, iters, eps,
                 iter_dtype=torch.float32, margin: int = _MARGIN):
    """One pyramid level of IC-LK. pts_l, d in this level's pixel units.

    Returns (d, det_ok, sat, residual); residual is the mean |error| of the final
    patch."""
    w = window
    S = w + 2 + 2 * margin     # target block: sampling span + wander margin
    S_t = w + 2 + 2 * 2        # template block: sampled once, bilinear + gradient slack
    # blocks of the images edge-replicated by p, so a block fits around any in-image
    # point; the extraction clamps its reads, no padded copy is made
    p = (S + 1) // 2
    tblocks, torig = _extract_blocks(prev_img, pts_l, S_t, pad=p)
    nblocks, norig = _extract_blocks(next_img, pts_l + d, S, pad=p)
    return klt_iterate(tblocks, torig, nblocks, norig, pts_l, d, w, iters, eps, iter_dtype)


def _iterate_level_plain(tblocks, torig, nblocks, norig, pts_l, d, window, iters, eps,
                         iter_dtype=torch.float32):
    """Plain PyTorch version of :func:`klt_iterate`: the template and its Hessian from
    the template blocks, ``iters`` IC-LK iterations on the target blocks, the final
    residual and saturation flag."""
    w = window
    r = (w - 1) // 2
    S = nblocks.shape[-1]

    # template + central-difference gradients from one (w+2)-sized sample
    qt = pts_l - torig
    T2 = _sample_blocks(tblocks, qt[:, 0], qt[:, 1], w + 2)
    T = T2[:, 1: 1 + w, 1: 1 + w]
    gx = 0.5 * (T2[:, 1: 1 + w, 2: 2 + w] - T2[:, 1: 1 + w, 0:w])
    gy = 0.5 * (T2[:, 2: 2 + w, 1: 1 + w] - T2[:, 0:w, 1: 1 + w])
    hxx = torch.sum(gx * gx, dim=(1, 2))
    hxy = torch.sum(gx * gy, dim=(1, 2))
    hyy = torch.sum(gy * gy, dim=(1, 2))
    det = hxx * hyy - hxy * hxy
    det_ok = det > 1e-6
    safe_det = torch.where(det_ok, det, torch.ones_like(det))

    # loop-constant tensors in the storage dtype; math stays f32
    nblocks = nblocks.to(iter_dtype)
    T = T.to(iter_dtype)
    gx_i = gx.to(iter_dtype)
    gy_i = gy.to(iter_dtype)

    # displacement range whose sampling window stays inside the extracted block
    dd_min = norig + (r + 1) - pts_l
    dd_max = norig + (S - r - 2) - pts_l

    for _ in range(iters):
        q = pts_l + d - norig
        I = _sample_blocks(nblocks, q[:, 0], q[:, 1], w)
        e = I - T
        bx = torch.sum(gx_i * e, dim=(1, 2))
        by = torch.sum(gy_i * e, dim=(1, 2))
        ddx = (hyy * bx - hxy * by) / safe_det
        ddy = (-hxy * bx + hxx * by) / safe_det
        step = torch.stack([ddx, ddy], dim=-1)
        # per-track convergence mask (OpenCV's criteria eps): freeze, don't jitter
        live = det_ok & (torch.sum(step * step, dim=-1) >= eps * eps)
        d = d - torch.where(live[:, None], step, torch.zeros_like(step))
        d = torch.minimum(torch.maximum(d, dd_min), dd_max)
    q = pts_l + d - norig
    I = _sample_blocks(nblocks, q[:, 0], q[:, 1], w)
    residual = torch.mean(torch.abs(I - T), dim=(1, 2))
    # a displacement pinned at the block boundary wanted to leave the search region
    sat = torch.any((d <= dd_min + 1e-3) | (d >= dd_max - 1e-3), dim=-1)
    return d, det_ok, sat, residual


def klt_iterate(tblocks, torig, nblocks, norig, pts_l, d, window: int, iters: int, eps: float,
                iter_dtype=torch.float32):
    """Everything one pyramid level does after its two block extractions, for N tracks.

    ``tblocks`` (N, S_t, S_t) and ``nblocks`` (N, S, S): the template and target blocks
    (f32 or bf16, one dtype), ``torig`` / ``norig`` (N, 2) their origins, ``pts_l`` and
    ``d`` (N, 2) the points and incoming displacements in this level's pixels, all f32
    but the blocks. ``window`` odd, with S_t and S at least ``window + 2``. Returns
    (d (N, 2), det_ok (N,), sat (N,), residual (N,)).

    CUDA tensors launch ``csrc/klt_iterate.cu`` (one launch; windows up to 31, blocks
    up to 128), CPU tensors run :func:`_iterate_level_plain`."""
    tensors = (tblocks, torig, nblocks, norig, pts_l, d)
    if any(t.device != tblocks.device for t in tensors):
        raise ValueError("klt_iterate: tensors on " + ", ".join(str(t.device) for t in tensors)
                         + ": all must be on one device")
    if tblocks.dtype not in (torch.float32, torch.bfloat16) or nblocks.dtype != tblocks.dtype:
        raise TypeError(f"klt_iterate takes f32 or bf16 blocks of one dtype, got "
                        f"{tblocks.dtype} and {nblocks.dtype}")
    if any(t.dtype != torch.float32 for t in (torig, norig, pts_l, d)):
        raise TypeError("klt_iterate takes f32 origins, points and displacements")
    idt = getattr(torch, iter_dtype) if isinstance(iter_dtype, str) else iter_dtype
    if idt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"klt_iterate iterates in f32 or bf16, got {iter_dtype}")
    N = pts_l.shape[0] if pts_l.dim() == 2 else -1
    if (tblocks.dim() != 3 or nblocks.dim() != 3 or tblocks.shape[1] != tblocks.shape[2]
            or nblocks.shape[1] != nblocks.shape[2] or N < 0
            or any(t.shape != (N, 2) for t in (torig, norig, pts_l, d))
            or tblocks.shape[0] != N or nblocks.shape[0] != N):
        raise ValueError(f"klt_iterate: blocks (N, S, S) and (N, 2) origins, points and "
                         f"displacements, got {[tuple(t.shape) for t in tensors]}")
    if window < 1 or window % 2 == 0 or min(tblocks.shape[1], nblocks.shape[1]) < window + 2:
        raise ValueError(f"klt_iterate: window {window} must be odd and fit blocks of "
                         f"{tblocks.shape[1]} and {nblocks.shape[1]} with a sample to spare")
    if iters < 0:
        raise ValueError(f"klt_iterate: iters must be >= 0, got {iters}")
    return torch.ops.lcvo.klt_iterate(tblocks, torig, nblocks, norig, pts_l, d, window, iters,
                                      float(eps), idt)


@torch.library.custom_op("lcvo::klt_iterate", mutates_args=(), device_types="cpu")
def _klt_iterate_op(tblocks: torch.Tensor, torig: torch.Tensor, nblocks: torch.Tensor,
                    norig: torch.Tensor, pts_l: torch.Tensor, d: torch.Tensor, window: int,
                    iters: int, eps: float, iter_dtype: torch.dtype
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    out = _iterate_level_plain(tblocks, torig, nblocks, norig, pts_l, d, window, iters, eps,
                               iter_dtype)
    # with no iteration the plain version hands back d itself: an operator's output
    # may not alias its input
    return (out[0].clone() if out[0] is d else out[0],) + tuple(out[1:])


@_klt_iterate_op.register_kernel("cuda")
def _klt_iterate_cuda(tblocks, torig, nblocks, norig, pts_l, d, window, iters, eps, iter_dtype):
    """Launch ``csrc/klt_iterate.cu`` once over every track."""
    N = pts_l.shape[0]
    dev = pts_l.device
    d_out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    det_ok = torch.empty((N,), dtype=torch.bool, device=dev)
    sat = torch.empty((N,), dtype=torch.bool, device=dev)
    residual = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return d_out, det_ok, sat, residual
    if window > 31 or max(tblocks.shape[1], nblocks.shape[1]) > 128:
        raise ValueError(f"klt_iterate kernel takes windows up to 31 and blocks up to 128, "
                         f"got {window}, {tblocks.shape[1]}, {nblocks.shape[1]}")
    lib = kernels.library()
    args = [x.contiguous() for x in (tblocks, torig, nblocks, norig, pts_l, d)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lcvo_klt_iterate(
            *(x.data_ptr() for x in args), N, window, tblocks.shape[1], nblocks.shape[1],
            iters, eps * eps, int(tblocks.dtype == torch.bfloat16),
            int(iter_dtype == torch.bfloat16), d_out.data_ptr(), det_ok.data_ptr(),
            sat.data_ptr(), residual.data_ptr(), stream)
    kernels.check(code, "klt_iterate")
    kernels.LAUNCHES["klt_iterate"] += 1
    return d_out, det_ok, sat, residual


def _klt_iterate_vmap(info, in_dims, tblocks, torig, nblocks, norig, pts_l, d, window, iters,
                      eps, iter_dtype):
    """B calls are one call on the B * N tracks; an argument not batched is broadcast."""
    B = info.batch_size

    def flat(x, dim):
        x = x.expand((B,) + x.shape) if dim is None else x.movedim(dim, 0)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    args = [flat(x, dim) for x, dim in zip((tblocks, torig, nblocks, norig, pts_l, d), in_dims)]
    d, det_ok, sat, residual = torch.ops.lcvo.klt_iterate(*args, window, iters, eps, iter_dtype)
    return ((d.reshape(B, -1, 2), det_ok.reshape(B, -1), sat.reshape(B, -1),
             residual.reshape(B, -1)), (0, 0, 0, 0))


torch.library.register_vmap("lcvo::klt_iterate", _klt_iterate_vmap)


def pyramidal_klt(
    prev_pyramid: tuple,
    next_pyramid: tuple,
    pts: torch.Tensor,
    window: int = 21,
    iters: int = 10,
    max_residual: float = 12.0,
    max_displacement: float = 60.0,
    border: int = 12,
    eps: float = 0.01,
    iter_dtype: str = "float32",
    margin=_MARGIN,
    init_d: torch.Tensor | None = None,
    iters_coarse: int = 0,
):
    """Track ``pts`` (N, 2) [x, y] from the previous frame into the next.

    ``init_d`` (N, 2), full-resolution px: optional motion prior. ``margin`` is an int
    or a per-level tuple (index = level, 0 = finest). ``iters_coarse`` (0 = ``iters``)
    is the iteration count at levels > 0.

    Returns (new_pts (N, 2), status (N,) bool, residual (N,)). ``status`` combines a
    well-conditioned Hessian at every level, no saturation at level 0, final residual
    below ``max_residual``, displacement below ``max_displacement`` and the new
    position inside the image border.
    """
    levels = len(prev_pyramid)
    margins = (margin,) * levels if isinstance(margin, int) else tuple(margin)
    assert len(margins) == levels, (margins, levels)
    N = pts.shape[0]
    idt = getattr(torch, iter_dtype) if isinstance(iter_dtype, str) else iter_dtype
    if init_d is None:
        d = torch.zeros((N, 2), dtype=pts.dtype, device=pts.device)
    else:
        d = init_d.to(pts.dtype) * (2.0 ** -(levels - 1))
    ok = torch.ones((N,), dtype=torch.bool, device=pts.device)
    residual = torch.zeros((N,), dtype=pts.dtype, device=pts.device)
    for l in reversed(range(levels)):
        pts_l = pts * (2.0 ** -l)
        d, det_ok, sat, residual = _track_level(
            prev_pyramid[l], next_pyramid[l], pts_l, d, window,
            iters if (l == 0 or not iters_coarse) else iters_coarse, eps,
            iter_dtype=idt, margin=margins[l],
        )
        ok = ok & det_ok
        if l == 0:
            ok = ok & ~sat
        if l > 0:
            d = d * 2.0
    new_pts = pts + d
    H, W = prev_pyramid[0].shape
    inb = (
        (new_pts[:, 0] >= border)
        & (new_pts[:, 0] < W - border)
        & (new_pts[:, 1] >= border)
        & (new_pts[:, 1] < H - border)
    )
    disp_ok = torch.sum(d * d, dim=-1) < max_displacement * max_displacement
    status = ok & inb & disp_ok & (residual < max_residual)
    return new_pts, status, residual

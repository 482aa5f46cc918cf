"""Bilinear sampling and patch gathers on tensors: counterpart of
``lcvo_tpu/ops/interp.py``.

Not on the odometry path, in either package: the tracker reads integer-aligned blocks
(``ops/klt_extract.py``, ``ops/klt.py``) and samples them with static shifts. These are
the plain per-element formulations that the blocks replaced, kept as the simplest
reference semantics for tests and micro-benchmarks. Every function is plain PyTorch on
the tensors it is given (any device), differentiable by autograd in the image and in the
float coordinates.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (H, W) at float coords (ys, xs) of any matching shape.

    Out-of-bounds samples clamp to the border (callers mask tracks near the border
    separately). Returns samples with the shape of ``ys``."""
    H, W = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 2)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 2)
    Ia = img[y0i, x0i]
    Ib = img[y0i, x0i + 1]
    Ic = img[y0i + 1, x0i]
    Id = img[y0i + 1, x0i + 1]
    top = Ia * (1 - wx) + Ib * wx
    bot = Ic * (1 - wx) + Id * wx
    return top * (1 - wy) + bot * wy


def patch_grid(window: int, dtype=torch.float32, device=None):
    """Centered offsets for a window x window patch: two (window, window) tensors
    (dy, dx), ``ij`` indexing."""
    r = (window - 1) / 2.0
    o = torch.arange(window, dtype=dtype, device=device) - r
    dy, dx = torch.meshgrid(o, o, indexing="ij")
    return dy, dx


def _patch_coords(img: torch.Tensor, pts: torch.Tensor, window: int):
    dy, dx = patch_grid(window, img.dtype, img.device)
    ys = pts[:, 1][:, None, None] + dy[None]
    xs = pts[:, 0][:, None, None] + dx[None]
    return ys, xs


def gather_patches(img: torch.Tensor, pts: torch.Tensor, window: int) -> torch.Tensor:
    """Bilinear patches around ``pts`` (N, 2) [x, y] -> (N, window, window)."""
    ys, xs = _patch_coords(img, pts, window)
    return bilinear_sample(img, ys, xs)


def extract_blocks(img: torch.Tensor, origins: torch.Tensor, size: int) -> torch.Tensor:
    """Integer-aligned (size, size) blocks at ``origins`` (N, 2) int [x, y] top-left
    corners, with ``lax.dynamic_slice``'s index rule: a negative start counts from the
    end (H or W is added to it), then every start is clamped into [0, H - size] x
    [0, W - size]. Returns (N, size, size)."""
    H, W = img.shape
    o = origins.to(torch.int64)
    oy = torch.clamp(torch.where(o[:, 1] < 0, o[:, 1] + H, o[:, 1]), 0, H - size)
    ox = torch.clamp(torch.where(o[:, 0] < 0, o[:, 0] + W, o[:, 0]), 0, W - size)
    r = torch.arange(size, device=img.device)
    rows = (oy[:, None] + r[None])[:, :, None]
    cols = (ox[:, None] + r[None])[:, None, :]
    return img[rows, cols]


def sample_blocks_bilinear(blocks: torch.Tensor, frac: torch.Tensor, out: int) -> torch.Tensor:
    """Bilinear-resample (N, S, S) blocks at a per-block constant subpixel shift.

    ``frac`` (N, 2) [fx, fy] in [0, 1); returns (N, out, out) sampled at
    (1 + fx + i, 1 + fy + j) block coords, so the caller's block origin is
    (floor(x) - 1 - r) for sample 0 to land at (x - r). The four taps are static
    slices."""
    fx = frac[:, 0][:, None, None]
    fy = frac[:, 1][:, None, None]
    a = blocks[:, 1: 1 + out, 1: 1 + out]
    b = blocks[:, 1: 1 + out, 2: 2 + out]
    c = blocks[:, 2: 2 + out, 1: 1 + out]
    d = blocks[:, 2: 2 + out, 2: 2 + out]
    top = a * (1 - fx) + b * fx
    bot = c * (1 - fx) + d * fx
    return top * (1 - fy) + bot * fy


def gather_patches_with_grad(img: torch.Tensor, pts: torch.Tensor, window: int):
    """Patches plus central-difference image gradients at the same sample points.

    Returns (patch, gx, gy), each (N, window, window)."""
    ys, xs = _patch_coords(img, pts, window)
    p = bilinear_sample(img, ys, xs)
    gx = 0.5 * (bilinear_sample(img, ys, xs + 1.0) - bilinear_sample(img, ys, xs - 1.0))
    gy = 0.5 * (bilinear_sample(img, ys + 1.0, xs) - bilinear_sample(img, ys - 1.0, xs))
    return p, gx, gy

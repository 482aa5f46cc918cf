"""Shi-Tomasi / Harris corner detection with static-shape grid NMS (port of
``lcvo_tpu/ops/harris.py``).

Structure-tensor score → 3x3 local-max suppression → per-grid-cell top-k → global
top-``max_corners`` with a validity mask. Minimum distance to existing points is a
batched distance test. ``torch.topk`` may order ties differently from ``lax.top_k``;
the detected point *set* is what matches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lcvo_tpu_torch.ops.pyramid import box_filter, sobel_gradients


def corner_score(img: torch.Tensor, window: int = 3, method: str = "shi", harris_k: float = 0.04):
    """Per-pixel corner response: 'shi' = min eigenvalue of the 2x2 structure tensor,
    'harris' = det - k*trace^2."""
    gx, gy = sobel_gradients(img)
    sxx = box_filter(gx * gx, window)
    syy = box_filter(gy * gy, window)
    sxy = box_filter(gx * gy, window)
    if method == "harris":
        det = sxx * syy - sxy * sxy
        tr = sxx + syy
        return det - harris_k * tr * tr
    half_tr = 0.5 * (sxx + syy)
    root = torch.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy, min=0.0))
    return half_tr - root


def _local_max(score: torch.Tensor) -> torch.Tensor:
    """True where the pixel is the max of its 3x3 neighbourhood (−inf padding)."""
    m = F.max_pool2d(score[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    return score >= m


def detect_corners(
    img: torch.Tensor,
    max_corners: int = 600,
    quality_level: float = 0.03,
    cells_y: int = 12,
    cells_x: int = 32,
    cells_topk: int = 4,
    method: str = "shi",
    window: int = 3,
    border: int = 8,
    harris_k: float = 0.04,
):
    """Detect up to ``max_corners`` corners. Returns (pts (N,2) [x,y] float32,
    score (N,), valid (N,) bool) with N = max_corners, strongest first."""
    H, W = img.shape
    dev = img.device
    score = corner_score(img, window=window, method=method, harris_k=harris_k)
    is_max = _local_max(score)

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_border = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    masked = score.masked_fill(~(is_max & in_border), float("-inf"))

    # partition into cells (pad so H, W divide evenly)
    ch = -(-H // cells_y)
    cw = -(-W // cells_x)
    # out of place: a write into a fresh buffer is refused under torch.func.vmap
    padded = F.pad(masked, (0, cells_x * cw - W, 0, cells_y * ch - H), value=float("-inf"))
    cells = padded.reshape(cells_y, ch, cells_x, cw).permute(0, 2, 1, 3).reshape(cells_y, cells_x, ch * cw)
    top_vals, top_idx = torch.topk(cells, cells_topk, dim=-1)  # (cy, cx, k)

    cy = torch.arange(cells_y, device=dev)[:, None, None]
    cx = torch.arange(cells_x, device=dev)[None, :, None]
    py = cy * ch + top_idx // cw
    px = cx * cw + top_idx % cw

    flat_vals = top_vals.reshape(-1)
    flat_y = py.reshape(-1).to(torch.float32)
    flat_x = px.reshape(-1).to(torch.float32)

    k = min(max_corners, flat_vals.shape[0])
    sel_vals, sel = torch.topk(flat_vals, k)
    pts = torch.stack([flat_x[sel], flat_y[sel]], dim=-1)
    max_score = torch.clamp(torch.max(sel_vals), min=1e-12)
    valid = torch.isfinite(sel_vals) & (sel_vals > quality_level * max_score)
    if k < max_corners:  # pad up to static capacity
        pad = max_corners - k
        pts = torch.cat([pts, torch.zeros((pad, 2), dtype=pts.dtype, device=dev)], 0)
        sel_vals = torch.cat([sel_vals, torch.full((pad,), float("-inf"), dtype=sel_vals.dtype, device=dev)], 0)
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)], 0)
    return pts, sel_vals, valid


def suppress_near_existing(pts, pts_valid, existing, existing_valid, min_distance: float):
    """Drop new detections within ``min_distance`` px of any valid existing point
    (batched all-pairs distance test)."""
    d2 = torch.sum((pts[:, None, :] - existing[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(existing_valid[None, :], d2, torch.full_like(d2, float("inf")))
    near = torch.any(d2 < min_distance * min_distance, dim=1)
    return pts_valid & ~near

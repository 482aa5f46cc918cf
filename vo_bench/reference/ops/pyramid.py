"""Image pyramids and small separable filters (port of ``lcvo_tpu/ops/pyramid.py``).

Filters are shift-and-add over static slices of the zero-padded image (SAME zero
padding), as in the JAX package. ``downsample2`` is blur + 2x decimation as two products
with constant band matrices; they sit outside any kernel and go to ``torch.matmul`` in
full fp32 (the package turns TF32 off at import).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# binomial [1,4,6,4,1]/16 — the classic pyramid kernel
_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _conv1d(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """1D correlation along ``axis`` with static kernel ``k`` (numpy), SAME zero
    padding, as static shifted slices + multiply-add."""
    k = np.asarray(k)
    r = (len(k) - 1) // 2
    H, W = img.shape
    p = F.pad(img, (0, 0, r, r) if axis == 0 else (r, r, 0, 0))
    out = None
    for j, kj in enumerate(k):
        if kj == 0.0:
            continue
        sl = p[j: j + H, :] if axis == 0 else p[:, j: j + W]
        term = sl if kj == 1.0 else float(kj) * sl
        out = term if out is None else out + term
    return out


def _sep_conv(img: torch.Tensor, k) -> torch.Tensor:
    """Separable 2D filter of an (H, W) image with 1D kernel k, SAME zero padding."""
    return _conv1d(_conv1d(img, k, 0), k, 1)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with a radius-3*sigma truncated kernel."""
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return _sep_conv(img, k / np.sum(k))


def _decim_band(n: int, k) -> np.ndarray:
    """(ceil(n/2), n) decimating band matrix: row i holds kernel ``k`` centered at
    column 2i (zero padding)."""
    k = np.asarray(k, np.float64)
    r = (len(k) - 1) // 2
    m = np.zeros(((n + 1) // 2, n), np.float32)
    for i in range((n + 1) // 2):
        for j, kj in enumerate(k):
            c = 2 * i + j - r
            if 0 <= c < n:
                m[i, c] = kj
    return m


_BANDS: dict = {}


def _band(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _BANDS:
        _BANDS[key] = torch.from_numpy(_decim_band(n, _K5)).to(device)
    return _BANDS[key]


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Binomial blur + 2x decimation as two band-matrix products (fp32)."""
    H, W = img.shape
    Dy = _band(H, img.device)
    Dx = _band(W, img.device)
    t = torch.matmul(Dy, img.float())
    return torch.matmul(t, Dx.T).to(img.dtype)


def build_pyramid(img: torch.Tensor, levels: int) -> tuple:
    """(H, W) image → tuple of ``levels`` tensors, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return tuple(pyr)


def sobel_gradients(img: torch.Tensor):
    """Sobel x/y gradients (smooth [1,2,1]/4 x diff [-1,0,1]/2), SAME padding."""
    d = np.array([-1.0, 0.0, 1.0]) * 0.5
    s = np.array([1.0, 2.0, 1.0]) * 0.25
    gx = _conv1d(_conv1d(img, s, 0), d, 1)
    gy = _conv1d(_conv1d(img, d, 0), s, 1)
    return gx, gy


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 box sum via two 1D shift-and-add passes."""
    return _sep_conv(img, np.ones((2 * radius + 1,)))

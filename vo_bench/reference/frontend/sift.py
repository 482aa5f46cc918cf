"""SIFT-class scale-space detector + 128-d descriptor with fixed shapes (port of
``lcvo_tpu/frontend/sift.py``).

The equivalent of ``cv2.SIFT`` detect/compute, with the JAX package's deliberate
differences from OpenCV:

- **Fixed keypoint count**: each octave keeps a fixed top-k by |DoG| response with a
  validity mask, so nothing in the detect+describe path has a data-dependent shape
  and nothing waits for the device.
- No initial 2x upsampling octave.
- Orientation: a single dominant orientation per keypoint, parabolic peak refinement.
- Descriptor: the classic 4x4 spatial x 8 orientation-bin histogram (128-d), built
  from a FIXED 16x16 rotated sample grid. The spatial soft-assignment matrix is a
  constant, so binning is one (samples x bins) product.

The scale space is built with dense band-matrix products, the histograms with one-hot
products (deterministic, unlike an atomic scatter-add); they sit outside any kernel in
the JAX package and are plain ``torch`` here. Per keypoint one integer-aligned block is
cut from its layer by ``extract_blocks`` (the hand-written CUDA kernel on the card),
and the orientation and descriptor samples are bilinear reads of that block.

Everything is fp32; images are expected in [0, 255] (normalized internally). Constants
(band matrices, sample grids) are built once per device and image size
(:func:`prepare` builds them ahead of the first frame).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vo_bench.reference.core.constants import cached, on_device
from vo_bench.reference.ops.klt_extract import extract_blocks
from vo_bench.reference.ops.pyramid import gaussian_blur


class SiftFeatures(NamedTuple):
    """Fixed-capacity keypoint table (strongest-first within each octave block)."""

    pts: torch.Tensor     # (N, 2) [x, y] full-resolution pixel coords
    sigma: torch.Tensor   # (N,) full-resolution scale
    ori: torch.Tensor     # (N,) orientation, radians
    score: torch.Tensor   # (N,) |DoG| response
    valid: torch.Tensor   # (N,) bool
    desc: torch.Tensor    # (N, 128) L2-normalized descriptor (zeros if not computed)


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------


def _gauss_band(n: int, sigma: float) -> np.ndarray:
    """(n, n) banded Gaussian convolution matrix (zero padding, radius 3*sigma).

    Row i holds the truncated kernel centered at i: multiplying by it IS the 1D blur.
    """
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    m = np.zeros((n, n), np.float64)
    idx = np.arange(n)
    for j, kj in enumerate(k):
        off = j - radius
        src = idx + off
        ok = (src >= 0) & (src < n)
        m[idx[ok], src[ok]] = kj
    # Renormalize border rows (truncated taps) so the widest direct kernels don't
    # attenuate a border band wider than the detection border and fake DoG gradients
    # there. Every row keeps at least the center tap, so the sum is > 0.
    m /= m.sum(axis=1, keepdims=True)
    return m.astype(np.float32)


def _level_sigmas(s: int, sigma0: float) -> tuple:
    """Blur increments that take the octave base (sigma0) to levels 1..s+2."""
    return tuple(
        float(np.sqrt(max((sigma0 * 2.0 ** (i / s)) ** 2 - sigma0 ** 2, 1e-4)))
        for i in range(1, s + 3))


def _octave_bands(H: int, W: int, s: int, sigma0: float, device):
    """(My (s+2, H, H), MxT (s+2, W, W)): the stacked band matrices of one octave, the
    x one already transposed for the right-hand product."""
    sig = _level_sigmas(s, sigma0)
    My = cached(("sift_band_y", H, sig), device,
                lambda: np.stack([_gauss_band(H, d) for d in sig]))
    MxT = cached(("sift_band_xT", W, sig), device,
                 lambda: np.stack([_gauss_band(W, d).T for d in sig]))
    return My, MxT


def build_scale_space(img: torch.Tensor, octaves: int, s: int, sigma0: float = 1.6):
    """Gaussian scale space: list over octaves of (s+3, H_o, W_o) stacks.

    G[i] has absolute sigma sigma0 * 2^(i/s) within the octave; the next octave
    starts from G[s] downsampled 2x (same absolute blur, half resolution).

    Each level is blurred **directly from the octave base** (Gaussian composition: the
    increment is sqrt(sig_i^2 - sigma0^2)) with banded convolution matrices: two
    batched fp32 products per octave. Gaussian levels are ~[0, 1] and the DoG contrast
    gate (contrast_thresh/s ~ 0.013) compares differences far below reduced-precision
    rounding, so the products stay in full fp32 (the package turns TF32 off).
    """
    x = img / 255.0
    base = gaussian_blur(x, max(np.sqrt(max(sigma0 ** 2 - 0.25, 0.01)), 0.3))
    space = []
    for _ in range(octaves):
        H, W = base.shape
        My, MxT = _octave_bands(H, W, s, sigma0, base.device)
        t = torch.matmul(My, base)      # blur along y: (s+2, H, W)
        lv = torch.bmm(t, MxT)          # blur along x
        stack = torch.cat([base[None], lv], dim=0)  # (s+3, H, W)
        space.append(stack)
        # next octave base: 2x decimation of G[s] (rows and columns 0, 2, 4, ...)
        base = stack[s][::2, ::2].contiguous()
    return space


def _stack_gradients(stack: torch.Tensor):
    """Central-difference gradients of a (L, H, W) stack. Returns (gx, gy). The roll
    wraps at the border, as in the JAX package; the detection border hides it."""
    gx = 0.5 * (torch.roll(stack, -1, dims=2) - torch.roll(stack, 1, dims=2))
    gy = 0.5 * (torch.roll(stack, -1, dims=1) - torch.roll(stack, 1, dims=1))
    return gx, gy


def _bilinear_stack(stack: torch.Tensor, li: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Bilinear sample a (L, H, W) stack at per-point layer ``li`` (N,) int and float
    coords ys/xs (N, ...). One gather on the (L*H, W) view, no per-layer copies; the
    sampling itself reads blocks (``_sample_blocks_nk``), this is the per-element form
    the JAX package keeps beside it."""
    L, H, W = stack.shape
    flat = stack.reshape(L * H, W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 2)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 2)
    extra = ys.dim() - 1
    row = li.to(torch.int64).reshape(li.shape + (1,) * extra) * H + y0i
    Ia = flat[row, x0i]
    Ib = flat[row, x0i + 1]
    Ic = flat[row + 1, x0i]
    Id = flat[row + 1, x0i + 1]
    top = Ia * (1 - wx) + Ib * wx
    bot = Ic * (1 - wx) + Id * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------------------------
# Detection (per octave): 3D extrema -> gates -> top-k
# ---------------------------------------------------------------------------


def _topk_volume(score: torch.Tensor, k: int):
    """Top-k over a (L, H, W) score volume, returning (vals, flat indices).

    The JAX package calls ``lax.approx_max_k``, which is exact off the TPU; this is
    the exact top-k. Equal scores may come out in another order."""
    return torch.topk(score.reshape(-1), k)


def _detect_octave(gstack: torch.Tensor, topk: int, contrast_thresh: float,
                   edge_thresh: float, s: int, border: int):
    """One octave: returns (xy (k,2) octave-res, layer (k,), score (k,), valid (k,))."""
    D = gstack[1:] - gstack[:-1]  # (s+2, H, W) DoG
    _, H, W = D.shape
    dev = D.device

    # 3x3x3 neighbourhood extrema, separably: a 3x3 window max/min per layer (padded
    # with -inf/+inf), then an elementwise max/min over the 3 adjacent layers. Extrema
    # can only live in layers 1..s (they need DoG neighbours above and below), so only
    # those are formed.
    m2max = F.max_pool2d(D[None], kernel_size=3, stride=1, padding=1)[0]
    m2min = -F.max_pool2d(-D[None], kernel_size=3, stride=1, padding=1)[0]
    nmax = torch.maximum(torch.maximum(m2max[:-2], m2max[1:-1]), m2max[2:])
    nmin = torch.minimum(torch.minimum(m2min[:-2], m2min[1:-1]), m2min[2:])
    Dm = D[1: s + 1]
    is_ext = (Dm >= nmax) | (Dm <= nmin)

    # edge response: 2x2 spatial Hessian ratio gate (Lowe's r-test, r = edge_thresh)
    Dxx = torch.roll(Dm, -1, 2) + torch.roll(Dm, 1, 2) - 2 * Dm
    Dyy = torch.roll(Dm, -1, 1) + torch.roll(Dm, 1, 1) - 2 * Dm
    Dxy = 0.25 * (
        torch.roll(Dm, (-1, -1), (1, 2)) + torch.roll(Dm, (1, 1), (1, 2))
        - torch.roll(Dm, (-1, 1), (1, 2)) - torch.roll(Dm, (1, -1), (1, 2))
    )
    tr = Dxx + Dyy
    det = Dxx * Dyy - Dxy * Dxy
    r = edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    contrast_ok = torch.abs(Dm) > contrast_thresh / s

    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    in_border = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)

    sel = is_ext & edge_ok & contrast_ok & in_border
    score = torch.abs(Dm).masked_fill(~sel, float("-inf"))
    vals, idx = _topk_volume(score, topk)
    li = idx // (H * W) + 1
    yi = (idx % (H * W)) // W
    xi = idx % W
    valid = torch.isfinite(vals)

    # 2D subpixel refinement (quadratic fit in x, y on the selected layer) from the
    # 3x3 neighbourhood of each keypoint, read once
    off = torch.arange(-1, 2, device=dev)
    yc = torch.clamp(yi[:, None] + off[None, :], 0, H - 1)
    xc = torch.clamp(xi[:, None] + off[None, :], 0, W - 1)
    nb = D[li[:, None, None], yc[:, :, None], xc[:, None, :]]   # (k, 3, 3) [dy+1, dx+1]

    def at(dy, dx):
        return nb[:, dy + 1, dx + 1]

    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    hxx = at(0, 1) + at(0, -1) - 2 * at(0, 0)
    hyy = at(1, 0) + at(-1, 0) - 2 * at(0, 0)
    hxy = 0.25 * (at(1, 1) + at(-1, -1) - at(1, -1) - at(-1, 1))
    det2 = hxx * hyy - hxy * hxy
    det_ok = torch.abs(det2) > 1e-12
    safe = torch.where(det_ok, det2, torch.ones_like(det2))
    ox = -(hyy * gx - hxy * gy) / safe
    oy = -(-hxy * gx + hxx * gy) / safe
    good_off = (torch.abs(ox) < 1.0) & (torch.abs(oy) < 1.0) & det_ok
    ox = torch.where(good_off, ox, torch.zeros_like(ox))
    oy = torch.where(good_off, oy, torch.zeros_like(oy))

    xy = torch.stack([xi + ox, yi + oy], dim=-1).to(torch.float32)
    return xy, li, vals, valid


# ---------------------------------------------------------------------------
# Orientation + descriptor (per octave, batched over that octave's keypoints)
# ---------------------------------------------------------------------------

_N_ORI_BINS = 36
_ORI_GRID = 16           # 16x16 orientation sample grid
_DESC_GRID = 16          # 16x16 sample grid
_DESC_SPATIAL = 4        # 4x4 spatial bins
_DESC_ORI = 8            # 8 orientation bins


def _make_desc_constants():
    """Constants of the descriptor sample grid.

    Samples live at fixed subregion-space coords q in [-2, 2) (units of one spatial
    bin = 3*sigma); the soft spatial assignment of each of the 256 samples onto the
    4x4 bins is keypoint-independent -> one constant (256, 16) matrix.
    """
    idx = (np.arange(_DESC_GRID) + 0.5) / _DESC_GRID * 4.0 - 2.0  # bin units, [-2, 2)
    qu, qv = np.meshgrid(idx, idx, indexing="xy")
    qu = qu.reshape(-1)
    qv = qv.reshape(-1)  # (256,)
    # Gaussian window over the descriptor support (Lowe: sigma = half window width)
    wgauss = np.exp(-(qu ** 2 + qv ** 2) / (2 * (2.0 ** 2)))
    # soft assign q -> bins {0,1,2,3} at centers {-1.5,-0.5,.5,1.5}
    W = np.zeros((_DESC_GRID * _DESC_GRID, _DESC_SPATIAL, _DESC_SPATIAL))
    for k in range(qu.shape[0]):
        ru = qu[k] + 1.5
        rv = qv[k] + 1.5
        u0 = int(np.floor(ru))
        v0 = int(np.floor(rv))
        fu = ru - u0
        fv = rv - v0
        for du, wu in ((0, 1 - fu), (1, fu)):
            for dv, wv in ((0, 1 - fv), (1, fv)):
                u, v = u0 + du, v0 + dv
                if 0 <= u < 4 and 0 <= v < 4:
                    W[k, v, u] = wu * wv * wgauss[k]
    return (
        np.stack([qu, qv], -1).astype(np.float32),              # (256, 2)
        W.reshape(-1, 16).astype(np.float32),                   # (256, 16)
    )


def _make_ori_constants():
    """The 16x16 orientation sample grid: offsets (256, 2) in grid steps and the
    Gaussian weight (256,) of each sample."""
    P = _ORI_GRID
    grid = np.arange(P, dtype=np.float32) - np.float32((P - 1) / 2.0)
    du, dv = np.meshgrid(grid, grid, indexing="xy")
    du, dv = du.reshape(-1), dv.reshape(-1)
    w = np.exp(-(du ** 2 + dv ** 2) / np.float32(2 * (P / 3.0) ** 2))
    return np.stack([du, dv], -1).astype(np.float32), w.astype(np.float32)


_DESC_Q, _DESC_W_SPATIAL = _make_desc_constants()
_ORI_OFFS, _ORI_W = _make_ori_constants()


def stack_centers(g_st: torch.Tensor, li: torch.Tensor, xy: torch.Tensor, S: int):
    """What ``extract_blocks`` is given for keypoints ``xy`` (N, 2) on layers ``li`` of a
    (L, H, W) stack: ``(flat (L*Hp, W), centers (N, 2), layer offsets (N,))``.

    Each layer is edge-padded in y by ``p = S//2 + 2`` so a block never crosses into a
    neighbouring layer of the flattened view; the layer is folded into the y center in
    f32, ``li*Hp + p + y``, in the JAX package's order of operations. ``offsets`` is
    what takes a flat origin row back to the layer's own rows."""
    L, H, W = g_st.shape
    p = S // 2 + 2
    padded = F.pad(g_st[None], (0, 0, p, p), mode="replicate")[0]
    Hp = H + 2 * p
    lf = li.to(xy.dtype) * Hp
    centers = torch.stack([xy[:, 0], lf + p + xy[:, 1]], dim=-1)
    return padded.reshape(L * Hp, W), centers, (lf, p)


def _extract_stack_blocks(g_st: torch.Tensor, li: torch.Tensor, xy: torch.Tensor, S: int):
    """(N, S, S) integer-aligned blocks around ``xy`` from each keypoint's layer ``li``
    of a (L, H, W) stack: ONE extraction per keypoint; the orientation/descriptor
    sampling then reads the blocks (the same block-once formulation as the KLT
    tracker, :mod:`vo_bench.reference.ops.klt`).

    x origins clamp into the image, y origins into the layer's edge-padded rows.
    Returns (blocks, ox, oy) with float block origins in octave pixel coordinates. The
    kernel takes any N, so the centers are not filled up to a multiple of 8.
    """
    flat, centers, (lf, p) = stack_centers(g_st, li, xy, S)
    blocks, orig = extract_blocks(flat, centers, S)
    return blocks, orig[:, 0], orig[:, 1] - lf - p


def _interp_weights_nk(pos: torch.Tensor, S: int) -> torch.Tensor:
    """(N, K, S) two-tap bilinear weight rows for per-sample positions (N, K): the
    JAX package's one-hot weights, which ``_sample_blocks_nk`` replaces by four reads."""
    i0 = torch.floor(pos)
    f = pos - i0
    cols = torch.arange(S, dtype=pos.dtype, device=pos.device)
    eq0 = (cols == i0[..., None]).to(pos.dtype)
    eq1 = (cols == i0[..., None] + 1.0).to(pos.dtype)
    return eq0 * (1 - f)[..., None] + eq1 * f[..., None]


def _sample_blocks_nk(blocks_list, qx: torch.Tensor, qy: torch.Tensor, S: int):
    """Bilinear-sample each (N,S,S) block set at per-keypoint positions (N,K) given
    in block coordinates; positions clamp to the block edge (= image edge, since
    block origins clamp into the image). Four reads per sample, combined along x
    first and then along y as the JAX package's two weight products do."""
    qx = torch.clamp(qx, 0.0, S - 1.001)
    qy = torch.clamp(qy, 0.0, S - 1.001)
    x0 = torch.floor(qx)
    y0 = torch.floor(qy)
    fx = qx - x0
    fy = qy - y0
    # the index clamp keeps a NaN position inside the block
    i00 = (torch.clamp(y0.to(torch.int64), 0, S - 2) * S
           + torch.clamp(x0.to(torch.int64), 0, S - 2))
    outs = []
    for B in blocks_list:
        flat = B.reshape(B.shape[0], S * S)
        top = torch.gather(flat, 1, i00) * (1 - fx) + torch.gather(flat, 1, i00 + 1) * fx
        bot = (torch.gather(flat, 1, i00 + S) * (1 - fx)
               + torch.gather(flat, 1, i00 + S + 1) * fx)
        outs.append(top * (1 - fy) + bot * fy)
    return outs


def _soft_histogram(pos: torch.Tensor, weight: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(..., n_bins) per-sample circular two-bin soft assignment: ``weight`` split
    between bin floor(pos) and the next one (mod n_bins) by the fractional part."""
    b0 = torch.floor(pos)
    f = pos - b0
    b0i = torch.remainder(b0.to(torch.int64), n_bins)
    b1i = torch.remainder(b0i + 1, n_bins)
    bins = torch.arange(n_bins, device=pos.device)
    one0 = (b0i[..., None] == bins).to(weight.dtype)
    one1 = (b1i[..., None] == bins).to(weight.dtype)
    return one0 * (weight * (1 - f))[..., None] + one1 * (weight * f)[..., None]


def _orientation(gxB, gyB, ox, oy, xy, sig_rel, valid, S):
    """Dominant gradient orientation per keypoint (36-bin smoothed histogram,
    parabolic peak refinement), from octave-resolution block inputs."""
    P = _ORI_GRID
    dev = xy.device
    offs = on_device(_ORI_OFFS, dev)    # (256, 2)
    w = on_device(_ORI_W, dev)          # (256,)
    # radius 4.5*sigma window sampled by 16x16 -> spacing 9*sigma/16
    spacing = (sig_rel * 9.0 / P)[:, None]
    xs = xy[:, 0:1] * 1.0 + offs[None, :, 0] * spacing
    ys = xy[:, 1:2] * 1.0 + offs[None, :, 1] * spacing
    gx, gy = _sample_blocks_nk([gxB, gyB], xs - ox[:, None], ys - oy[:, None], S)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    b = (ang / (2 * math.pi) + 0.5) * _N_ORI_BINS  # [0, 36]
    hist = torch.sum(_soft_histogram(b, mag * w[None, :], _N_ORI_BINS), dim=1)  # (N, 36)
    # circular smoothing x2 with [1,4,6,4,1]/16
    k5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
    for _ in range(2):
        hist = sum(k5[j] * torch.roll(hist, j - 2, dims=1) for j in range(5))
    peak = torch.argmax(hist, dim=1)
    hl = torch.gather(hist, 1, torch.remainder(peak - 1, _N_ORI_BINS)[:, None])[:, 0]
    hc = torch.gather(hist, 1, peak[:, None])[:, 0]
    hr = torch.gather(hist, 1, torch.remainder(peak + 1, _N_ORI_BINS)[:, None])[:, 0]
    denom = hl - 2 * hc + hr
    den_ok = torch.abs(denom) > 1e-12
    off = torch.where(den_ok, 0.5 * (hl - hr) / torch.where(den_ok, denom, torch.ones_like(denom)),
                      torch.zeros_like(denom))
    off = torch.clamp(off, -0.5, 0.5)
    ori = (peak.to(torch.float32) + off + 0.5) / _N_ORI_BINS * 2 * math.pi - math.pi
    return torch.where(valid, ori, torch.zeros_like(ori))


def _patch_grid(P: int, device) -> torch.Tensor:
    """(2, P*P) sample offsets [u; v] of the P x P patch grid, in [-1, 1)."""

    def grid():
        g = ((np.arange(P, dtype=np.float32) + np.float32(0.5)) / np.float32(P)
             * np.float32(2.0) - np.float32(1.0))
        du, dv = np.meshgrid(g, g, indexing="xy")
        return np.stack([du.reshape(-1), dv.reshape(-1)]).astype(np.float32)

    return cached(("sift_patch_grid", P), device, grid)


def _describe_patch(iB, ox, oy, xy, sig_rel, ori, valid, S, P):
    """Normalized rotated-patch descriptor (128-d), the cheap alternative to the SIFT
    histogram (``DescriptorConfig.method = 'patch'``): bilinear-sample a rotated
    P x P intensity grid over the same support as the SIFT descriptor (half-width
    6*sigma), zero-mean + L2-normalize, and mean-pool/pad to 128 dims so it drops
    into the same matcher/state tables."""
    N = xy.shape[0]
    c = torch.cos(ori)[:, None]
    s = torch.sin(ori)[:, None]
    offs = _patch_grid(P, xy.device)
    half = (6.0 * sig_rel)[:, None]
    u = offs[0][None, :] * half
    v = offs[1][None, :] * half
    xs = xy[:, 0:1] + u * c - v * s
    ys = xy[:, 1:2] + u * s + v * c
    (vals,) = _sample_blocks_nk([iB], xs - ox[:, None], ys - oy[:, None], S)
    vals = vals - torch.mean(vals, dim=1, keepdim=True)
    D = vals.shape[1]
    if D >= 128:
        pool = D // 128
        vals = vals[:, : pool * 128].reshape(N, 128, pool).mean(-1)
    else:
        vals = F.pad(vals, (0, 128 - D))
    n = torch.clamp(torch.linalg.norm(vals, dim=1, keepdim=True), min=1e-12)
    desc = vals / n
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def _describe(gxB, gyB, ox, oy, xy, sig_rel, ori, valid, S):
    """128-d descriptors from a fixed rotated 16x16 sample grid (octave res)."""
    dev = xy.device
    Q = on_device(_DESC_Q, dev)
    Wsp = on_device(_DESC_W_SPATIAL, dev)
    c = torch.cos(ori)[:, None]
    s = torch.sin(ori)[:, None]
    # sample offsets: subregion coords q (256,2) scaled by bin width 3*sigma, rotated
    bw = (3.0 * sig_rel)[:, None]
    u = Q[None, :, 0] * bw  # (N, 256)
    v = Q[None, :, 1] * bw
    xs = xy[:, 0:1] + u * c - v * s
    ys = xy[:, 1:2] + u * s + v * c
    gx, gy = _sample_blocks_nk([gxB, gyB], xs - ox[:, None], ys - oy[:, None], S)
    # rotate gradients into the keypoint frame
    gu = gx * c + gy * s
    gv = -gx * s + gy * c
    mag = torch.sqrt(gu * gu + gv * gv)
    ang = torch.atan2(gv, gu)  # [-pi, pi] in keypoint frame
    ob = (ang / (2 * math.pi) + 0.5) * _DESC_ORI
    wori = _soft_histogram(ob, mag, _DESC_ORI)  # (N, 256, 8)
    # spatial soft-assign is the constant matrix -> one product
    desc = torch.einsum("pk,npo->nko", Wsp, wori)  # (N, 16, 8)
    desc = desc.reshape(desc.shape[0], 128)
    # normalize -> clamp 0.2 -> renormalize (Lowe's illumination robustness)
    n1 = torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc / n1, max=0.2)
    n2 = torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-12)
    desc = desc / n2
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def block_size(sigma0: float, width: int) -> int:
    """Side of the per-keypoint block: it covers both the orientation support
    (4.2*sigma) and the rotated descriptor support (2*sqrt(2)*3*sigma) at the largest
    relative sigma. Tiny octaves (or tiny test images): the block cannot exceed the
    image width; out-of-block samples clamp to the edge like the border handling."""
    S = int(np.ceil(2 * 2 * np.sqrt(2.0) * 3.0 * sigma0 * 2.0)) + 4
    return min(S, width)


def prepare(H: int, W: int, device, octaves: int = 3, scales_per_octave: int = 3,
            sigma0: float = 1.6, patch_size: int | None = None) -> None:
    """Build and upload every constant :func:`sift` needs for (H, W) images, so that
    the first frame neither builds band matrices nor copies from the host."""
    for _ in range(octaves):
        _octave_bands(H, W, scales_per_octave, sigma0, device)
        H, W = (H + 1) // 2, (W + 1) // 2
    for a in (_DESC_Q, _DESC_W_SPATIAL, _ORI_OFFS, _ORI_W):
        on_device(a, device)
    if patch_size is not None:
        _patch_grid(patch_size, device)


def sift(
    img: torch.Tensor,
    max_keypoints: int = 512,
    octaves: int = 3,
    scales_per_octave: int = 3,
    contrast_thresh: float = 0.04,
    edge_thresh: float = 10.0,
    sigma0: float = 1.6,
    border: int = 8,
    compute_desc: bool = True,
    desc_method: str = "sift",
    patch_size: int = 16,
) -> SiftFeatures:
    """Detect (and optionally describe) SIFT-class features in a (H, W) image.

    Returns a fixed-capacity :class:`SiftFeatures` with ``max_keypoints`` rows
    (``max_keypoints // octaves`` per octave, strongest first within each block).
    """
    s = scales_per_octave
    dev = img.device
    space = build_scale_space(img, octaves, s, sigma0)
    k_oct = max(max_keypoints // octaves, 1)

    pts_all, sig_all, ori_all, score_all, valid_all, desc_all = [], [], [], [], [], []
    for o, gstack in enumerate(space):
        xy, li, score, valid = _detect_octave(
            gstack, k_oct, contrast_thresh, edge_thresh, s, border
        )
        sig_rel = sigma0 * 2.0 ** (li.to(torch.float32) / s)
        gx_st, gy_st = _stack_gradients(gstack)
        S_blk = block_size(sigma0, gstack.shape[2])
        gxB, oxb, oyb = _extract_stack_blocks(gx_st, li, xy, S_blk)
        gyB, _, _ = _extract_stack_blocks(gy_st, li, xy, S_blk)
        ori = _orientation(gxB, gyB, oxb, oyb, xy, sig_rel, valid, S_blk)
        if not compute_desc:
            desc = torch.zeros((k_oct, 128), dtype=torch.float32, device=dev)
        elif desc_method == "patch":
            iB, oxi, oyi = _extract_stack_blocks(gstack, li, xy, S_blk)
            desc = _describe_patch(iB, oxi, oyi, xy, sig_rel, ori, valid, S_blk, patch_size)
        else:
            desc = _describe(gxB, gyB, oxb, oyb, xy, sig_rel, ori, valid, S_blk)
        scale_f = float(2 ** o)
        pts_all.append((xy + 0.5) * scale_f - 0.5)
        sig_all.append(sig_rel * scale_f)
        ori_all.append(ori)
        score_all.append(score)
        valid_all.append(valid)
        desc_all.append(desc)

    n = k_oct * octaves
    if n < max_keypoints:  # pad to static capacity
        pad = max_keypoints - n
        f32 = dict(dtype=torch.float32, device=dev)
        pts_all.append(torch.zeros((pad, 2), **f32))
        sig_all.append(torch.zeros((pad,), **f32))
        ori_all.append(torch.zeros((pad,), **f32))
        score_all.append(torch.full((pad,), float("-inf"), **f32))
        valid_all.append(torch.zeros((pad,), dtype=torch.bool, device=dev))
        desc_all.append(torch.zeros((pad, 128), **f32))
    return SiftFeatures(
        pts=torch.cat(pts_all, 0),
        sigma=torch.cat(sig_all, 0),
        ori=torch.cat(ori_all, 0),
        score=torch.cat(score_all, 0),
        valid=torch.cat(valid_all, 0),
        desc=torch.cat(desc_all, 0),
    )

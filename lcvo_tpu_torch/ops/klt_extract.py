"""KLT block extraction: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``lcvo_tpu/ops/klt_pallas.py::extract_blocks_pallas``, with the edge
padding that its callers do beforehand folded in. For each center (x, y) it returns
the integer-aligned (S, S) block of the image edge-replicated by ``pad`` pixels on
every side, and the block's top-left corner in the coordinates of the image given:

    ox = clip(floor(cx + pad) - (S-1)//2, 0, W + 2*pad - S) - pad      (oy alike)
    block[r, c] = img[clip(oy + r, 0, H-1), clip(ox + c, 0, W-1)]

which is ``extract(edge_pad(img, pad), centers + pad, S)`` with ``pad`` taken off the
origins. ``pad`` is added to the center in f32 before the floor, as
``lcvo_tpu/ops/klt.py::_track_level`` does. The origin clamp is against the shape of
the (padded) image, as in the XLA formulation (``lcvo_tpu/ops/klt.py:102-107``). The
Pallas kernel clamps against its own alignment-padded copy instead, so the two differ
for centers past the right or bottom edge (ROADMAP §C); the port follows the XLA
semantics.

:func:`extract_blocks` launches ``csrc/extract_blocks.cu`` for CUDA tensors and runs
:func:`extract_blocks_plain` for CPU tensors. The kernel is a copy, so the two agree
bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lcvo_tpu_torch import kernels

# tracks per slab aimed at: at N = 2048 it gives 256 thread blocks, about two per SM of
# an H100, which measured fastest for S in {21, 29, 33} (tools/port_extract_bench.py)
_SLAB_TRACKS = 8


def slab_plan(N: int, S: int, itemsize: int) -> tuple[int, int]:
    """How the kernel cuts the (N, S, S) output: ``(G, n_groups)``.

    One thread block writes a slab of ``G`` consecutive (S, S) blocks with 16-byte
    stores, so a slab must be a multiple of 16 bytes (then every slab also starts on a
    16-byte boundary): ``G`` is a multiple of ``16 / gcd(16, S*S*itemsize)``, a power
    of two (4 for f32 and 8 for bf16 when S is odd). Tracks
    ``n_groups*G .. N-1`` fill no slab and take the kernel's scalar path, one thread
    block each."""
    g0 = 16 // math.gcd(16, S * S * itemsize)
    G = max(g0, _SLAB_TRACKS)
    return G, N // G


def block_origins(centers: torch.Tensor, S: int, H: int, W: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamped integer origins (ox, oy), int64, of the (S, S) blocks around ``centers``.

    NaN centers map to origin 0 and infinities to the nearest edge, as the kernel's
    fmaxf/fminf clamp does."""
    want = torch.floor(centers) - (S - 1) // 2
    want = torch.nan_to_num(want, nan=0.0)
    ox = torch.clamp(want[:, 0], 0, W - S).to(torch.int64)
    oy = torch.clamp(want[:, 1], 0, H - S).to(torch.int64)
    return ox, oy


def extract_blocks_plain(img: torch.Tensor, centers: torch.Tensor, S: int, pad: int = 0):
    """Plain PyTorch version: edge-pad, then a gather from the padded image's
    (Hp-S+1, Wp-S+1, S, S) unfold view."""
    if pad:
        img = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    H, W = img.shape
    ox, oy = block_origins(centers + pad, S, H, W)
    blocks = img.unfold(0, S, 1).unfold(1, S, 1)[oy, ox]
    return blocks, torch.stack([ox - pad, oy - pad], dim=-1).to(centers.dtype)


def _check_args(img: torch.Tensor, centers: torch.Tensor, S: int, pad: int) -> None:
    if img.dim() != 2:
        raise ValueError(f"img must be (H, W), got {tuple(img.shape)}")
    if centers.dim() != 2 or centers.shape[1] != 2:
        raise ValueError(f"centers must be (N, 2), got {tuple(centers.shape)}")
    if not isinstance(pad, int) or pad < 0:
        raise ValueError(f"pad must be an int >= 0, got {pad!r}")
    H, W = img.shape
    if not (1 <= S <= H + 2 * pad and S <= W + 2 * pad and H >= 1 and W >= 1):
        raise ValueError(f"block size {S} does not fit the image {H}x{W} padded by {pad}")


def extract_blocks(img: torch.Tensor, centers: torch.Tensor, S: int, pad: int = 0):
    """(N, S, S) blocks in ``img``'s dtype and (N, 2) origins in ``centers``' dtype,
    of ``img`` edge-replicated by ``pad`` pixels; origins in ``img``'s coordinates,
    so they lie in ``[-pad, W + pad - S]``.

    CUDA tensors go through the hand-written kernel (f32 or bf16 image, f32 centers,
    any N, any S); CPU tensors through :func:`extract_blocks_plain`."""
    _check_args(img, centers, S, pad)
    if img.device.type == "cpu" and centers.device.type == "cpu":
        return extract_blocks_plain(img, centers, S, pad)
    if img.device.type != "cuda" or centers.device != img.device:
        raise ValueError(f"img on {img.device} and centers on {centers.device}: "
                         "both must be on one CUDA device (or both on the CPU)")
    if img.dtype == torch.float32:
        fn_name = "lcvo_extract_blocks_f32"
    elif img.dtype == torch.bfloat16:
        fn_name = "lcvo_extract_blocks_bf16"
    else:
        raise TypeError(f"extract_blocks kernel takes f32 or bf16 images, got {img.dtype}")
    if centers.dtype != torch.float32:
        raise TypeError(f"extract_blocks kernel takes f32 centers, got {centers.dtype}")
    H, W = img.shape
    N = centers.shape[0]
    if img.numel() >= 2 ** 31:
        raise ValueError(f"extract_blocks kernel indexes the image with 32 bits, got {H}x{W}")
    blocks = torch.empty((N, S, S), dtype=img.dtype, device=img.device)
    origins = torch.empty((N, 2), dtype=torch.float32, device=img.device)
    if N == 0:
        return blocks, origins
    G, n_groups = slab_plan(N, S, img.element_size())
    lib = kernels.library()
    img = img.contiguous()
    centers = centers.contiguous()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        code = getattr(lib, fn_name)(
            img.data_ptr(), H, W, centers.data_ptr(), N, S, pad, G, n_groups,
            blocks.data_ptr(), origins.data_ptr(), stream,
        )
    kernels.check(code, "extract_blocks")
    kernels.LAUNCHES["extract_blocks"] += 1
    return blocks, origins

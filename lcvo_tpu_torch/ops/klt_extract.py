"""KLT block extraction: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``lcvo_tpu/ops/klt_pallas.py::extract_blocks_pallas``. For each center
(x, y) it returns the integer-aligned (S, S) block whose top-left corner is
``(clip(floor(cx) - (S-1)//2, 0, W-S), clip(floor(cy) - (S-1)//2, 0, H-S))`` and that
origin. The clamp is against the shape of the image given, as in the XLA formulation
(``lcvo_tpu/ops/klt.py:102-107``). The Pallas kernel clamps against its own
alignment-padded copy instead, so the two differ for centers past the right or bottom
edge (ROADMAP §C); the port follows the XLA semantics.

:func:`extract_blocks` launches ``csrc/extract_blocks.cu`` for CUDA tensors and runs
:func:`extract_blocks_plain` for CPU tensors. The kernel is a copy, so the two agree
bit for bit.
"""

from __future__ import annotations

import torch

from lcvo_tpu_torch import kernels


def block_origins(centers: torch.Tensor, S: int, H: int, W: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamped integer origins (ox, oy), int64, of the (S, S) blocks around ``centers``.

    NaN centers map to origin 0 and infinities to the nearest edge, as the kernel's
    fmaxf/fminf clamp does."""
    want = torch.floor(centers) - (S - 1) // 2
    want = torch.nan_to_num(want, nan=0.0)
    ox = torch.clamp(want[:, 0], 0, W - S).to(torch.int64)
    oy = torch.clamp(want[:, 1], 0, H - S).to(torch.int64)
    return ox, oy


def extract_blocks_plain(img: torch.Tensor, centers: torch.Tensor, S: int):
    """Plain PyTorch version: a gather from the (H-S+1, W-S+1, S, S) unfold view."""
    H, W = img.shape
    ox, oy = block_origins(centers, S, H, W)
    blocks = img.unfold(0, S, 1).unfold(1, S, 1)[oy, ox]
    return blocks, torch.stack([ox, oy], dim=-1).to(centers.dtype)


def _check_args(img: torch.Tensor, centers: torch.Tensor, S: int) -> None:
    if img.dim() != 2:
        raise ValueError(f"img must be (H, W), got {tuple(img.shape)}")
    if centers.dim() != 2 or centers.shape[1] != 2:
        raise ValueError(f"centers must be (N, 2), got {tuple(centers.shape)}")
    H, W = img.shape
    if not (1 <= S <= H and S <= W):
        raise ValueError(f"block size {S} does not fit the image {H}x{W}")


def extract_blocks(img: torch.Tensor, centers: torch.Tensor, S: int):
    """(N, S, S) blocks in ``img``'s dtype and (N, 2) origins in ``centers``' dtype.

    CUDA tensors go through the hand-written kernel (f32 or bf16 image, f32 centers,
    any N); CPU tensors through :func:`extract_blocks_plain`."""
    _check_args(img, centers, S)
    if img.device.type == "cpu" and centers.device.type == "cpu":
        return extract_blocks_plain(img, centers, S)
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
    blocks = torch.empty((N, S, S), dtype=img.dtype, device=img.device)
    origins = torch.empty((N, 2), dtype=torch.float32, device=img.device)
    if N == 0:
        return blocks, origins
    lib = kernels.library()
    img = img.contiguous()
    centers = centers.contiguous()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        code = getattr(lib, fn_name)(
            img.data_ptr(), H, W, centers.data_ptr(), N, S,
            blocks.data_ptr(), origins.data_ptr(), stream,
        )
    kernels.check(code, "extract_blocks")
    kernels.LAUNCHES["extract_blocks"] += 1
    return blocks, origins

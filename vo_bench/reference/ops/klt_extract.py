"""KLT block extraction, the plain version (a copy of the port's
``ops/klt_extract.py::extract_blocks_plain``): for each center (x, y) the
integer-aligned (S, S) block of the image edge-replicated by ``pad`` pixels, and the
block's top-left corner in the coordinates of the image given:

    ox = clip(floor(cx + pad) - (S-1)//2, 0, W + 2*pad - S) - pad      (oy alike)
    block[r, c] = img[clip(oy + r, 0, H-1), clip(ox + c, 0, W-1)]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vo_bench.reference.calls import recorded

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


@recorded("extract_blocks")
def extract_blocks(img: torch.Tensor, centers: torch.Tensor, S: int, pad: int = 0):
    """The plain version on any device (the benchmark's reference has no kernel)."""
    return extract_blocks_plain(img, centers, S, pad)

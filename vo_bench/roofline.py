"""The yardstick of the hand-written kernels: the card's published peak and the bytes a
call must move (a frozen copy of the port's ``chip_smoke.py::bound_bytes``).

``extract_blocks`` is bound by bytes: for each of its N centers it writes an (S, S)
block and the block's origin, and reads the center and the image pixels the blocks
cover (each pixel once, however many blocks share it).
"""

from __future__ import annotations

import torch

# one NVIDIA H100 SXM's HBM3 bandwidth (NVIDIA's data sheet), bytes a second
HBM_BYTES_PER_S = 3.35e12


def block_origins(centers: torch.Tensor, S: int, H: int, W: int):
    """Clamped integer origins (ox, oy) of the (S, S) blocks around ``centers`` in an
    (H, W) image: NaN centers go to 0, infinities to the nearest edge."""
    want = torch.nan_to_num(torch.floor(centers) - (S - 1) // 2, nan=0.0)
    ox = torch.clamp(want[:, 0], 0, W - S).to(torch.int64)
    oy = torch.clamp(want[:, 1], 0, H - S).to(torch.int64)
    return ox, oy


def bound_bytes(img: torch.Tensor, centers: torch.Tensor, S: int, pad: int = 0) -> int:
    """Bytes ``extract_blocks(img, centers, S, pad)`` must move: the image pixels its
    blocks cover (each read once), the centers, the blocks and the origins."""
    H, W = img.shape
    N = centers.shape[0]
    ox, oy = block_origins(centers + pad, S, H + 2 * pad, W + 2 * pad)
    ox, oy = ox - pad, oy - pad
    cover = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    r = torch.arange(S, device=img.device)
    ry = (oy[:, None, None] + r[None, :, None]).clamp(0, H - 1)
    rx = (ox[:, None, None] + r[None, None, :]).clamp(0, W - 1)
    cover[ry.expand(-1, S, S), rx.expand(-1, S, S)] = True
    elt = img.element_size()
    return int(cover.sum().item()) * elt + N * 2 * 4 + N * S * S * elt + N * 2 * 4

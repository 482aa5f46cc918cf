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
bit for bit. :func:`extract_blocks_layered` is the same on a stack of layers, a layer
index per center and a pad per axis. Both are ``torch.library`` operators; the 2-D one
has a batching rule, so ``torch.func.vmap`` of a caller over B images launches the
layered kernel once per call, not B times (``ops/klt.py`` and ``frontend/sift.py`` run
under vmap in ``parallel/streams.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.core import constants

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


def extract_blocks_layered_plain(img: torch.Tensor, centers: torch.Tensor, layer: torch.Tensor,
                                 S: int, pad_y: int = 0, pad_x: int = 0):
    """Plain PyTorch version of the layered entry: each layer edge-padded by ``pad_y``
    rows and ``pad_x`` columns, then a gather from the stack's unfold view at each
    center's layer, a layer index outside ``[0, L)`` clamped into the stack as the
    kernel clamps it. Layer by layer it is :func:`extract_blocks_plain`."""
    if pad_y or pad_x:
        img = F.pad(img[:, None], (pad_x, pad_x, pad_y, pad_y), mode="replicate")[:, 0]
    L, H, W = img.shape
    # each pad added in the centers' dtype, as extract_blocks_plain adds its one pad
    ox, oy = block_origins(torch.stack([centers[:, 0] + pad_x, centers[:, 1] + pad_y], -1),
                           S, H, W)
    blocks = img.unfold(1, S, 1).unfold(2, S, 1)[layer.long().clamp(0, L - 1), oy, ox]
    return blocks, torch.stack([ox - pad_x, oy - pad_y], dim=-1).to(centers.dtype)


def _check_args(img: torch.Tensor, centers: torch.Tensor, S: int, pad_y: int, pad_x: int,
                img_dims: int = 2, layer: torch.Tensor | None = None) -> None:
    tensors = (img, centers) if layer is None else (img, centers, layer)
    if any(t.device != img.device for t in tensors):
        raise ValueError("extract_blocks: tensors on " + ", ".join(str(t.device) for t in tensors)
                         + ": all must be on one CUDA device, or all on the CPU")
    if img.dim() != img_dims:
        want = "(H, W)" if img_dims == 2 else "(L, H, W)"
        raise ValueError(f"img must be {want}, got {tuple(img.shape)}")
    if centers.dim() != 2 or centers.shape[1] != 2:
        raise ValueError(f"centers must be (N, 2), got {tuple(centers.shape)}")
    for pad in (pad_y, pad_x):
        if not isinstance(pad, int) or pad < 0:
            raise ValueError(f"pad must be an int >= 0, got {pad!r}")
    H, W = img.shape[-2:]
    if not (1 <= S <= H + 2 * pad_y and S <= W + 2 * pad_x and H >= 1 and W >= 1):
        raise ValueError(f"block size {S} does not fit the image {H}x{W} padded by "
                         f"{(pad_y, pad_x)}")


def extract_blocks(img: torch.Tensor, centers: torch.Tensor, S: int, pad: int = 0):
    """(N, S, S) blocks in ``img``'s dtype and (N, 2) origins in ``centers``' dtype,
    of ``img`` edge-replicated by ``pad`` pixels; origins in ``img``'s coordinates,
    so they lie in ``[-pad, W + pad - S]``.

    CUDA tensors go through the hand-written kernel (f32 or bf16 image, f32 centers,
    any N, any S); CPU tensors through :func:`extract_blocks_plain`. Under
    ``torch.func.vmap`` a batch of images (B, H, W) with centers (B, N, 2) is one call
    of the layered entry, so one launch whatever B."""
    _check_args(img, centers, S, pad, pad)
    return torch.ops.lcvo.extract_blocks(img, centers, S, pad)


def extract_blocks_layered(img: torch.Tensor, centers: torch.Tensor, layer: torch.Tensor,
                           S: int, pad_y: int = 0, pad_x: int = 0):
    """The layered entry: ``img`` (L, H, W), ``centers`` (N, 2), ``layer`` (N,) int32
    in ``[0, L)``. Block n comes from layer ``layer[n]`` edge-replicated by ``pad_y``
    rows and ``pad_x`` columns, its origin clamped inside that layer; so the call is,
    layer by layer, :func:`extract_blocks` with one pad per axis. A layer index outside
    ``[0, L)`` is clamped into the stack, by the kernel and the plain version alike. One
    launch on CUDA tensors, the plain version on CPU tensors."""
    _check_args(img, centers, S, pad_y, pad_x, img_dims=3, layer=layer)
    if layer.shape != centers.shape[:1] or layer.dtype != torch.int32:
        raise ValueError(f"layer must be ({centers.shape[0]},) int32, got "
                         f"{tuple(layer.shape)} {layer.dtype}")
    return torch.ops.lcvo.extract_blocks_layered(img, centers, layer, S, pad_y, pad_x)


# -- the operators: the plain version for CPU tensors, the kernel for CUDA tensors ------

@torch.library.custom_op("lcvo::extract_blocks", mutates_args=(), device_types="cpu")
def _extract_blocks_op(img: torch.Tensor, centers: torch.Tensor, S: int,
                       pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    return extract_blocks_plain(img, centers, S, pad)


@torch.library.custom_op("lcvo::extract_blocks_layered", mutates_args=(), device_types="cpu")
def _extract_blocks_layered_op(img: torch.Tensor, centers: torch.Tensor, layer: torch.Tensor,
                               S: int, pad_y: int,
                               pad_x: int) -> tuple[torch.Tensor, torch.Tensor]:
    return extract_blocks_layered_plain(img, centers, layer, S, pad_y, pad_x)


def _launch(img, centers, layer, S: int, pad_y: int, pad_x: int):
    """Launch ``csrc/extract_blocks.cu`` once: the 2-D entry when ``layer`` is None,
    the layered one otherwise. Counts the launch under its entry's name."""
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"extract_blocks kernel takes f32 or bf16 images, got {img.dtype}")
    if centers.dtype != torch.float32:
        raise TypeError(f"extract_blocks kernel takes f32 centers, got {centers.dtype}")
    if img.numel() >= 2 ** 31:
        raise ValueError(f"extract_blocks kernel indexes the image with 32 bits, got "
                         f"{tuple(img.shape)}")
    H, W = img.shape[-2:]
    N = centers.shape[0]
    blocks = torch.empty((N, S, S), dtype=img.dtype, device=img.device)
    origins = torch.empty((N, 2), dtype=torch.float32, device=img.device)
    if N == 0:
        return blocks, origins
    G, n_groups = slab_plan(N, S, img.element_size())
    lib = kernels.library()
    dt = "f32" if img.dtype == torch.float32 else "bf16"
    img = img.contiguous()
    centers = centers.contiguous()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        if layer is None:
            code = getattr(lib, f"lcvo_extract_blocks_{dt}")(
                img.data_ptr(), H, W, centers.data_ptr(), N, S, pad_y, G, n_groups,
                blocks.data_ptr(), origins.data_ptr(), stream)
        else:
            layer = layer.contiguous()
            code = getattr(lib, f"lcvo_extract_blocks_layered_{dt}")(
                img.data_ptr(), img.shape[0], H, W, centers.data_ptr(), layer.data_ptr(), N,
                S, pad_y, pad_x, G, n_groups, blocks.data_ptr(), origins.data_ptr(), stream)
    entry = "extract_blocks" if layer is None else "extract_blocks_layered"
    kernels.check(code, entry)
    kernels.LAUNCHES[entry] += 1
    return blocks, origins


@_extract_blocks_op.register_kernel("cuda")
def _extract_blocks_cuda(img, centers, S, pad):
    return _launch(img, centers, None, S, pad, pad)


@_extract_blocks_layered_op.register_kernel("cuda")
def _extract_blocks_layered_cuda(img, centers, layer, S, pad_y, pad_x):
    return _launch(img, centers, layer, S, pad_y, pad_x)


# -- the batching rule: a batch of B calls is one call of the layered entry --------------

def _stream_layers(B: int, N: int, device) -> torch.Tensor:
    """(B*N,) int32: layer b for the N centers of batch entry b; made once per shape."""
    return constants.cached(("stream_layers", B, N), device,
                            lambda: np.repeat(np.arange(B, dtype=np.int32), N))


def _extract_blocks_vmap(info, in_dims, img, centers, S, pad):
    """B calls are one call of the layered entry, layer b for the centers of call b;
    an image or centers not batched are broadcast to the B calls."""
    img_d, c_d = in_dims[0], in_dims[1]
    B = info.batch_size
    im = img.expand((B,) + img.shape) if img_d is None else img.movedim(img_d, 0)
    c = centers.expand((B,) + centers.shape) if c_d is None else centers.movedim(c_d, 0)
    N = c.shape[1]
    blocks, origins = torch.ops.lcvo.extract_blocks_layered(
        im, c.reshape(-1, 2), _stream_layers(B, N, img.device), S, pad, pad)
    return (blocks.reshape(B, N, S, S), origins.reshape(B, N, 2)), (0, 0)


torch.library.register_vmap("lcvo::extract_blocks", _extract_blocks_vmap)

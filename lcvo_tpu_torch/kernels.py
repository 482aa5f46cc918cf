"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` expose a plain C interface (no PyTorch headers, so nvcc
takes seconds, not minutes). ``torch.utils.cpp_extension.load`` compiles them for
``sm_90a`` into ``<repo>/build/torch_ext`` on first use; the library is then opened
with ``ctypes`` and each kernel is called with raw device pointers on PyTorch's current
stream.

There is no fallback: if the build, the load or a launch fails, the call raises.
Every wrapper adds one to its entry of :data:`LAUNCHES` where it launches its kernel,
and nowhere else, so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = [os.path.join(CSRC, "extract_blocks.cu")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "torch_ext")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]

# kernel entry -> launches since the last reset_launches(): the 2-D entry of
# extract_blocks.cu and its layered entry (a stack of layers; the batched streams)
LAUNCHES: dict[str, int] = {"extract_blocks": 0, "extract_blocks_layered": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.lcvo_extract_blocks_f32, lib.lcvo_extract_blocks_bf16):
        # img, H, W, centers, N, S, pad, G, n_groups, blocks, origins, stream
        fn.argtypes = [vp, ci, ci, vp, ci, ci, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    for fn in (lib.lcvo_extract_blocks_layered_f32, lib.lcvo_extract_blocks_layered_bf16):
        # img, L, H, W, centers, layer, N, S, pad_y, pad_x, G, n_groups, blocks, origins,
        # stream
        fn.argtypes = [vp, ci, ci, ci, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    lib.lcvo_cuda_error_string.argtypes = [ci]
    lib.lcvo_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use. Raises if it cannot be built."""
    global _lib
    if _lib is None:
        from torch.utils.cpp_extension import load

        os.makedirs(BUILD_DIR, exist_ok=True)
        path = load(
            name="lcvo_torch_kernels",
            sources=SOURCES,
            build_directory=BUILD_DIR,
            extra_cuda_cflags=CUDA_FLAGS,
            is_python_module=False,
        )
        lib = ctypes.CDLL(path)
        _bind(lib)
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if code != 0:
        msg = _lib.lcvo_cuda_error_string(code).decode() if _lib is not None else "?"
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")

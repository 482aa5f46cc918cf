"""Build, load and count the port's hand-written CUDA kernels and its cuSOLVER launcher.

The sources under ``csrc/`` expose a plain C interface (no PyTorch headers, so nvcc
takes seconds, not minutes). ``torch.utils.cpp_extension.load`` compiles them for
``sm_90a`` into ``<repo>/build/torch_ext`` on first use; the library is then opened
with ``ctypes`` and each kernel is called with raw device pointers on PyTorch's current
stream. ``csrc/svd.cu`` calls cuSOLVER, and the library links the cuSOLVER that torch's
own linear algebra loads (:func:`_cusolver_ldflags`). The sources (:data:`SOURCES`):
``extract_blocks.cu`` (KLT's and SIFT's blocks), ``svd.cu`` (the batched SVD route),
``p3p.cu`` (the P3P solve) and ``klt_iterate.cu`` (a KLT level after its extractions:
template, Hessian, every iteration and the residual).

There is no fallback: if the build, the load or a launch fails, the call raises.
Every wrapper adds one to its entry of :data:`LAUNCHES` where it launches its kernel,
and nowhere else, so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import importlib.util
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = [os.path.join(CSRC, n) for n in ("extract_blocks.cu", "svd.cu", "p3p.cu",
                                            "klt_iterate.cu")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "torch_ext")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]

# kernel entry -> launches since the last reset_launches(): the 2-D entry of
# extract_blocks.cu, its layered entry (a stack of layers; the batched streams), the
# batched SVD of svd.cu, the P3P solve of p3p.cu and a KLT level's iterations of
# klt_iterate.cu
LAUNCHES: dict[str, int] = {"extract_blocks": 0, "extract_blocks_layered": 0, "svd": 0,
                            "p3p": 0, "klt_iterate": 0}

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
    # max_sweeps, &handle, &params
    lib.lcvo_svd_create.argtypes = [ci, ctypes.POINTER(vp), ctypes.POINTER(vp)]
    lib.lcvo_svd_create.restype = ci
    # handle, params, A, m, n, batch, S, U, V, &lwork
    lib.lcvo_svd_workspace.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp, ctypes.POINTER(ci)]
    lib.lcvo_svd_workspace.restype = ci
    # handle, params, A, m, n, batch, S, U, V, work, lwork, info, stream
    lib.lcvo_svd_gesvdj_batched.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, ci, vp, vp]
    lib.lcvo_svd_gesvdj_batched.restype = ci
    # Pw, f, B, vinv, seed, R, t, ok, stream
    lib.lcvo_p3p_f32.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.lcvo_p3p_f32.restype = ci
    # tblocks, torig, nblocks, norig, pts, d, N, w, St, S, iters, eps2, bf16_blocks,
    # bf16_iter, d_out, det_ok, sat, residual, stream
    lib.lcvo_klt_iterate.argtypes = [vp] * 6 + [ci] * 5 + [ctypes.c_float, ci, ci] + [vp] * 5
    lib.lcvo_klt_iterate.restype = ci


def _cusolver_ldflags() -> list[str]:
    """Link flags for cuSOLVER. Where torch's wheel brings its own (the
    ``nvidia-cusolver`` package beside it, which ``torch.linalg.svd`` loads), the library
    links that file and records its directory, so the SVD launcher and torch run one
    cuSOLVER and give the same bits; elsewhere the toolkit's."""
    try:
        spec = importlib.util.find_spec("nvidia.cusolver")
    except ModuleNotFoundError:         # no ``nvidia`` package at all
        spec = None
    for d in (spec.submodule_search_locations or []) if spec else []:
        found = sorted(glob.glob(os.path.join(d, "lib", "libcusolver.so.*")))
        if found:
            lib_dir = os.path.dirname(found[0])
            return [f"-L{lib_dir}", f"-Wl,-rpath,{lib_dir}", f"-l:{os.path.basename(found[0])}"]
    return ["-lcusolver"]


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
            extra_ldflags=_cusolver_ldflags(),
            is_python_module=False,
        )
        lib = ctypes.CDLL(path)
        _bind(lib)
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error (or, negated, a cuSOLVER status)."""
    if code < 0:
        raise RuntimeError(f"{what}: cuSOLVER failed (status {-code})")
    if code != 0:
        msg = _lib.lcvo_cuda_error_string(code).decode() if _lib is not None else "?"
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")

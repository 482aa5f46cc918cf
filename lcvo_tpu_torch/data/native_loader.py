"""ctypes bindings for the native (C++) frame loader (port of
``lcvo_tpu/data/native_loader.py``; the library under ``native/`` is shared by both
packages, this binding is the port's own).

``native/png_loader.cpp`` decodes PNGs to float32 or uint8 grayscale outside the GIL and
batch-decodes a prefetch window with a thread pool. The contract is per file:
``decode_png`` returns ``None`` for a PNG feature the decoder does not cover (palette,
interlace, 16-bit) and the caller decodes that file another way.

Build: ``make`` on a copy of ``native/`` (g++, zlib), attempted once at first use and
moved into place in one step. A build or a load that fails is kept, not swallowed:
:func:`build_error` returns the compiler's or the loader's message.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "liblcvo_native.so",
)
_lib = None
_tried = False
_error: str | None = None
# files served by the library since the last reset_counts(): the proof that a run's
# frames came through the native decoder and not through another one
_counts = {"decoded": 0, "declined": 0}
_counts_lock = threading.Lock()  # the Prefetcher's thread and the caller's both decode


def _build() -> str | None:
    """``make`` in a private copy of ``native/``, then one ``os.replace`` onto
    ``_LIB_PATH``: no other process ever sees a half-linked file under that name.
    Returns the failure in the compiler's own words, or None."""
    src = os.path.dirname(_LIB_PATH)
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "native")
        try:
            shutil.copytree(src, work)
            subprocess.run(
                ["make", "-C", work], capture_output=True, text=True, timeout=120, check=True
            )
            staged = f"{_LIB_PATH[:-3]}.{os.getpid()}.so"
            shutil.copy(os.path.join(work, os.path.basename(_LIB_PATH)), staged)
            os.replace(staged, _LIB_PATH)
        except subprocess.CalledProcessError as e:
            return f"make -C native failed (rc {e.returncode}): {(e.stdout + e.stderr).strip()}"
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"make -C native did not run: {type(e).__name__}: {e}"
    return None


def _load():
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        _error = _build()
        if _error is not None:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _error = f"dlopen {_LIB_PATH}: {e}"
        return None
    _error = None
    lib.lcvo_png_shape.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.lcvo_decode_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.lcvo_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    # u8 variants (older prebuilt .so may lack them — probe, don't assume)
    if hasattr(lib, "lcvo_decode_png_u8"):
        lib.lcvo_decode_png_u8.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.lcvo_decode_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not loaded (the compiler's or the loader's own words), or
    None when it is loaded or was not tried yet."""
    _load()
    return _error


def _count(key: str) -> None:
    with _counts_lock:
        _counts[key] += 1


def counts() -> dict:
    """Files decoded by the library / declined by it since :func:`reset_counts`."""
    with _counts_lock:
        return dict(_counts)


def reset_counts() -> None:
    with _counts_lock:
        _counts["decoded"] = _counts["declined"] = 0


def png_shape(path: str) -> tuple[int, int] | None:
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.lcvo_png_shape(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_png(path: str, dtype=np.float32) -> np.ndarray | None:
    """(H, W) grayscale in ``dtype`` (float32 or uint8), or None when the native
    path can't handle it. uint8 is the lean ingest path: the host-to-device
    copy is 4x smaller and the pipeline casts to f32 on the device."""
    lib = _load()
    if lib is None:
        return None
    shape = png_shape(path)
    if shape is None:
        _count("declined")
        return None
    if dtype == np.uint8:
        if not hasattr(lib, "lcvo_decode_png_u8"):
            return None
        out = np.empty(shape, np.uint8)
        rc = lib.lcvo_decode_png_u8(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), *shape
        )
    else:
        out = np.empty(shape, np.float32)
        rc = lib.lcvo_decode_png(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *shape
        )
    _count("decoded" if rc == 0 else "declined")
    return out if rc == 0 else None


def decode_batch(paths: list[str], h: int, w: int, n_threads: int = 4) -> np.ndarray | None:
    """(N, h, w) float32 batch decode with the C++ thread pool.

    Returns None if the library is unavailable or ANY file fails (caller falls
    back per-file)."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, h, w), np.float32)
    rcs = (ctypes.c_int * n)()
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.lcvo_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, n_threads, rcs
    )
    return out if rc == 0 else None

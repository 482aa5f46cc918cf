"""The root ``conftest.py`` builds ``native/liblcvo_native.so`` once, atomically, before
test processes load it: several processes that call its hook at once all end with a
library they can load, and a failed build leaves no file behind."""

import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 6

# each process waits for the start file, calls the hook, then loads the library and
# asks it for the shape of a PNG it cannot open (a call into the library, not just dlopen)
_CHILD = textwrap.dedent("""
    import ctypes, importlib.util, os, sys, time
    root, native, go = sys.argv[1:4]
    spec = importlib.util.spec_from_file_location("root_conftest", os.path.join(root, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    while not os.path.exists(go):
        time.sleep(0.001)
    built = mod.build_native_library(native)
    lib = ctypes.CDLL(os.path.join(native, "liblcvo_native.so"))
    h, w = ctypes.c_int(), ctypes.c_int()
    lib.lcvo_png_shape.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    rc = lib.lcvo_png_shape(b"/nonexistent.png", ctypes.byref(h), ctypes.byref(w))
    print("LOADED", built, rc != 0)
""")


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", os.path.join(ROOT, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _native_copy(tmp_path):
    work = tmp_path / "native"
    work.mkdir()
    for name in ("Makefile", "png_loader.cpp"):
        shutil.copy(os.path.join(ROOT, "native", name), work / name)
    return work


def test_concurrent_hook_calls_all_load_the_library(tmp_path):
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on this machine")
    work = _native_copy(tmp_path)
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, ROOT, str(work), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCS)]
    time.sleep(0.5)   # every child is waiting on the start file
    go.touch()
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "LOADED True True", (out, err)
    # one library, no staged file left behind
    left = sorted(os.listdir(work))
    assert left == sorted(["Makefile", "png_loader.cpp", "liblcvo_native.so", ".build.lock"]), left
    ctypes.CDLL(str(work / "liblcvo_native.so"))


def test_failed_build_leaves_no_file(tmp_path, monkeypatch):
    work = _native_copy(tmp_path)
    monkeypatch.setenv("CXX", "false")
    assert _root_conftest().build_native_library(str(work)) is False
    assert not any(n.endswith(".so") for n in os.listdir(work)), os.listdir(work)


def test_existing_library_is_left_alone(tmp_path, monkeypatch):
    work = _native_copy(tmp_path)
    lib = work / "liblcvo_native.so"
    lib.write_bytes(b"not rebuilt")
    monkeypatch.setenv("CXX", "false")
    assert _root_conftest().build_native_library(str(work)) is True
    assert lib.read_bytes() == b"not rebuilt"

"""What the machine that holds the card offers to the port's host layers: Python and
PyTorch versions, the card's name and power limit, the CUDA device count and what
``torch.distributed`` offers (gloo, NCCL and its version), the optional packages (PIL,
matplotlib, PyYAML, scipy), the build tools the native PNG decoder needs (make, g++,
zlib.h, libz) and whether ``make -C native`` builds a library that loads.

    python3 tools/port_probe_host.py [--out chiprun_out/probe_host.json]

Prints one JSON object; imports nothing of the port, so it runs before anything else does.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import importlib
import json
import os
import shutil
import subprocess
import sys


def _run(cmd):
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        return p.returncode, (p.stdout + p.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return -1, f"{type(e).__name__}: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rep = {"python": sys.version.split()[0], "cpus": os.cpu_count()}
    try:
        import torch

        rep["torch"] = torch.__version__
        rep["cuda"] = torch.version.cuda
        rep["cuda_available"] = torch.cuda.is_available()
        rep["cuda_device_count"] = torch.cuda.device_count()
        import torch.distributed as dist

        rep["distributed"] = dist.is_available()
        rep["gloo"] = rep["distributed"] and dist.is_gloo_available()
        rep["nccl"] = rep["distributed"] and dist.is_nccl_available()
        try:
            rep["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
        except (AttributeError, RuntimeError) as e:
            rep["nccl_version"] = f"{type(e).__name__}: {e}"
    except ImportError as e:
        rep["torch"] = f"missing: {e}"
    rc, out = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    rep["card"] = out if rc == 0 else None
    for mod in ("PIL", "matplotlib", "yaml", "scipy", "triton"):
        try:
            m = importlib.import_module(mod)
            rep[mod] = getattr(m, "__version__", "present")
        except ImportError:
            rep[mod] = None
    for tool in ("make", "g++", "gcc", "nvcc"):
        rep[tool] = shutil.which(tool) or (
            "/usr/local/cuda/bin/nvcc" if tool == "nvcc" and os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    rep["zlib_h"] = next((p for p in ("/usr/include/zlib.h", "/usr/local/include/zlib.h")
                          if os.path.exists(p)), None)
    rep["libz"] = sorted(glob.glob("/usr/lib/*/libz.so*") + glob.glob("/lib/*/libz.so*")
                         + glob.glob("/usr/lib/libz.so*"))[:4]
    native = os.path.join(root, "native")
    lib = os.path.join(native, "liblcvo_native.so")
    if os.path.exists(lib):
        os.remove(lib)
    rc, out = _run(["make", "-C", native])
    rep["native_make_rc"] = rc
    rep["native_make_tail"] = out[-600:]
    try:
        ctypes.CDLL(lib)
        rep["native_loads"] = True
    except OSError as e:
        rep["native_loads"] = f"{e}"
    line = json.dumps(rep)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rep


if __name__ == "__main__":
    main()

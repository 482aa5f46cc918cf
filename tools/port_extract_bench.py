#!/usr/bin/env python3
"""Time the port's KLT block-extraction kernel on one NVIDIA GPU, at the shapes the
KITTI-resolution main path gives it, and print one JSON object (with ``--out FILE``
also written there).

    python3 tools/port_extract_bench.py [--old-src PATH/extract_blocks.cu] [--out FILE]

What it measures, each with CUDA graphs of back-to-back calls timed by CUDA events
(``chip_smoke.graph_ms``), so the host's launch cost is not in the numbers:

- per pyramid level (376x1240, 188x620, 94x310; template S_t = 21, target S and
  pad from the tracker's margins; N = 2048 f32 centers inside the image): the
  template call, the target call (with its bytes bound as ``chip_smoke.py`` computes
  it) and both together;
- ``F.pad(mode="replicate")`` of each level, the copy that the kernel's ``pad=``
  argument makes unnecessary;
- with ``--old-src``: an earlier version of the kernel's source (the interface
  without ``pad``: img, H, W, centers, N, S, blocks, origins, stream), built beside
  the tree's and timed in turns with it (old, new, new, old): per call on the padded
  image, and as the whole stage of one level (2 pads + 2 extractions against 2
  extractions with ``pad=``);
- the level-0 target call with the L2 cache cold: a 128 MiB buffer is overwritten
  before every launch, and the time of the overwrite alone is subtracted;
- an empty kernel, as the floor of one graph node on this card;
- the slab size: the level-0 call for each block size of the path, by tracks per
  slab G;
- what ``nvcc -Xptxas -v`` says of the kernels (registers, shared memory, spills).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]
EMPTY_SRC = """
__global__ void empty_kernel() {}
extern "C" int lcvo_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_shared(src: str, out: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-shared",
                    "-Xcompiler", "-fPIC", "-o", out, src], check=True)
    return ctypes.CDLL(out)


def ptxas_report(src: str, defines: tuple[str, ...] = ()) -> list[str]:
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, *[f"-D{d}" for d in defines],
                        "-Xptxas", "-v", "-cubin", "-o", os.devnull, src],
                       capture_output=True, text=True, check=True)
    lines = (r.stderr + r.stdout).splitlines()
    return [l for l in lines if "Used" in l or "Compiling" in l or "spill" in l]


def level_calls(cfg) -> list[dict]:
    """Per level of the in-pipeline tracker: image size, template and target block
    size, pad."""
    from lcvo_tpu_torch.core.state import pyramid_dims

    k = cfg.klt
    n_lvl = k.track_levels or k.levels
    dims = pyramid_dims(cfg.image_height, cfg.image_width, k.levels)
    mc = k.track_margin_coarse or k.track_margin
    out = []
    for l in range(n_lvl):
        m = mc if l == n_lvl - 1 and n_lvl > 1 else k.track_margin
        S = k.window + 2 + 2 * m
        out.append({"level": l, "H": dims[l][0], "W": dims[l][1], "S_t": k.window + 6,
                    "S": S, "pad": (S + 1) // 2})
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-src", default=None,
                    help="source of an earlier version of the kernel (interface without pad)")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_extract_bench.py: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import HBM_BYTES_PER_S, bound_bytes, graph_ms
    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.ops.klt_extract import extract_blocks, slab_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    res: dict = {"device": smi}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = load_config()
    N = cfg.state.max_tracks + cfg.state.max_candidates
    bench_dir = os.path.join(ROOT, "build", "bench")
    src = kernels.SOURCES[0]
    vp, ci = ctypes.c_void_p, ctypes.c_int

    lib = kernels.library()
    res["ptxas"] = ptxas_report(src)
    for l in res["ptxas"]:
        print("[ptxas] " + l, flush=True)

    def raw_call(img, c, S, pad, G):
        """The tree's kernel with a given tracks-per-slab G."""
        H, W = img.shape
        blocks = torch.empty((c.shape[0], S, S), dtype=img.dtype, device=dev)
        origins = torch.empty((c.shape[0], 2), dtype=torch.float32, device=dev)
        fn = lib.lcvo_extract_blocks_f32 if img.dtype == torch.float32 else lib.lcvo_extract_blocks_bf16
        code = fn(
            img.data_ptr(), H, W, c.data_ptr(), c.shape[0], S, pad, G, c.shape[0] // G,
            blocks.data_ptr(), origins.data_ptr(), torch.cuda.current_stream().cuda_stream)
        kernels.check(code, "extract_blocks")
        return blocks, origins

    old = None
    if args.old_src:
        old_lib = build_shared(args.old_src, os.path.join(bench_dir, "libextract_old.so"))
        old_lib.lcvo_extract_blocks_f32.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp, vp]
        old_lib.lcvo_extract_blocks_f32.restype = ci

        def old(img, c, S):
            H, W = img.shape
            blocks = torch.empty((c.shape[0], S, S), dtype=img.dtype, device=dev)
            origins = torch.empty((c.shape[0], 2), dtype=torch.float32, device=dev)
            code = old_lib.lcvo_extract_blocks_f32(
                img.data_ptr(), H, W, c.data_ptr(), c.shape[0], S, blocks.data_ptr(),
                origins.data_ptr(), torch.cuda.current_stream().cuda_stream)
            kernels.check(code, "old extract_blocks")
            return blocks, origins

    def edge_pad(img, p):
        return F.pad(img[None, None], (p, p, p, p), mode="replicate")[0, 0]

    def turns(fa, fb):
        """graph_ms of fa, fb, fb, fa."""
        a0, b0, b1, a1 = graph_ms(fa), graph_ms(fb), graph_ms(fb), graph_ms(fa)
        return {"old_ms": [a0, a1], "new_ms": [b0, b1]}

    levels = []
    for lc in level_calls(cfg):
        H, W, S_t, S, p = lc["H"], lc["W"], lc["S_t"], lc["S"], lc["pad"]
        prev = torch.rand((H, W), generator=gen, device=dev) * 255
        nxt = torch.rand((H, W), generator=gen, device=dev) * 255
        c = torch.rand((N, 2), generator=gen, device=dev) * torch.tensor([W - 1.0, H - 1.0], device=dev)
        d0 = torch.zeros_like(c)
        row = dict(lc)
        row["template_ms"] = graph_ms(lambda: extract_blocks(prev, c, S_t, pad=p))
        row["target_ms"] = graph_ms(lambda: extract_blocks(nxt, c, S, pad=p))
        row["target_bound_ms"] = bound_bytes(nxt, c, S, p) / HBM_BYTES_PER_S * 1e3
        row["target_bound_share"] = row["target_bound_ms"] / row["target_ms"]
        row["pad_ms"] = graph_ms(lambda: edge_pad(nxt, p))

        def new_stage():
            extract_blocks(prev, c, S_t, pad=p)
            extract_blocks(nxt, c + d0, S, pad=p)

        row["stage_ms"] = graph_ms(new_stage)
        if old is not None:
            prev_p, nxt_p, cp = edge_pad(prev, p), edge_pad(nxt, p), c + p
            # the same function: old on the padded copy == new with pad=
            bo, oo = old(nxt_p, cp, S)
            bn, on = extract_blocks(nxt, c, S, pad=p)
            torch.cuda.synchronize()
            if not (torch.equal(bo, bn) and torch.equal(oo - p, on)):
                raise AssertionError(f"old and new kernels differ at level {lc['level']}")

            def old_stage():
                # the level as the tracker ran it on padded copies: 2 pads, the pad
                # added to the centers and taken off the origins
                pp, npd = edge_pad(prev, p), edge_pad(nxt, p)
                _, to = old(pp, c + p, S_t)
                _, no = old(npd, c + d0 + p, S)
                return to - p, no - p

            row["target_call_turns"] = turns(lambda: old(nxt_p, cp, S),
                                             lambda: extract_blocks(nxt_p, cp, S))
            row["template_call_turns"] = turns(lambda: old(prev_p, cp, S_t),
                                               lambda: extract_blocks(prev_p, cp, S_t))
            row["stage_turns"] = turns(old_stage, new_stage)
        print("[level] " + json.dumps(row), flush=True)
        levels.append(row)
    res["levels"] = levels

    # level-0 target call: cold L2, empty-kernel floor, slab size
    lc = level_calls(cfg)[0]
    H, W, S, p = lc["H"], lc["W"], lc["S"], lc["pad"]
    img = torch.rand((H, W), generator=gen, device=dev) * 255
    c = torch.rand((N, 2), generator=gen, device=dev) * torch.tensor([W - 1.0, H - 1.0], device=dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def cold_ms(fn) -> list[float]:
        out = []
        for _ in range(3):
            both = graph_ms(lambda: (flush.zero_(), fn()), inner=20)
            out.append(both - graph_ms(lambda: flush.zero_(), inner=20))
        return out

    cold = cold_ms(lambda: extract_blocks(img, c, S, pad=p))
    res["cold_l2_ms"] = {"runs": cold, "median": statistics.median(cold),
                         "warm_ms": graph_ms(lambda: extract_blocks(img, c, S, pad=p))}
    if old is not None:
        img_p, cp = edge_pad(img, p), c + p
        res["cold_l2_ms"]["old_runs"] = cold_ms(lambda: old(img_p, cp, S))
    print("[cold] " + json.dumps(res["cold_l2_ms"]), flush=True)

    empty_src = os.path.join(bench_dir, "empty.cu")
    os.makedirs(bench_dir, exist_ok=True)
    with open(empty_src, "w") as fh:
        fh.write(EMPTY_SRC)
    empty = build_shared(empty_src, os.path.join(bench_dir, "libempty.so"))
    empty.lcvo_empty.argtypes = [vp]
    empty.lcvo_empty.restype = ci
    res["empty_kernel_ms"] = graph_ms(lambda: empty.lcvo_empty(torch.cuda.current_stream().cuda_stream))
    print(f"[empty] {res['empty_kernel_ms']:.5f} ms", flush=True)

    # tracks per slab: every block size of the path in f32, the level-0 target in bf16
    by_G = {}
    for dtype, S_ in ((torch.float32, 21), (torch.float32, 29), (torch.float32, 33),
                      (torch.bfloat16, 29)):
        im = img.to(dtype)
        g0 = 16 // math.gcd(16, S_ * S_ * im.element_size())   # least G of aligned slabs
        name = f"{str(dtype).split('.')[-1]}_S{S_}"
        by_G[name] = {"plan_G": slab_plan(N, S_, im.element_size())[0]}
        for G in sorted({g0, 2 * g0, 3 * g0, 4 * g0, 8, 16}):
            if G % g0 == 0:
                by_G[name][G] = graph_ms(lambda: raw_call(im, c, S_, p, G))
        print(f"[G] {name}: " + json.dumps(by_G[name]), flush=True)
    res["by_G_ms"] = by_G

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

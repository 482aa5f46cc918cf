#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lcvo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing is caught):

1. Device: requires CUDA; reads the card's name and power limit from ``nvidia-smi``.
2. Build: compiles the hand-written kernels from ``lcvo_tpu_torch/csrc`` into
   ``build/torch_ext`` (``nvcc``, ``sm_90a``).
3. Kernel against plain version: ``extract_blocks`` against its plain PyTorch
   pad-and-gather on f32 and bf16 images of the pyramid-level sizes of the
   KITTI-resolution main path, an odd-width one and one with S == H; N in
   {2048, 2047, 5, 1}; S in {21, 29, 30, 33}; ``pad`` 0 and (S+1)//2; centers past all
   four borders and corners, centers whose ``cx + pad`` rounds across an integer, NaN
   and infinite centers. Tolerance: exact (the kernel is a copy). Times the kernel and
   the plain version at the main path's level-0 target call, and with ``pad=0`` on the
   edge-padded copy of the same image, with CUDA graphs of back-to-back launches and
   CUDA events.
4. Main path: renders 42 synthetic corridor frames at 1240x376 and runs
   ``VisualOdometry(load_config(), K, device="cuda").run_chunked(frames, chunk=16)``
   (bootstrap, two chunks of 16, three tail frames) with the launch counters set to 0
   just before and read just after. Checks a finite trajectory with one pose per frame
   from ``frame_gap`` on, ``pose_ok`` on >= 90% of entries, ATE < 0.03 m after Sim(3)
   alignment (8x the JAX package's CPU figure on the same frames), and >= 6
   extraction launches per processed frame. Prints the chunked steady-state frames/s
   and the per-frame latency of ``step``.
   With ``--profile DIR``, one more chunk runs under ``torch.profiler`` afterwards
   (stage spans, device busy share, top kernels; summary to DIR).
5. Output: the kernel table as one JSON line, the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

The script imports neither JAX nor ``lcvo_tpu``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM HBM3 peak rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
N_FRAMES = 42            # 7 bootstrap + 2 chunks of 16 + 3 tail frames
N_LATENCY = 6            # extra frames for the per-frame step latency
CHUNK = 16
# ATE bound for the seed-0 run: 8x the 0.00376 m the JAX package reaches on the CPU on
# the same 42 frames at 1240x376 (tools/port_parity_cpu.py --width 1240 --height 376
# --seed 0). The headroom covers the random streams: the port draws its RANSAC samples
# from a torch.Generator, not JAX's PRNG, so it does not retrace the JAX trajectory.
ATE_BOUND_M = 0.03
POSE_OK_MIN = 0.9


def _say(msg: str) -> None:
    print(msg, flush=True)


def graph_ms(fn, inner: int = 50, reps: int = 15) -> float:
    """Device time of one ``fn()`` call: a CUDA graph of ``inner`` back-to-back calls,
    replayed ``reps`` times, each replay timed with CUDA events; the median replay over
    ``inner``. Graph replay removes the host's launch cost from the measurement."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def _eager_ms(fn, n: int = 200) -> float:
    """Time per call of back-to-back eager calls (host launch cost included)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _level_calls(cfg) -> list[tuple[int, int, int, int]]:
    """(H, W, S, pad) of the calls the main path makes to ``extract_blocks``: per
    pyramid level the unpadded image size, the target block S = w+2+2*margin and its
    pad (S+1)//2, for the in-pipeline tracker's margins and for the bootstrap's. (The
    template call of a level has the same image and pad and S = w+6.)"""
    from lcvo_tpu_torch.core.state import pyramid_dims

    k = cfg.klt
    dims = pyramid_dims(cfg.image_height, cfg.image_width, k.levels)
    n_lvl = k.track_levels or k.levels
    mc = k.track_margin_coarse or k.track_margin
    track = [mc if l == n_lvl - 1 and n_lvl > 1 else k.track_margin for l in range(n_lvl)]
    calls = []
    for margins in (track, [k.margin] * k.levels):
        for l, m in enumerate(margins):
            S = k.window + 2 + 2 * m
            call = (*dims[l], S, (S + 1) // 2)
            if call not in calls:
                calls.append(call)
    return calls


def _test_centers(n: int, H: int, W: int, S: int, gen, device):
    """``n`` centers drawn from a pool of random ones over [-S, W+S] x [-S, H+S] and
    fixed ones: past all four borders and corners, just below an integer (so that
    ``cx + pad`` rounds up across it in f32), just below zero, NaN and infinite."""
    import torch

    c = torch.rand((max(n, 64), 2), generator=gen, device=device)
    c = c * torch.tensor([W + 2.0 * S, H + 2.0 * S], device=device) - S
    far = 3.0 * S
    below = [float(np.nextafter(np.float32(k), np.float32(0))) for k in (1, 2, 8, 64)]
    nan, inf = float("nan"), float("inf")
    fixed = [[-far, -far], [W + far, H + far], [-far, H + far], [W + far, -far],
             [W / 2, -far], [W / 2, H + far], [-far, H / 2], [W + far, H / 2],
             *[[b, b] for b in below], [below[0], H / 2], [W / 2, below[1]],
             [-1e-8, -1e-8], [-1e-30, 5.0], [W - 1.0, H - 1.0], [0.0, 0.0],
             [nan, 10.0], [10.0, nan], [nan, nan], [inf, -inf], [-inf, inf], [inf, inf]]
    fixed = torch.tensor(fixed, dtype=torch.float32, device=device)
    c[: fixed.shape[0]] = fixed
    return c[torch.randperm(c.shape[0], generator=gen, device=device)[:n]]


def bound_bytes(img, centers, S: int, pad: int) -> int:
    """Bytes ``extract_blocks`` must move for these inputs: the image pixels its blocks
    cover (each read once), the centers, the blocks and the origins."""
    import torch

    from lcvo_tpu_torch.ops.klt_extract import extract_blocks_plain

    H, W = img.shape
    N = centers.shape[0]
    _, o = extract_blocks_plain(img, centers, S, pad)
    cover = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    r = torch.arange(S, device=img.device)
    oy = (o[:, 1].long()[:, None, None] + r[None, :, None]).clamp(0, H - 1)
    ox = (o[:, 0].long()[:, None, None] + r[None, None, :]).clamp(0, W - 1)
    cover[oy.expand(-1, S, S), ox.expand(-1, S, S)] = True
    elt = img.element_size()
    return int(cover.sum().item()) * elt + N * 2 * 4 + N * S * S * elt + N * 2 * 4


def kernel_phase(cfg) -> dict:
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.ops.klt_extract import extract_blocks, extract_blocks_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    calls = _level_calls(cfg)
    sizes = sorted({(H, W) for (H, W, _, _) in calls}, reverse=True)
    sizes += [(47, 155), (29, 155)]      # an odd width; S == H for S = 29
    max_err = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (H, W) in sizes:
            img = (torch.rand((H, W), generator=gen, device=dev) * 255).to(dtype)
            for N in (2048, 2047, 5, 1):
                for S in (21, 29, 30, 33):
                    for pad in (0, (S + 1) // 2):
                        if S > H + 2 * pad:
                            continue
                        c = _test_centers(N, H, W, S, gen, dev)
                        b, o = extract_blocks(img, c, S, pad=pad)
                        bp, op = extract_blocks_plain(img, c, S, pad=pad)
                        torch.cuda.synchronize()
                        err = max((b.float() - bp.float()).abs().max().item(),
                                  (o - op).abs().max().item())
                        max_err = max(max_err, err)
                        if not (torch.equal(b, bp) and torch.equal(o, op)
                                and o.dtype == c.dtype and b.dtype == dtype):
                            raise AssertionError(
                                f"extract_blocks differs from its plain version: {dtype} "
                                f"{H}x{W} N={N} S={S} pad={pad} max|err|={err}")
                        n_cases += 1
    _say(f"[kernel] extract_blocks == plain on {n_cases} cases (f32+bf16, sizes {sizes}, "
         f"N 2048/2047/5/1, S 21/29/30/33, pad 0 and (S+1)//2): max|err| {max_err}")

    # timing at the main path's level-0 target call: f32, N = 2048, S = 29, pad = 15 on
    # the unpadded level; and the same blocks with pad = 0 on the edge-padded copy
    H, W, S, p = calls[0]
    N = cfg.state.max_tracks + cfg.state.max_candidates
    img = torch.rand((H, W), generator=gen, device=dev) * 255
    c = torch.rand((N, 2), generator=gen, device=dev)
    c = c * torch.tensor([float(W), float(H)], device=dev)
    ms = graph_ms(lambda: extract_blocks(img, c, S, pad=p))
    plain_ms = graph_ms(lambda: extract_blocks_plain(img, c, S, pad=p))
    eager_ms = _eager_ms(lambda: extract_blocks(img, c, S, pad=p))
    nbytes = bound_bytes(img, c, S, p)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _say(f"[kernel] extract_blocks f32 {H}x{W} pad={p} N={N} S={S}: kernel {ms:.5f} ms "
         f"(graph replay; {eager_ms:.5f} ms per eager call with host launch cost), "
         f"plain pad+gather {plain_ms:.5f} ms, bytes moved {nbytes}, bound {bound_ms:.5f} ms, "
         f"bound/kernel {bound_ms / ms:.3f}")
    img_p = torch.nn.functional.pad(img[None, None], (p, p, p, p), mode="replicate")[0, 0]
    c_p = c + p
    ms0 = graph_ms(lambda: extract_blocks(img_p, c_p, S))
    plain_ms0 = graph_ms(lambda: extract_blocks_plain(img_p, c_p, S))
    nbytes0 = bound_bytes(img_p, c_p, S, 0)
    _say(f"[kernel] extract_blocks f32 {img_p.shape[0]}x{img_p.shape[1]} pad=0 N={N} S={S}: "
         f"kernel {ms0:.5f} ms, plain gather {plain_ms0:.5f} ms, bytes moved {nbytes0}, "
         f"bound {nbytes0 / HBM_BYTES_PER_S * 1e3:.5f} ms")
    kernels.reset_launches()
    return {
        "name": "extract_blocks",
        "route": "cuda",
        "source": "lcvo_tpu_torch/csrc/extract_blocks.cu",
        "replaces": "lcvo_tpu/ops/klt_pallas.py:94",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def render(seq, n: int) -> np.ndarray:
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        frames = list(ex.map(seq.frame, range(n)))
    return np.clip(np.rint(np.stack(frames)), 0, 255).astype(np.uint8)


def main_path_phase(cfg, profile_dir: str | None = None) -> dict:
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    seq = SyntheticSequence(n_frames=N_FRAMES + N_LATENCY, width=cfg.image_width,
                            height=cfg.image_height)
    t0 = time.perf_counter()
    frames = render(seq, N_FRAMES + N_LATENCY)
    _say(f"[main] rendered {len(frames)} frames {frames.shape[1:]} uint8 in "
         f"{time.perf_counter() - t0:.1f} s")
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    marks: list[tuple[float, int]] = []

    def on_chunk(start, Rs, ts, ok, ninl):
        marks.append((time.perf_counter(), len(ok)))

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = vo.run_chunked(frames[:N_FRAMES], chunk=CHUNK, on_chunk=on_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    gap = cfg.bootstrap.frame_gap
    est = np.asarray(traj)
    flags = np.asarray(vo.pose_ok_flags, bool)
    if est.shape != (N_FRAMES - gap, 3) or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory shape {est.shape} or non-finite entries")
    ok_rate = float(flags.mean())
    if ok_rate < POSE_OK_MIN:
        raise AssertionError(f"pose_ok on {ok_rate:.3f} of entries < {POSE_OK_MIN}")
    ate = ate_rmse(est, seq.gt_positions()[gap: gap + len(est)])
    if not ate < ATE_BOUND_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_BOUND_M} m")
    n_proc = N_FRAMES - 1   # frame pairs the tracker ran on: bootstrap hops + steps
    if launches["extract_blocks"] < 6 * n_proc:
        raise AssertionError(f"extract_blocks launched {launches['extract_blocks']} times "
                             f"on the main path, < 6 x {n_proc} processed frames")
    # marks: bootstrap end, chunk 1, chunk 2, then the per-frame tail
    chunk_ends = [t for t, n in marks if n == CHUNK]
    steady_fps = CHUNK / (chunk_ends[1] - chunk_ends[0])

    # no host round trip inside the step: every call that synchronises is listed
    img = torch.from_numpy(frames[N_FRAMES]).to("cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            vo._process(vo.state, img, vo._gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({f"{w.filename}:{w.lineno}" for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    if syncs:
        raise AssertionError(f"process_frame waits for the device at {syncs}")
    _say("[main] process_frame under torch.cuda.set_sync_debug_mode('warn'): no host sync")

    lat = []
    for f in frames[N_FRAMES:]:
        t1 = time.perf_counter()
        res = vo.step(f)
        res.R.cpu()
        lat.append((time.perf_counter() - t1) * 1e3)
    out = {
        "frames": N_FRAMES, "trajectory_len": len(est), "pose_ok_rate": ok_rate,
        "ate_m": ate, "wall_s": wall, "steady_fps": steady_fps,
        "chunk_ms_per_frame": 1e3 / steady_fps, "step_latency_ms_median": statistics.median(lat),
        "step_latency_ms": lat, "launches": launches, "rebootstraps": vo.n_rebootstraps,
    }
    _say("[main] " + json.dumps(out))
    if profile_dir:
        profile_chunk(vo, frames[N_FRAMES - CHUNK: N_FRAMES], profile_dir)
    return out


def profile_chunk(vo, frames, out_dir: str) -> None:
    """One more chunk of the main path under ``torch.profiler``: host and device span
    of each ``lcvo.*`` stage, device busy share, launches and the kernels with the
    most device time. Writes the summary to ``out_dir``. The profiler's own cost
    inflates the wall time; the shares are what it is for."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lcvo_tpu_torch.pipeline import make_chunk_fn

    chunk_fn = make_chunk_fn(vo.cfg, vo.K, vo.device)
    batch = torch.from_numpy(frames).to(vo.device)
    state = vo.state
    state, _ = chunk_fn(state, batch, vo._gen)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, outs = chunk_fn(state, batch, vo._gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # device activity: kernels and copies; the lcvo.* stage spans also appear on the
    # device timeline (as user annotations) and are counted apart
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    kern = [e for e in dev_events if not e.name.startswith("lcvo.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            busy += (cur_e - cur_s) if cur_e is not None else 0.0
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += (cur_e - cur_s) if cur_e is not None else 0.0
    by_kernel: dict = {}
    for e in kern:
        d = by_kernel.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    stages: dict = {}
    for e in events:
        if e.name.startswith("lcvo."):
            side = "host" if e.device_type == DeviceType.CPU else "device"
            d = stages.setdefault(f"{e.name} {side}", [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.elapsed_us()
    n = frames.shape[0]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    summary = {
        "frames": n, "wall_ms_per_frame": wall_us / n / 1e3,
        "device_busy_ms_per_frame": busy / n / 1e3, "device_idle_share": 1 - busy / wall_us,
        "device_ops_per_frame": len(kern) / n,
        "stage_span_ms_per_frame": {k: v[1] / n / 1e3 for k, v in sorted(stages.items())},
        "top_kernels_ms_per_frame": [[k, v[0] / n, v[1] / n / 1e3] for k, v in top],
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "main_path_profile.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    # the headline numbers on one short line; the top kernels only in the file
    _say("[profile] " + json.dumps({k: v for k, v in summary.items()
                                    if k != "top_kernels_ms_per_frame"}))


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one chunk of the main path; summary to DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.config import load_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _say(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {smi}; "
         f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.library()
    _say(f"[build] kernels built in {time.perf_counter() - t0:.1f} s into {kernels.BUILD_DIR}")

    cfg = load_config()
    row = kernel_phase(cfg)
    main = main_path_phase(cfg, args.profile)
    row["launches"] = main["launches"]["extract_blocks"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

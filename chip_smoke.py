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
   and infinite centers. Then the shapes of the second main path: the tracker's calls
   under ``configs/reference.yaml`` (window 21, so block sizes the kernel reads at run
   time), and the SIFT caller's (the three flattened (6*Hp, W) layer stacks, S = 59,
   N = 341, f32, centers built by ``frontend.sift.stack_centers`` with keypoints on the
   first and last rows of a layer and x past both borders; and S == W on a small
   stack). Tolerance: exact (the kernel is a copy). Times the kernel and the plain
   version at the default path's level-0 target call, with ``pad=0`` on the
   edge-padded copy of the same image, and at the SIFT caller's octave-0 call (beside
   the y-pad copy that precedes it), with CUDA graphs of back-to-back launches and
   CUDA events.
4. Main paths, on the same 42 synthetic corridor frames at 1240x376, each with the
   launch counters set to 0 just before and read just after, each through
   ``VisualOdometry(cfg, K, device="cuda").run_chunked(frames, chunk=16)`` (bootstrap,
   two chunks of 16, three tail frames):
   a. the default configuration (shi-mask, KLT bootstrap, eight-point): ATE < 0.03 m,
      >= 6 extraction launches per processed frame;
   b. ``configs/reference.yaml`` (sift-sift candidates, SIFT bootstrap, five-point
      solver, 21x21 KLT, 1024 keypoints): ATE under its own bound, >= 12 extraction
      launches per step (6 KLT + 6 SIFT) plus the bootstrap's 12.
   Both check a finite trajectory with one pose per frame from ``frame_gap`` on,
   ``pose_ok`` on >= 90% of entries, and that ``process_frame`` makes no host sync.
   Each prints its chunked steady-state frames/s, the per-frame latency of ``step``
   and the bootstrap's wall time.
   With ``--profile DIR``, one more chunk of each path runs under ``torch.profiler``
   afterwards (stage spans, device busy share, top kernels; summaries to DIR).
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
# The second main path and its ATE bound, set the same way: 8x the 0.012625 m the JAX
# package reaches on the CPU on the same 42 frames at 1240x376 with this file
# (tools/port_parity_cpu.py --config configs/reference.yaml --width 1240 --height 376
# --seed 0; the port reaches 0.010228 m there).
REF_CONFIG = os.path.join("configs", "reference.yaml")
REF_ATE_BOUND_M = 0.101
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


def _check_case(img, c, S: int, pad: int, what: str) -> float:
    """Kernel against plain version on one input, exact; returns max |err| (0.0)."""
    import torch

    from lcvo_tpu_torch.ops.klt_extract import extract_blocks, extract_blocks_plain

    b, o = extract_blocks(img, c, S, pad=pad)
    bp, op = extract_blocks_plain(img, c, S, pad=pad)
    torch.cuda.synchronize()
    err = max((b.float() - bp.float()).abs().max().item(), (o - op).abs().max().item())
    if not (torch.equal(b, bp) and torch.equal(o, op) and o.dtype == c.dtype
            and b.dtype == img.dtype):
        raise AssertionError(f"extract_blocks differs from its plain version: {what} "
                             f"{img.dtype} {tuple(img.shape)} N={c.shape[0]} S={S} pad={pad} "
                             f"max|err|={err}")
    return err


def _stack_keypoints(n: int, L: int, H: int, W: int, gen, device):
    """``n`` keypoints (xy, layer) on a (L, H, W) stack: random ones inside the image,
    and fixed ones on the first and last rows of the first and last layers and at x
    past both borders."""
    import torch

    xy = torch.rand((n, 2), generator=gen, device=device)
    xy = xy * torch.tensor([float(W), float(H)], device=device)
    li = torch.randint(0, L, (n,), generator=gen, device=device)
    fixed = [[5.3, 0.0, 0], [W / 2, H - 1.0, L - 1], [-7.5, 3.2, 0], [W + 9.0, H - 2.5, L - 1],
             [0.0, 0.0, L - 1], [W - 1.0, H - 1.0, 0], [W / 3, 0.0, L - 1], [W / 3, H - 1.0, 0]]
    fixed = torch.tensor(fixed, dtype=torch.float32, device=device)[:n]
    xy[: fixed.shape[0]] = fixed[:, :2]
    li[: fixed.shape[0]] = fixed[:, 2].long()
    return xy, li


def kernel_phase(cfg, ref_cfg) -> dict:
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.core.state import pyramid_dims
    from lcvo_tpu_torch.frontend import sift
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
                        max_err = max(max_err, _check_case(img, c, S, pad, "default path"))
                        n_cases += 1
    _say(f"[kernel] extract_blocks == plain on {n_cases} cases (f32+bf16, sizes {sizes}, "
         f"N 2048/2047/5/1, S 21/29/30/33, pad 0 and (S+1)//2): max|err| {max_err}")

    # the tracker's calls under the second main path's config: other window, so block
    # sizes that are not template arguments of the kernel
    ref_calls = _level_calls(ref_cfg)
    N = ref_cfg.state.max_tracks + ref_cfg.state.max_candidates
    n_ref = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (H, W, S, pad) in ref_calls:
            img = (torch.rand((H, W), generator=gen, device=dev) * 255).to(dtype)
            for S_call in (S, ref_cfg.klt.window + 6):     # target and template blocks
                c = _test_centers(N, H, W, S_call, gen, dev)
                max_err = max(max_err, _check_case(img, c, S_call, pad, "reference KLT"))
                n_ref += 1
    _say(f"[kernel] extract_blocks == plain on {n_ref} KLT cases of {REF_CONFIG} "
         f"(f32+bf16, N={N}, (H, W, S, pad) {ref_calls} and the template S="
         f"{ref_cfg.klt.window + 6}): max|err| {max_err}")

    # the SIFT caller's shapes: per octave the flattened, y-padded layer stack, with the
    # centers the caller builds; and a small stack whose block is as wide as the image
    det = ref_cfg.detector
    L = det.sift_scales_per_octave + 3
    k_oct = ref_cfg.descriptor.max_keypoints // det.sift_octaves
    # an octave halves the image as a pyramid level does (ceil)
    stacks = [(L, *hw) for hw in
              pyramid_dims(ref_cfg.image_height, ref_cfg.image_width, det.sift_octaves)]
    stacks.append((L, 40, 59))
    sift_shapes = []
    for shape in stacks:
        S = sift.block_size(1.6, shape[2])
        st = torch.rand(shape, generator=gen, device=dev)
        xy, li = _stack_keypoints(k_oct, *shape, gen, dev)
        flat, centers, _ = sift.stack_centers(st, li, xy, S)
        max_err = max(max_err, _check_case(flat, centers, S, 0, "SIFT stack"))
        # the caller itself, against the same call on the CPU
        got = sift._extract_stack_blocks(st, li, xy, S)
        want = sift._extract_stack_blocks(st.cpu(), li.cpu(), xy.cpu(), S)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"_extract_stack_blocks on the card differs from the CPU: {shape}")
        sift_shapes.append((tuple(flat.shape), S))
    _say(f"[kernel] extract_blocks == plain on {len(stacks)} SIFT stacks (f32, N={k_oct}, "
         f"flattened (L*Hp, W) and S: {sift_shapes}): max|err| {max_err}")

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

    # the level-0 target call of the tracker under the second main path's config
    # (window 21: S = 35, read at run time)
    H, W, S, p = ref_calls[0]
    ms35 = graph_ms(lambda: extract_blocks(img, c, S, pad=p))
    plain_ms35 = graph_ms(lambda: extract_blocks_plain(img, c, S, pad=p))
    nbytes35 = bound_bytes(img, c, S, p)
    _say(f"[kernel] extract_blocks f32 {H}x{W} pad={p} N={N} S={S} ({REF_CONFIG}): kernel "
         f"{ms35:.5f} ms, plain pad+gather {plain_ms35:.5f} ms, bytes moved {nbytes35}, bound "
         f"{nbytes35 / HBM_BYTES_PER_S * 1e3:.5f} ms, bound/kernel "
         f"{nbytes35 / HBM_BYTES_PER_S * 1e3 / ms35:.3f}")

    # timing at the SIFT caller's calls, octave by octave (keypoints inside the image,
    # on layers 1..s, as the detector gives them), and the y-pad copy of the stack that
    # precedes each; the octave-0 figures go into the kernel table
    sift_rows = []
    for shape in stacks[: det.sift_octaves]:
        S = sift.block_size(1.6, shape[2])
        st = torch.rand(shape, generator=gen, device=dev)
        xy = torch.rand((k_oct, 2), generator=gen, device=dev)
        xy = xy * torch.tensor([float(shape[2]), float(shape[1])], device=dev)
        li = torch.randint(1, L - 2, (k_oct,), generator=gen, device=dev)
        flat, centers, (_, p) = sift.stack_centers(st, li, xy, S)
        k_ms = graph_ms(lambda: extract_blocks(flat, centers, S))
        k_plain_ms = graph_ms(lambda: extract_blocks_plain(flat, centers, S))
        k_eager_ms = _eager_ms(lambda: extract_blocks(flat, centers, S))
        ypad_ms = graph_ms(
            lambda: torch.nn.functional.pad(st[None], (0, 0, p, p), mode="replicate"), inner=20)
        k_bytes = bound_bytes(flat, centers, S, 0)
        k_bound_ms = k_bytes / HBM_BYTES_PER_S * 1e3
        sift_rows.append((k_ms, k_plain_ms, k_bound_ms, ypad_ms))
        _say(f"[kernel] extract_blocks f32 SIFT octave {len(sift_rows) - 1}, flat "
             f"{tuple(flat.shape)} pad=0 N={k_oct} S={S}: kernel {k_ms:.5f} ms (graph replay; "
             f"{k_eager_ms:.5f} ms per eager call), plain gather {k_plain_ms:.5f} ms, bytes moved "
             f"{k_bytes}, bound {k_bound_ms:.5f} ms, bound/kernel {k_bound_ms / k_ms:.3f}; the "
             f"y-pad copy before it (replicate pad of {shape} by {p} rows) {ypad_ms:.5f} ms")
    sift_ms, sift_plain_ms, sift_bound_ms, ypad_ms = sift_rows[0]
    _say(f"[kernel] SIFT caller per frame (2 stacks per octave): extraction "
         f"{2 * sum(r[0] for r in sift_rows):.5f} ms, y-pad copies "
         f"{2 * sum(r[3] for r in sift_rows):.5f} ms")
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
        "sift_ms": sift_ms,
        "sift_plain_ms": sift_plain_ms,
        "sift_bound_ms": sift_bound_ms,
        "sift_ypad_ms": ypad_ms,
    }


def render(seq, n: int) -> np.ndarray:
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        frames = list(ex.map(seq.frame, range(n)))
    return np.clip(np.rint(np.stack(frames)), 0, 255).astype(np.uint8)


def main_path_phase(tag: str, cfg, seq, frames, ate_bound: float, min_launches: int,
                    profile_dir: str | None = None) -> dict:
    """Drive one configuration through ``run_chunked`` on the rendered frames, with the
    launch counters set to 0 just before and read just after, and check what came out.
    ``min_launches``: the fewest ``extract_blocks`` launches the run must have made."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

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
        raise AssertionError(f"[{tag}] trajectory shape {est.shape} or non-finite entries")
    ok_rate = float(flags.mean())
    if ok_rate < POSE_OK_MIN:
        raise AssertionError(f"[{tag}] pose_ok on {ok_rate:.3f} of entries < {POSE_OK_MIN}")
    ate = ate_rmse(est, seq.gt_positions()[gap: gap + len(est)])
    if not ate < ate_bound:
        raise AssertionError(f"[{tag}] ATE {ate} m >= {ate_bound} m")
    if launches["extract_blocks"] < min_launches:
        raise AssertionError(f"[{tag}] extract_blocks launched {launches['extract_blocks']} "
                             f"times on the main path, < {min_launches}")
    # marks: bootstrap end, chunk 1, chunk 2, then the per-frame tail
    chunk_ends = [t for t, n in marks if n == CHUNK]
    steady_fps = CHUNK / (chunk_ends[1] - chunk_ends[0])
    bootstrap_first_s = marks[0][0] - t0   # with every first-call cost of the process

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
        raise AssertionError(f"[{tag}] process_frame waits for the device at {syncs}")
    _say(f"[{tag}] process_frame under torch.cuda.set_sync_debug_mode('warn'): no host sync")

    lat = []
    for f in frames[N_FRAMES:]:
        t1 = time.perf_counter()
        res = vo.step(f)
        res.R.cpu()
        lat.append((time.perf_counter() - t1) * 1e3)

    # the bootstrap once more, warm, on a fresh VisualOdometry (it ends with a read-back)
    vo_b = VisualOdometry(cfg, seq.K, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vo_b.bootstrap(list(frames[: gap + 1]))
    torch.cuda.synchronize()
    bootstrap_warm_s = time.perf_counter() - t1

    out = {
        "config": tag, "frames": N_FRAMES, "trajectory_len": len(est), "pose_ok_rate": ok_rate,
        "ate_m": ate, "ate_bound_m": ate_bound, "wall_s": wall, "steady_fps": steady_fps,
        "chunk_ms_per_frame": 1e3 / steady_fps, "step_latency_ms_median": statistics.median(lat),
        "step_latency_ms": lat, "launches": launches, "min_launches": min_launches,
        "rebootstraps": vo.n_rebootstraps, "bootstrap_first_s": bootstrap_first_s,
        "bootstrap_warm_s": bootstrap_warm_s,
    }
    _say(f"[{tag}] " + json.dumps(out))
    if profile_dir:
        profile_chunk(vo, frames[N_FRAMES - CHUNK: N_FRAMES], profile_dir,
                      tag.replace(":", "_") + "_profile.json")
    return out


def profile_chunk(vo, frames, out_dir: str, fname: str) -> None:
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
    with open(os.path.join(out_dir, fname), "w") as fh:
        json.dump(summary, fh, indent=1)
    # the headline numbers on one short line; the top kernels only in the file
    _say(f"[profile] {fname} " + json.dumps({k: v for k, v in summary.items()
                                             if k != "top_kernels_ms_per_frame"}))


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one chunk of each main path; summaries to DIR")
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

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config()
    ref_cfg = load_config(os.path.join(root, REF_CONFIG))
    if (ref_cfg.image_height, ref_cfg.image_width) != (cfg.image_height, cfg.image_width):
        raise AssertionError("the two main paths share their frames, so their image size")
    row = kernel_phase(cfg, ref_cfg)

    from lcvo_tpu_torch.data.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=N_FRAMES + N_LATENCY, width=cfg.image_width,
                            height=cfg.image_height)
    t0 = time.perf_counter()
    frames = render(seq, N_FRAMES + N_LATENCY)
    _say(f"[main] rendered {len(frames)} frames {frames.shape[1:]} uint8 in "
         f"{time.perf_counter() - t0:.1f} s")
    # default path: every frame pair goes through the tracker (6 launches), bootstrap
    # hops included. Reference path: 6 KLT + 6 SIFT launches per step, and the SIFT
    # bootstrap describes its two endpoint frames (12 launches, no KLT hops).
    main = main_path_phase("main", cfg, seq, frames, ATE_BOUND_M, 6 * (N_FRAMES - 1),
                           args.profile)
    n_steps = N_FRAMES - 1 - ref_cfg.bootstrap.frame_gap
    ref = main_path_phase("main:reference", ref_cfg, seq, frames, REF_ATE_BOUND_M,
                          12 * n_steps + 12, args.profile)
    by_path = {"default": main["launches"]["extract_blocks"],
               "reference": ref["launches"]["extract_blocks"]}
    if min(by_path.values()) < 1:
        raise AssertionError(f"a main path never launched extract_blocks: {by_path}")
    row["launches"] = sum(by_path.values())
    row["launches_by_path"] = by_path
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path", "sift_ms",
            "sift_plain_ms", "sift_bound_ms", "sift_ypad_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

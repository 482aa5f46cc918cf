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
   stack). Then every KLT call of the paths this script drives, at its own image size,
   block size, pad and N: the target and template blocks of every pyramid level at
   1240x376 (default, throughput and turn_robust configurations), 416x160 (the stress
   scenes) and 800x600 and 640x480 (the layout replays). Tolerance: exact (the kernel is
   a copy). Times the kernel and the plain
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
   Then the two configurations with sliding-window BA, on the first 74 frames of the
   same corridor (bootstrap, four chunks of 16, three tail frames: 67 steps, 13
   keyframes at ``keyframe_every`` 5, so the ring of 10 wraps):
   c. ``configs/throughput.yaml`` (sift-sift candidates, KLT bootstrap, eight-point,
      BA window 10 at the ``newest`` gauge);
   d. ``configs/turn_robust.yaml`` (the same with full coarse-level KLT convergence,
      ``eps`` 0.003 and the sparser anchor-refit ladder), at ``cfg.seed`` 1.
   All four check a finite trajectory with one pose per frame from ``frame_gap`` on,
   ``pose_ok`` on >= 90% of entries, and that ``process_frame`` makes no host sync.
   Each prints its chunked steady-state frames/s, the per-frame latency of ``step``
   and the bootstrap's wall time. The BA paths also check: >= 12 extraction launches
   per step plus the bootstrap's 42; keyframes pushed (counted on the host) and refines
   run (counted on the device) both equal to what the cadence gives; no refine ended
   above the cost it started from (one read-back at the end); every ring slot real and
   ``head`` where 13 pushes leave it; and no host sync in a whole chunk of 16 frames
   with its keyframe steps. After each, the same file with ``ba.enabled`` off runs the
   same frames (``[main:<name>:ba_off]``: frames/s and ATE beside the BA run's).
   With ``--profile DIR``, one more chunk of each path runs under ``torch.profiler``
   afterwards (stage spans, ``lcvo.ba`` per keyframe, device busy share, top kernels;
   summaries to DIR).
5. Checkpoint, on the card: ``configs/turn_robust.yaml`` runs to a chunk boundary with
   ``checkpoint_every``, a fresh ``VisualOdometry`` resumes from the file and continues,
   and its trajectory must equal path d's exactly. Prints the file's size and the save
   and load times.
6. Renderers (``[render]``): the arena and corridor renderers of ``data/render.py`` on
   the card at 1240x376. A frame rendered twice is equal; the card's frame is held
   against the same renderer's CPU frame of the same pose (largest grey-level
   difference and share of differing pixels, under ``RENDER_MAX_DIFF`` and
   ``RENDER_MAX_DIFF_SHARE``); frames/s of rendering (batches of 16, fenced, host copy
   included) and of PNG encoding (standard-library writer, 4 threads) apart.
7. Replay (``[replay:kitti_turn]``): ``tools/port_make_replay_dataset.py`` writes
   ``REPLAY_FRAMES`` frames of the arena loop (the first straight, the first 90 degree
   turn and the frames after it) in the KITTI layout into a fresh directory under
   ``chiprun_out/``; then the CLI (``lcvo_tpu_torch.cli.run``, in process) replays them
   with ``configs/turn_robust.yaml`` at ``cfg.seed`` 1, ``--chunked --checkpoint-every
   128``, the launch counters and the native decoder's counters set to 0 just before and
   read just after. Checks: one pose per frame from ``frame_gap`` on; ``pose_ok`` on
   >= 90% of rows; ATE under its bound; the KITTI, RPE and per-segment scale figures
   present and finite; ``extract_blocks`` launches >= what the steps and the bootstrap
   give; every frame decoded by ``native/liblcvo_native.so`` (built here with ``make``;
   a failed build raises with the compiler's message); the growth of the process's RSS
   during the replay under ``REPLAY_RSS_GROWTH_MB``. Prints steady frames/s from the
   ``t`` stamps of ``metrics.jsonl``. Where matplotlib is not installed the line says
   so and the CLI runs through ``summarise_only`` (``main`` without ``trajectory.png``).
8. Resume through the CLI (``[replay:resume]``): the same command with ``--frames 200``
   into a second directory leaves one checkpoint; ``--resume`` of it with
   ``--frames REPLAY_FRAMES`` must write the ``trajectory.npz`` of the uninterrupted
   run, exactly.
9. Layered entry (``[streams:kernel]``): ``extract_blocks_layered`` against its plain
   version, exactly: at every call the streams path makes (L = 1/4/8 streams, f32 and
   bf16, one layer per stream: the KLT target and template blocks of every level with
   pad (S+1)//2, SIFT's flattened octave stacks with pad 0, and the SIFT caller under
   ``torch.func.vmap`` against its per-stream calls on the CPU), and on 90 cases of
   mixed layers (L 1/4/8 layers of 376x1240, S 21/29/33/35/59, pads per axis, centers
   past every edge); its time at the streams path's level-0 call for L = 1, 4, 8
   streams beside the 2-D call's.
10. Streams (``[streams]``): ``configs/turn_robust.yaml`` at ``cfg.seed`` 1, S = 1, 2, 4, 8
   streams bootstrapped by the single-stream bootstrap on the same frames, stacked, and
   run through ``parallel.streams.make_multistream_chunk_step`` for 4 chunks of 16, the
   launch counters set to 0 before and read after each S. Checks: only the layered
   entry launched, as often per batched step for every S; every stream's ATE under
   turn_robust's bound and pose_ok on >= 90%; no host sync in a batched chunk with
   keyframe steps (S = 8); on the first chunk with injected samples, stream 0 at S = 1
   equal to the unbatched ``chunk_fn`` exactly, and at S = 4 within
   ``STREAMS_S4_VS_S1_TOL`` of S = 1 (the other streams see other frames), while the
   same S = 4 run with stream 0 given stream 1's frames (the control) exceeds it. Prints
   aggregate frames/s over the chunks after the first, launches per batched step and,
   with ``--profile``, device ops per frame per stream at S = 8.
11. Processes (``[dist]``): ``torch.distributed``'s NCCL probe (available, version, device
   count); then a world of one NCCL rank in this process (``parallel.mesh.init_distributed``,
   a ``DeviceMesh`` of one): ``solve.ba.sharded.ba_solve_sharded`` on a seeded window of
   ``DIST_W`` keyframes and ``DIST_K`` landmarks equal to ``ba_solve`` exactly, with no
   host sync, its time beside ``ba_solve``'s; ``knn_match_ratio_sharded`` at
   ``DIST_MATCH`` equal to ``knn_match_ratio`` exactly; the streams chunk step of
   ``[streams]`` at S = 8 through the mesh equal to its run without one exactly, its
   layered launches counted (``launches_by_path.streams_mesh_S8``). Then ``DIST_RANKS``
   gloo ranks on the one card, each a process of its own with CUDA tensors: the sharded BA
   within the ``ba_solve`` line, the matcher exact, and ``tools/port_dryrun_multirank.py
   --device cuda --backend gloo``. NCCL holds one rank per card, so the two ranks check
   the cross-rank arithmetic and give no speed figure.
12. Candidate modes (``[main:sift-mask]``, ``[main:harris-mask]``, ``[main:shi-mask+ba]``):
   ``bench.py``'s three modes that no path above runs, through ``main_path_phase`` on the
   same frames (42, 42 and 74), each under 8x the JAX package's CPU figure, with the
   launch floor of its candidate stage (SIFT in sift-mask) and, for shi-mask+ba, the BA
   checks. They run right after the checkpoint phase.
13. Recovery (``[recovery]``, ``[recovery:run]``, ``[recovery:ba]``, ``[recovery:tracks]``):
   the first 64 corridor frames with seeded noise on frames 28-30, through ``run_chunked``
   and ``run`` (default configuration) and ``configs/turn_robust.yaml`` (chunked): one
   pose per frame from ``frame_gap`` on, at least one re-bootstrap, health 0 and the last
   8 poses good at the end, no more re-bootstraps than the JAX package on the CPU on the
   same frames and an ATE under the JAX file's 1.0 m where that package meets it, else
   ``JAX_ATE_FACTOR`` times its figure, the median step after the recovery within ``SCALE_SEAM`` of the one before,
   launches at or above the floor that counts the re-bootstrap's KLT chain, no host sync
   in a chunk of the corrupted frames; with BA, every bootstrap leaves an empty window and
   the mirror at 0, and keyframes pushed = refines run = the cadence over each segment,
   none above its starting cost. Then a track table cut to 8 refills past 24 by
   re-detection, and a cleared one is detected (pose_ok False, health >= 1).
14. Stress (``[stress]``): ``tests/test_stress.py``'s turn, textureless band with a moving
   occluder and arena corner through ``run``: at 416x160, where that file set its bounds,
   the turn and the corner with those bounds; at 1240x376 all three held to the JAX
   package's figures on the same frames (no more re-bootstraps than it, and the file's
   bound where it meets it, else ``JAX_ATE_FACTOR`` times its ATE).
15. Long run (``[longhorizon]``): 300 corridor frames through ``run``: the track budget
   holds (late median inliers above 8 and above 0.3x the early median, promotions in the
   last 100 frames), ATE under 8 m, frames/s, and the device's peak allocation after frame
   100 and at the end, which may not grow by more than ``LONGHORIZON_MEM_GROWTH_MB``.
   Phases 13-15 run after phase 12; the layout replays below run after phase 8.
16. Layouts (``[replay:malaga]``, ``[replay:parking]``): the dataset tool writes 120 frames
   in each layout and size on the card, the CLI replays them with ``--chunked``: one pose
   per frame from the dataset's gap on, pose_ok on >= 90% of rows, ATE under 8x the JAX
   CLI's CPU figure, every JPEG offered to the native decoder, counted as declined and
   read by PIL (Malaga, with its GPS ground truth), every PNG decoded natively (parking).
17. Output: ``[launch-floors]``, each path's lower limit on its launches (worked out
   from its configuration and re-bootstrap count, each path checked against it); the
   kernel table as one JSON line (the 2-D entry, whose ``launches_by_path`` holds every
   single-stream path above, and the layered entry), the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

The script imports neither JAX nor ``lcvo_tpu``.
"""

from __future__ import annotations

import glob
import json
import os
import signal
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
# The two BA paths, on BA_FRAMES frames, and their ATE bounds, set the same way: 8x the
# JAX package's CPU figure on the same 74 frames at 1240x376 with each file
# (tools/port_parity_cpu.py --config configs/<file> --width 1240 --height 376 --frames 74
# --seed S): 0.013236 m at seed 0 and 0.018652 m at seed 1 (the port reaches 0.016468 m
# and 0.019728 m there).
# turn_robust runs at cfg.seed 1. At seed 0 the two-view bootstrap on the card, with this
# file's KLT settings, draws a weak init (261 essential-matrix inliers against 688-705 at
# seeds 1-3) and the ATE is 1.03 m with BA and 1.73 m without: one of the wrong-bootstrap
# draws that both packages show on about 1 seed in 20 (PERF.md), not a matter of BA.
BA_FRAMES = 74           # 7 bootstrap + 4 chunks of 16 + 3 tail frames
THR_CONFIG = os.path.join("configs", "throughput.yaml")
THR_ATE_BOUND_M = 0.106
TURN_CONFIG = os.path.join("configs", "turn_robust.yaml")
TURN_SEED = 1
TURN_ATE_BOUND_M = 0.149
CKPT_CHUNKS = 2          # the checkpoint phase stops after this many chunks
POSE_OK_MIN = 0.9
# The card's renderer against the same code on the CPU, same pose: limits set from what
# the H100 showed (see PERF.md), with room for another CUDA version's rounding of a division.
RENDER_MAX_DIFF = 2            # grey levels
RENDER_MAX_DIFF_SHARE = 0.01   # share of pixels that differ at all
# The replay: the first straight (260 frames), the first 90 degree turn (45 frames at
# 2 deg/frame) and 95 frames after it: 140 m of path, so the KITTI metric has 100 m
# segments.
REPLAY_FRAMES = 400
REPLAY_RESUME_FRAMES = 200     # the interrupted run: one checkpoint, at frame 7 + 128
REPLAY_CKPT_EVERY = 128
# ATE bound of the replay. One seed is one draw of RANSAC on this turn: over seeds 1-6 on
# the same 400 frames rendered on the CPU (tools/port_replay_seeds.py; the command is in
# PERF.md) the JAX package's CLI on the CPU reads 0.1744-1.2314 m (median 0.2589) and the
# port's on the H100 0.1521-1.1036 m (median 0.3439), each with one weak draw above 1 m; at
# seed 1 the port reads 0.1521 m on those files and 0.2824 m on this phase's files rendered
# on the card, which differ by one grey level on a few pixels in a million. The bound is
# twice the port's median: above every draw of either package but the two weak ones, and
# under 4x this phase's reading.
REPLAY_JAX_CPU_ATE_M = 0.1744      # the JAX CLI at seed 1, on the CPU-rendered files
REPLAY_PORT_MEDIAN_ATE_M = 0.3439  # the port's median over seeds 1-6 on those files
REPLAY_ATE_BOUND_M = 0.688         # 2 x REPLAY_PORT_MEDIAN_ATE_M
# 400 frames of 1240x376 uint8 are 186 MB; the ingest stages a chunk and a look-ahead
# (2 x 16 frames, 15 MB) and the prefetch queue. From the end of the second chunk (when
# every library a step loads lazily is loaded) to the end of the replay 361 more frames
# pass, 161 MB if they were kept: the resident set may grow by a third of that.
REPLAY_RSS_GROWTH_MB = 55.0
# The streams path: configs/turn_robust.yaml at TURN_SEED, S streams in one batched
# chunk step, STREAMS_CHUNKS chunks of CHUNK frames after the bootstrap. Stream 0 of the
# batched step at S = 1 must be the unbatched chunk_fn exactly (the H100 shows it on all
# 16 frames). At S = 4 it is not: an op at 4x the batch rounds otherwise
# (tools/port_streams_divergence.py names the first), 7e-9 after one frame grows to
# 2.8e-3 after 16 with a few inlier counts off by 1-4 (PERF.md, Findings). The limit
# sits between that and the control, stream 0 fed stream 1's frames (one frame of
# motion apart), which the phase measures and requires to exceed it.
STREAMS = (1, 2, 4, 8)
STREAMS_CHUNKS = 4
STREAMS_S4_VS_S1_TOL = 1e-2
# The [dist] phase: the landmark-sharded BA at the window's shape (turn_robust's window of
# 10 keyframes, its 1024-track capacity), the row-sharded matcher at the reference path's
# shape, and the streams chunk step at S = 8 through a mesh. One card holds one NCCL
# rank, so the phase runs a world of one rank on NCCL in this process (where the sharded
# functions must equal the unsharded ones exactly), then two gloo ranks on the same card,
# each a process of its own, as a check of the cross-rank arithmetic: the BA is held to
# the ba_solve line of ROADMAP section C (cost0 1e-5 relative, final cost 5%, R 2e-4,
# t 2e-3, X 2e-2), the matcher is exact. It gives no speed or scaling figure.
DIST_W, DIST_K, DIST_FX = 10, 1024, 500.0
DIST_MATCH = (1024, 1024, 128)
DIST_RANKS = 2
DIST_RANK_TIMEOUT_S = 180
BA_LINE = {"cost0_rel": 1e-5, "cost_rel": 0.05, "R": 2e-4, "t": 2e-3, "X": 2e-2}
# The three candidate modes of bench.py that no earlier phase runs, as bench.py builds
# them (the VOConfig defaults with find_new_candidates_method set; "+ba" turns window BA
# on at its defaults): sift-mask and harris-mask on N_FRAMES frames, shi-mask+ba on
# BA_FRAMES. ATE bounds: 8x the JAX package's CPU figure on the same frames at seed 0
# (tools/port_parity_cpu.py --width 1240 --height 376 --packages jax --mode M [--ba]
# --frames F).
MODES = (("sift-mask", N_FRAMES, 0.0032837), ("harris-mask", N_FRAMES, 0.0027965),
         ("shi-mask+ba", BA_FRAMES, 0.0117692))
# The recovery and stress paths are held to what the JAX package does on the same
# frames on the CPU: no more re-bootstraps than it needs, and an ATE under the JAX test
# file's bound where the JAX package meets that bound, else under JAX_ATE_FACTOR times
# its figure.
JAX_ATE_FACTOR = 1.5


def jax_held_bound(jax_ate: float, file_bound: float) -> float:
    return file_bound if jax_ate < file_bound else JAX_ATE_FACTOR * jax_ate


# The recovery path: the first RECOVERY_FRAMES frames of the corridor with frames 28-30
# replaced by seeded uniform noise (data.synthetic.noise_burst), inside the second chunk
# of 16. JAX figures: tools/port_parity_cpu.py --width 1240 --height 376 --frames 64
# --burst 28 31 --packages jax [--per-frame] [--config configs/turn_robust.yaml --seed 1]
# as (ATE m, re-bootstraps); tests/test_fault_injection.py bounds both loops at 1.0 m.
# The chunked runs hold the pose from the burst to the end of its chunk and through the
# re-bootstrap (15 entries), hence their larger figure, above that bound in both packages.
RECOVERY_FRAMES = 64
RECOVERY_BURST = (28, 31)
RECOVERY_BURST_SEED = 0
RECOVERY_FILE_BOUND_M = 1.0
RECOVERY_JAX_CPU = (1.1957534, 1)        # default configuration, run_chunked
RECOVERY_RUN_JAX_CPU = (0.4732892, 1)    # default configuration, run
RECOVERY_BA_JAX_CPU = (1.1947748, 1)     # configs/turn_robust.yaml at seed 1, run_chunked
SCALE_SEAM = (0.75, 1.33)                 # median step after the recovery over before
# tests/test_stress.py's sequences, frame counts and bounds. The turn (4 deg/frame) and
# the arena corner (3 deg/frame) are past the default tracker's reach at 1240x376 in
# both packages: on these uint8 frames the JAX package on the CPU reads 1.38 m with 3
# re-bootstraps on the turn and 2.02 m with 2 on the corner, where the test file's 0.8 m
# bounds (and "no re-bootstrap" on the corner) were set at 416x160. So both run at
# 416x160 with the file's bounds, and at full width held to the JAX package's figures
# on the same frames (tools/port_parity_cpu.py --scene turn|arena|textureless --frames
# 60|70|60 --per-frame --width 1240 --height 376 --packages jax) by jax_held_bound: the
# textureless band to the file's 0.5 m (JAX: 0.0125 m, no re-bootstrap).
STRESS_FRAMES = 60
STRESS_ARENA_FRAMES = 70
STRESS_SMALL = (416, 160)
STRESS_FILE_BOUND_M = 0.8
STRESS_BAND_FILE_BOUND_M = 0.5
STRESS_TURN_JAX_CPU = (1.3800895, 3)
STRESS_ARENA_JAX_CPU = (2.0237058, 2)
STRESS_BAND_JAX_CPU = (0.0125160, 0)
# tests/test_longhorizon.py's run at the main paths' width; the device holds
# fixed-capacity state, so its peak allocation after frame 100 may not grow
LONGHORIZON_FRAMES = 300
LONGHORIZON_MEM_GROWTH_MB = 8.0
# The Malaga (800x600, JPEG frames, GPS ground truth) and parking (640x480, PNG) layouts
# through the CLI, cut to REPLAY_LAYOUT_FRAMES frames. ATE bounds: 8x the JAX CLI's
# figure on the CPU on files the dataset tool rendered there (python
# tools/port_make_replay_dataset.py --dataset D --frames 120 --out DIR --device cpu;
# python -m lcvo_tpu.cli.run --dataset D --data-root DIR --frames 120 --chunked).
REPLAY_LAYOUT_FRAMES = 120
REPLAY_LAYOUT_SIZES = {"malaga": (800, 600), "parking": (640, 480)}   # the tool's defaults
REPLAY_LAYOUT_JAX_CPU_ATE_M = {"malaga": 0.0484, "parking": 0.1359}


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


def _path_calls(cfgs) -> list[tuple[int, int, int, int, int]]:
    """(H, W, S, pad, N) of every KLT call of ``extract_blocks`` under these
    configurations: per pyramid level the target block and the template block (S = w+6)
    with the level's pad, at the track table's N (tracks + candidates) and at the
    tracks' and the candidates' own counts."""
    out = []
    for c in cfgs:
        ns = sorted({c.state.max_tracks + c.state.max_candidates, c.state.max_tracks,
                     c.state.max_candidates}, reverse=True)
        for (H, W, S, pad) in _level_calls(c):
            for S_call in (S, c.klt.window + 6):
                for N in ns:
                    if (H, W, S_call, pad, N) not in out:
                        out.append((H, W, S_call, pad, N))
    return out


def kernel_phase(cfg, ref_cfg, path_cfgs) -> dict:
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

    # every KLT call the driven paths make, at its own image size, block size, pad and N:
    # the main, BA, mode and recovery paths at 1240x376, the stress scenes at 416x160
    # and the layout replays at 800x600 and 640x480, with each level's template block
    path_calls = _path_calls(path_cfgs)
    n_path = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (H, W, S, pad, N) in path_calls:
            img = (torch.rand((H, W), generator=gen, device=dev) * 255).to(dtype)
            c = _test_centers(N, H, W, S, gen, dev)
            max_err = max(max_err, _check_case(img, c, S, pad, "driven path"))
            n_path += 1
    _say(f"[kernel] extract_blocks == plain on {n_path} cases of the driven paths' own calls "
         f"(f32+bf16, (H, W, S, pad, N) {path_calls}): max|err| {max_err}")

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


def _host_syncs(fn) -> list[str]:
    """Run ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` and return where
    it made the host wait for the device (file:line of each warning)."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted({f"{w.filename}:{w.lineno}" for w in caught
                   if "synchronizing CUDA operation" in str(w.message)})


def ba_checks(tag: str, vo, frames, n_frames: int) -> dict:
    """What a BA path must show after its run: the cadence's keyframes and refines, no
    refine above its starting cost, the ring as the pushes leave it, and a whole chunk
    (keyframe steps included) without a host sync."""
    import torch

    from lcvo_tpu_torch.pipeline import keyframes_in, make_chunk_fn

    ba = vo.cfg.ba
    if vo.n_rebootstraps:
        raise AssertionError(f"[{tag}] {vo.n_rebootstraps} re-bootstrap(s): the keyframe "
                             f"counts below assume none")
    steps = n_frames - 1 - vo.cfg.bootstrap.frame_gap
    want = steps // ba.keyframe_every
    refines, cost_up = vo.ba_refine_stats()
    ring = torch.cat([vo.window.kf_valid.to(torch.int32), vo.window.head[None],
                      vo.state.frame_idx[None]]).cpu().tolist()
    kf_valid, head, frame_idx = ring[:-2], ring[-2], ring[-1]
    got = {"steps": steps, "keyframes": vo.n_keyframes, "refines": refines,
           "refines_cost_up": cost_up, "ring_filled": sum(kf_valid), "ring_head": head,
           "frame_idx": frame_idx}
    ok = (vo.n_keyframes == want and refines == want and cost_up == 0
          and sum(kf_valid) == min(want, ba.window) and head == want % ba.window
          and frame_idx == steps == vo._frame_idx)
    if not ok:
        raise AssertionError(f"[{tag}] BA bookkeeping {got}, expected {want} keyframes and "
                             f"refines, none with a higher cost, head {want % ba.window}")
    if want <= ba.window:
        raise AssertionError(f"[{tag}] {want} keyframes do not wrap the ring of {ba.window}")

    # one more chunk under the sync detector, from the state the run ended in; the
    # carry is not kept and the generator is put back
    chunk_fn = make_chunk_fn(vo.cfg, vo.K, vo.device)
    batch = torch.from_numpy(frames[n_frames: n_frames + CHUNK]).to(vo.device)
    if keyframes_in(vo._frame_idx, batch.shape[0], ba.keyframe_every) < 1:
        raise AssertionError(f"[{tag}] the chunk under the sync detector holds no keyframe")
    gen_state = vo._gen.get_state()
    syncs = _host_syncs(lambda: chunk_fn(vo.chunk_carry(), batch, vo._gen,
                                         frame_idx=vo._frame_idx))
    vo._gen.set_state(gen_state)
    if syncs:
        raise AssertionError(f"[{tag}] the chunk step with BA waits for the device at {syncs}")
    _say(f"[{tag}] a chunk of {batch.shape[0]} frames with "
         f"{keyframes_in(vo._frame_idx, batch.shape[0], ba.keyframe_every)} keyframe step(s) under "
         f"torch.cuda.set_sync_debug_mode('warn'): no host sync")
    return got


def main_path_phase(tag: str, cfg, seq, frames, ate_bound: float, min_launches: int,
                    profile_dir: str | None = None, n_frames: int = N_FRAMES):
    """Drive one configuration through ``run_chunked`` on the first ``n_frames`` rendered
    frames, with the launch counters set to 0 just before and read just after, and check
    what came out. ``min_launches``: the fewest ``extract_blocks`` launches the run must
    have made. Returns the printed summary and the run's (4, 4) poses."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    vo = VisualOdometry(cfg, seq.K, device="cuda")
    marks: list[tuple[float, int]] = []
    inliers: list[int] = []

    def on_chunk(start, Rs, ts, ok, ninl):
        marks.append((time.perf_counter(), len(ok)))
        inliers.extend(int(n) for n in ninl)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = vo.run_chunked(frames[:n_frames], chunk=CHUNK, on_chunk=on_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    gap = cfg.bootstrap.frame_gap
    est = np.asarray(traj)
    poses = np.asarray(vo.poses)
    flags = np.asarray(vo.pose_ok_flags, bool)
    if est.shape != (n_frames - gap, 3) or not np.all(np.isfinite(est)):
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
    # marks: bootstrap end, the chunks, then the per-frame tail; the first chunk carries
    # first-call costs and is left out
    chunk_ends = [t for t, n in marks if n == CHUNK]
    steady_fps = CHUNK * (len(chunk_ends) - 1) / (chunk_ends[-1] - chunk_ends[0])
    bootstrap_first_s = marks[0][0] - t0   # with every first-call cost of the process

    # no host round trip inside the step: every call that synchronises is listed
    img = torch.from_numpy(frames[n_frames]).to("cuda")
    syncs = _host_syncs(lambda: vo._process(vo.state, img, vo._gen))
    if syncs:
        raise AssertionError(f"[{tag}] process_frame waits for the device at {syncs}")
    _say(f"[{tag}] process_frame under torch.cuda.set_sync_debug_mode('warn'): no host sync")
    ba = ba_checks(tag, vo, frames, n_frames) if cfg.ba.enabled else None

    lat = []
    for f in frames[n_frames: n_frames + N_LATENCY]:
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
        "config": tag, "seed": cfg.seed, "frames": n_frames, "trajectory_len": len(est),
        "pose_ok_rate": ok_rate, "bootstrap_inliers": inliers[0], "min_pnp_inliers": min(inliers[1:]),
        "ate_m": ate, "ate_bound_m": ate_bound, "wall_s": wall, "steady_fps": steady_fps,
        "chunk_ms_per_frame": 1e3 / steady_fps, "step_latency_ms_median": statistics.median(lat),
        "step_latency_ms": lat, "launches": launches, "min_launches": min_launches,
        "rebootstraps": vo.n_rebootstraps, "bootstrap_first_s": bootstrap_first_s,
        "bootstrap_warm_s": bootstrap_warm_s,
    }
    if ba is not None:
        out["ba"] = ba
    _say(f"[{tag}] " + json.dumps(out))
    if profile_dir:
        profile_chunk(vo, frames[n_frames - CHUNK: n_frames], profile_dir,
                      tag.replace(":", "_") + "_profile.json")
    return out, poses


def rate_without_ba(tag: str, cfg, seq, frames, n_frames: int) -> dict:
    """The same configuration with ``ba.enabled`` off on the same frames: what the
    keyframe steps cost end to end. Chunked frames/s as in ``main_path_phase``, ATE and
    pose_ok rate; nothing is checked but a finite trajectory."""
    import dataclasses

    import torch

    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, enabled=False))
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    chunk_ends: list[float] = []
    torch.cuda.synchronize()
    traj = vo.run_chunked(frames[:n_frames], chunk=CHUNK, on_chunk=lambda s, R, t, ok, ninl: (
        chunk_ends.append(time.perf_counter()) if len(ok) == CHUNK else None))
    est = np.asarray(traj)
    gap = cfg.bootstrap.frame_gap
    if est.shape != (n_frames - gap, 3) or not np.all(np.isfinite(est)):
        raise AssertionError(f"[{tag}] trajectory shape {est.shape} or non-finite entries")
    out = {"frames": n_frames,
           "steady_fps": CHUNK * (len(chunk_ends) - 1) / (chunk_ends[-1] - chunk_ends[0]),
           "ate_m": ate_rmse(est, seq.gt_positions()[gap: gap + len(est)]),
           "pose_ok_rate": float(np.mean(vo.pose_ok_flags)), "rebootstraps": vo.n_rebootstraps}
    _say(f"[{tag}] " + json.dumps(out))
    return out


def checkpoint_phase(tag: str, cfg, seq, frames, n_frames: int, want_poses) -> dict:
    """Checkpoint and resume on the card: run to a chunk boundary with
    ``checkpoint_every``, resume in a fresh ``VisualOdometry``, continue to ``n_frames``,
    and require the poses of the uninterrupted run (``want_poses``) exactly."""
    import tempfile

    import torch

    from lcvo_tpu_torch.pipeline import VisualOdometry

    stop = cfg.bootstrap.frame_gap + 1 + CKPT_CHUNKS * CHUNK
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        first = VisualOdometry(cfg, seq.K, device="cuda")
        first.run_chunked(frames[:stop], chunk=CHUNK, checkpoint_every=CKPT_CHUNKS * CHUNK,
                          checkpoint_path=path)
        if not os.path.exists(path) or os.path.exists(path + ".tmp"):
            raise AssertionError(f"[{tag}] no checkpoint at the chunk boundary, or a .tmp left")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first.save(path, stop)      # the same state again, timed alone
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        rest = VisualOdometry(cfg, seq.K, device="cuda")
        t0 = time.perf_counter()
        start = rest.resume(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if start != stop or rest._frame_idx != first._frame_idx:
        raise AssertionError(f"[{tag}] resumed at frame {start} (frame_idx {rest._frame_idx}), "
                             f"saved at {stop} (frame_idx {first._frame_idx})")
    rest.run_chunked_continue(iter(frames[start:n_frames]), start, chunk=CHUNK,
                              n_frames=n_frames)
    got = np.asarray(rest.poses)
    if got.shape != want_poses.shape or not np.array_equal(got, want_poses):
        worst = (float(np.abs(got - want_poses).max()) if got.shape == want_poses.shape
                 else float("nan"))
        raise AssertionError(f"[{tag}] the resumed run left the uninterrupted one: poses "
                             f"{got.shape} against {want_poses.shape}, max |diff| {worst}")
    out = {"saved_at_frame": stop, "frame_idx_at_save": first._frame_idx,
           "poses": len(got), "equal_to_uninterrupted": True, "file_bytes": size,
           "save_s": save_s, "load_s": load_s, "keyframes_after_resume": rest.n_keyframes,
           "refines_after_resume": rest.ba_refine_stats()[0]}
    _say(f"[{tag}] " + json.dumps(out))
    return out


def _launch_floor(cfg, steps: int, boots: int, extra_hops: int = 0) -> int:
    """The fewest ``extract_blocks`` launches of ``steps`` calls of ``process_frame`` and
    ``boots`` KLT bootstraps of ``frame_gap`` hops (the first) or ``rebootstrap_skip``
    hops (each re-bootstrap), plus ``extra_hops`` hops: 6 per tracked frame pair, 6 more
    per step where the candidates come from SIFT, and 6 per bootstrap that describes its
    last frame for the sift-sift table."""
    mode = cfg.find_new_candidates_method
    gap, skip = cfg.bootstrap.frame_gap, max(cfg.bootstrap.rebootstrap_skip, 1)
    per_step = 12 if mode.startswith("sift") else 6
    hops = (gap + skip * (boots - 1) if boots else 0) + extra_hops
    return per_step * steps + 6 * hops + (6 * boots if mode == "sift-sift" else 0)


def _scale_seam(est: np.ndarray, flags=None, pre_stop: int | None = None) -> float:
    """Median step length after a recovery over the one before it: the first and last
    8 steps of a chunked run, or (``flags``, ``pre_stop``) the healthy steps before index
    ``pre_stop`` against the healthy steps among the last 12, as the JAX package's
    per-frame test reads it."""
    d = np.linalg.norm(np.diff(est, axis=0), axis=1)
    if flags is None:
        return float(np.median(d[-8:]) / np.median(d[:8]))
    good = flags[:-1] & flags[1:] & (d > 1e-9)
    pre = d[:pre_stop][good[:pre_stop]]
    post = d[-12:][good[-12:]]
    if len(pre) < 5 or len(post) < 5:
        raise AssertionError(f"too few healthy steps around the burst: {len(pre)}, {len(post)}")
    return float(np.median(post) / np.median(pre))


def _recovery_run(tag: str, cfg, seq, frames, jax: tuple, chunked: bool) -> tuple:
    """One recovery run on the card: counters at 0 before, read after; one pose per
    frame from ``frame_gap`` on, at least one re-bootstrap and no more than the JAX
    package's ``jax = (ATE, re-bootstraps)`` on the same frames, ``health`` 0 at the end
    and the last 8 poses good, ATE under ``jax_held_bound``, the scale seam inside
    ``SCALE_SEAM`` and launches at or above the floor."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    n = len(frames)
    gap, skip = cfg.bootstrap.frame_gap, max(cfg.bootstrap.rebootstrap_skip, 1)
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    segments = []
    boot = vo.bootstrap

    def watched_bootstrap(*a, **k):     # steps since the previous bootstrap, and after it
        segments.append(vo._frame_idx)
        out = boot(*a, **k)
        if vo.window is not None and (vo._frame_idx or bool(vo.window.kf_valid.any())):
            raise AssertionError(f"[{tag}] a bootstrap left frame_idx {vo._frame_idx} or a "
                                 f"keyframe in the window")
        return out

    vo.bootstrap = watched_bootstrap
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if chunked:
        traj = vo.run_chunked(frames, chunk=CHUNK)
    else:
        traj = vo.run(iter(frames), n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["extract_blocks"]
    segments = segments[1:] + [vo._frame_idx]
    est = np.asarray(traj)
    flags = np.asarray(vo.pose_ok_flags, bool)
    n_reb = vo.n_rebootstraps
    if chunked:
        seam = _scale_seam(est)
        floor = _launch_floor(cfg, n - 1 - gap - (skip + 1) * n_reb, 1 + n_reb)
    else:
        seam = _scale_seam(est, flags, RECOVERY_BURST[0] - gap - 1)
        # every frame pair is tracked once, by a step or by a bootstrap chain
        floor = _launch_floor(cfg, 0, 0, extra_hops=n - 1)
    ate = ate_rmse(est, seq.gt_positions()[gap: gap + len(est)])
    jax_ate, jax_reb = jax
    bound = jax_held_bound(jax_ate, RECOVERY_FILE_BOUND_M)
    out = {"frames": n, "burst": list(RECOVERY_BURST), "burst_seed": RECOVERY_BURST_SEED,
           "chunked": chunked, "poses": len(est), "rebootstraps": n_reb,
           "health_end": int(vo.state.health), "last_8_pose_ok": bool(flags[-8:].all()),
           "pose_ok_rate": float(flags.mean()),
           "not_ok_indices": [int(i) for i in np.flatnonzero(~flags)],
           "ate_m": ate, "ate_bound_m": bound, "jax_cpu_ate_m": jax_ate,
           "jax_cpu_rebootstraps": jax_reb, "scale_seam": seam, "launches": launches, "launches_floor": floor,
           "steps_per_segment": segments, "wall_s": wall}
    _say(f"[{tag}] " + json.dumps(out))
    if est.shape != (n - gap, 3) or not np.all(np.isfinite(est)):
        raise AssertionError(f"[{tag}] trajectory shape {est.shape} or non-finite entries")
    if n_reb < 1 or out["health_end"] != 0 or not out["last_8_pose_ok"]:
        raise AssertionError(f"[{tag}] no recovery: {n_reb} re-bootstraps, health "
                             f"{out['health_end']}, last 8 pose_ok {flags[-8:].tolist()}")
    if n_reb > jax_reb:
        raise AssertionError(f"[{tag}] {n_reb} re-bootstraps, the JAX package {jax_reb}")
    if not ate < bound:
        raise AssertionError(f"[{tag}] ATE {ate} m >= {bound} m")
    if not SCALE_SEAM[0] < seam < SCALE_SEAM[1]:
        raise AssertionError(f"[{tag}] scale seam {seam} outside {SCALE_SEAM}")
    if launches < floor:
        raise AssertionError(f"[{tag}] extract_blocks launched {launches} times, < {floor}")
    return vo, out


def recovery_phase(cfg, turn_cfg, seq, clean) -> dict:
    """``[recovery]``: the default configuration through a seeded noise burst inside
    the second chunk, chunked (and one chunk of the burst's frames under the sync
    detector), then the same frames through the per-frame ``run``; ``[recovery:ba]``:
    ``configs/turn_robust.yaml`` through the same burst, with keyframes and refines held
    against the cadence that restarts at every bootstrap; ``[recovery:tracks]``: a
    track table cut to 8 refills, a cleared one is detected. Returns each run's
    launches and their floor by path."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.data.synthetic import noise_burst
    from lcvo_tpu_torch.pipeline import VisualOdometry, keyframes_in

    t_phase = time.perf_counter()
    frames = noise_burst(clean[:RECOVERY_FRAMES], *RECOVERY_BURST, seed=RECOVERY_BURST_SEED)
    by_path = {}
    vo, out = _recovery_run("recovery", cfg, seq, frames, RECOVERY_JAX_CPU, chunked=True)
    by_path["recovery"] = (out["launches"], out["launches_floor"])
    # a chunk of the burst and the frames around it, from the state the run ended in;
    # the carry is not kept and the generator is put back
    lo = cfg.bootstrap.frame_gap + 1 + CHUNK
    batch = torch.from_numpy(frames[lo: lo + CHUNK]).to("cuda")
    step = vo.make_chunk_step(CHUNK)
    gen_state = vo._gen.get_state()
    syncs = _host_syncs(lambda: step(vo.chunk_carry(), batch, vo._gen, frame_idx=vo._frame_idx))
    vo._gen.set_state(gen_state)
    if syncs:
        raise AssertionError(f"[recovery] the chunk step on corrupted frames waits for the "
                             f"device at {syncs}")
    _say(f"[recovery] a chunk of frames {lo}-{lo + CHUNK - 1} (noise on "
         f"{RECOVERY_BURST[0]}-{RECOVERY_BURST[1] - 1}) under "
         f"torch.cuda.set_sync_debug_mode('warn'): no host sync")

    _, out = _recovery_run("recovery:run", cfg, seq, frames, RECOVERY_RUN_JAX_CPU,
                           chunked=False)
    by_path["recovery_run"] = (out["launches"], out["launches_floor"])

    vo, out = _recovery_run("recovery:ba", turn_cfg, seq, frames, RECOVERY_BA_JAX_CPU,
                            chunked=True)
    every = turn_cfg.ba.keyframe_every
    want = sum(keyframes_in(0, s, every) for s in out["steps_per_segment"])
    refines, cost_up = vo.ba_refine_stats()
    ring = int(vo.window.kf_valid.sum())
    ba = {"keyframes": vo.n_keyframes, "refines": refines, "refines_cost_up": cost_up,
          "keyframes_from_cadence": want, "ring_filled": ring,
          "frame_idx_host": vo._frame_idx, "frame_idx_device": int(vo.state.frame_idx)}
    _say("[recovery:ba] " + json.dumps(ba))
    if not (vo.n_keyframes == refines == want > 0 and cost_up == 0
            and ring == min(out["steps_per_segment"][-1] // every, turn_cfg.ba.window)
            and ba["frame_idx_host"] == ba["frame_idx_device"]):
        raise AssertionError(f"[recovery:ba] BA bookkeeping across the re-bootstrap: {ba}")
    by_path["recovery_ba"] = (out["launches"], out["launches_floor"])

    # forced drop to 8 tracks, then total loss, on clean frames
    gap = cfg.bootstrap.frame_gap
    kernels.reset_launches()
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    vo.bootstrap(list(clean[: gap + 1]))
    for i in range(gap + 1, 20):
        vo.step(clean[i])
    before = int(vo.state.tracks.count())
    valid = vo.state.tracks.valid
    keep = torch.zeros_like(valid)
    keep[torch.nonzero(valid).flatten()[:8]] = True
    vo.state = vo.state._replace(tracks=vo.state.tracks._replace(valid=keep))
    counts = [int(vo.step(clean[i]).n_tracked) for i in range(20, 40)]
    health_after_drop = int(vo.state.health)
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    vo.bootstrap(list(clean[: gap + 1]))
    vo.step(clean[gap + 1])
    s = vo.state
    vo.state = s._replace(tracks=s.tracks._replace(valid=torch.zeros_like(s.tracks.valid)),
                          cands=s.cands._replace(valid=torch.zeros_like(s.cands.valid)))
    res = vo.step(clean[gap + 2])
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["extract_blocks"]
    floor = _launch_floor(cfg, (40 - gap - 1) + 2, 0, extra_hops=2 * gap)
    tr = {"tracks_before_drop": before, "tracks_after_drop_by_frame": counts,
          "health_after_refill": health_after_drop, "total_loss_pose_ok": bool(res.pose_ok),
          "total_loss_health": int(vo.state.health), "launches": launches, "launches_floor": floor}
    _say("[recovery:tracks] " + json.dumps(tr))
    if not (before > 20 and counts[-1] > 3 * 8 and health_after_drop == 0):
        raise AssertionError(f"[recovery:tracks] the table did not refill: {tr}")
    if tr["total_loss_pose_ok"] or tr["total_loss_health"] < 1:
        raise AssertionError(f"[recovery:tracks] total track loss not detected: {tr}")
    if launches < floor:
        raise AssertionError(f"[recovery:tracks] extract_blocks launched {launches} times, < {floor}")
    by_path["recovery_tracks"] = (launches, floor)
    _say(f"[recovery] phase seconds {time.perf_counter() - t_phase:.1f}")
    return by_path


def _stress_run(tag: str, cfg, K, frames, gt, ate_bound: float,
                max_rebootstraps: int | None) -> tuple:
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    n = len(frames)
    gap = cfg.bootstrap.frame_gap
    vo = VisualOdometry(cfg, K, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = vo.run(iter(frames), n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["extract_blocks"]
    est = np.asarray(traj)
    floor = _launch_floor(cfg, 0, 0, extra_hops=n - 1)
    ate = ate_rmse(est, gt[gap: gap + len(est)]) if len(est) == n - gap else float("nan")
    last5 = [bool(r.pose_ok) for r in vo.results[-5:]]
    out = {"frames": n, "poses": len(est), "ate_m": ate, "ate_bound_m": ate_bound,
           "health_end": int(vo.state.health), "rebootstraps": vo.n_rebootstraps,
           "rebootstraps_max": max_rebootstraps,
           "last_5_pose_ok": all(last5), "frames_per_s": n / wall, "launches": launches,
           "launches_floor": floor}
    _say(f"[stress] {tag}: " + json.dumps(out))
    faults = []
    if len(est) != n - gap or not np.all(np.isfinite(est)):
        faults.append(f"{len(est)} poses for {n} frames or non-finite")
    if not ate < ate_bound or not all(last5):
        faults.append(f"ATE {ate} m (bound {ate_bound}), last 5 pose_ok {last5}")
    if max_rebootstraps is not None and vo.n_rebootstraps > max_rebootstraps:
        faults.append(f"{vo.n_rebootstraps} re-bootstrap(s), at most {max_rebootstraps}")
    if launches < floor:
        faults.append(f"extract_blocks launched {launches} times, < {floor}")
    out["faults"] = [f"{tag}: {f}" for f in faults]
    return out


def stress_phase(cfg) -> dict:
    """``[stress]``: the three sequences of ``tests/test_stress.py`` through the per-frame
    ``run`` at the main paths' width, uint8 frames: a 60 degree turn in 15 frames (health
    0 and the last 5 poses good at the end), a textureless band with a moving occluder,
    and the arena's 90 degree corner. The turn and the corner run at 416x160 with that
    file's bounds (0.8 m; no re-bootstrap on the corner), and all three at full width
    held to the JAX package's figures on the same frames (``jax_held_bound``, and no more
    re-bootstraps than it needs; see ``STRESS_SMALL``). Every scene runs before a fault
    is raised. Returns each scene's launches and their floor."""
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.render import FastArenaRenderer
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence, trajectory_loop, trajectory_turn

    t_phase = time.perf_counter()
    n, m = STRESS_FRAMES, STRESS_ARENA_FRAMES
    by_path, faults = {}, []
    full = (cfg.image_width, cfg.image_height)
    for tag, (W, H), bound, max_reb in (
            ("sharp_turn_416x160", STRESS_SMALL, STRESS_FILE_BOUND_M, None),
            ("sharp_turn", full, jax_held_bound(STRESS_TURN_JAX_CPU[0], STRESS_FILE_BOUND_M),
             STRESS_TURN_JAX_CPU[1])):
        c = load_config(overrides={"image_width": W, "image_height": H})
        turn = SyntheticSequence(n_frames=n, width=W, height=H, trajectory=trajectory_turn(
            n, speed=0.3, turn_start=20, turn_frames=15, turn_deg=60))
        out = _stress_run(tag, c, turn.K, render(turn, n), turn.gt_positions(), bound, max_reb)
        if out["health_end"] != 0:
            out["faults"].append(f"{tag}: health {out['health_end']} at the end")
        faults += out["faults"]
        by_path["stress_" + tag] = (out["launches"], out["launches_floor"])
    W, H = cfg.image_width, cfg.image_height
    band = SyntheticSequence(n_frames=n, width=W, height=H, speed=0.3,
                             textureless_span=(10.0, 18.0), occluder=True)
    out = _stress_run("textureless_occluder", cfg, band.K, render(band, n), band.gt_positions(),
                      jax_held_bound(STRESS_BAND_JAX_CPU[0], STRESS_BAND_FILE_BOUND_M),
                      STRESS_BAND_JAX_CPU[1])
    faults += out["faults"]
    by_path["stress_textureless"] = (out["launches"], out["launches_floor"])
    for tag, (W, H), bound, max_reb in (
            ("arena_corner_416x160", STRESS_SMALL, STRESS_FILE_BOUND_M, 0),
            ("arena_corner", full, jax_held_bound(STRESS_ARENA_JAX_CPU[0], STRESS_FILE_BOUND_M),
             STRESS_ARENA_JAX_CPU[1])):
        c = load_config(overrides={"image_width": W, "image_height": H})
        arena = FastArenaRenderer(trajectory_loop(m, speed=0.3, straight_frames=25, turn_frames=30),
                                  W, H, margin=6.0, device="cuda")
        out = _stress_run(tag, c, arena.K, arena.frames_device(0, m).cpu().numpy(),
                          arena.gt_positions(), bound, max_reb)
        faults += out["faults"]
        by_path["stress_" + tag] = (out["launches"], out["launches_floor"])
    _say(f"[stress] phase seconds {time.perf_counter() - t_phase:.1f}")
    if faults:
        raise AssertionError("[stress] " + "; ".join(faults))
    return by_path


def longhorizon_phase(cfg) -> tuple[int, int]:
    """``[longhorizon]``: ``LONGHORIZON_FRAMES`` frames of the corridor renderer through
    the per-frame ``run`` (as ``tests/test_longhorizon.py``): late median inliers above 8
    and above 0.3x the early median, promotions in the last 100 frames, ATE finite and
    under 8 m; frames/s; the device's peak allocation after frame 100 and at the end
    (fixed-capacity state: it must not grow). Returns the run's launches and their floor."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.data.render import FastCorridorRenderer
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    n = LONGHORIZON_FRAMES
    seq = FastCorridorRenderer(n, cfg.image_width, cfg.image_height, device="cuda")
    frames = np.concatenate([seq.frames_device(s, min(s + 50, n)).cpu().numpy()
                             for s in range(0, n, 50)])
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    inliers, promoted, peak = [], [], {}

    def on_frame(i, res):
        inliers.append(int(res.n_inliers))
        promoted.append(int(res.n_promoted))
        if i == 100 - cfg.bootstrap.frame_gap:   # the pose of frame 100
            peak["after_frame_100"] = torch.cuda.max_memory_allocated() / 2**20

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = vo.run(iter(frames), n, on_frame=on_frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak["at_the_end"] = torch.cuda.max_memory_allocated() / 2**20
    launches = kernels.LAUNCHES["extract_blocks"]
    est = np.asarray(traj)
    gap = cfg.bootstrap.frame_gap
    gt = seq.gt_positions()[gap: gap + len(est)]
    early, late = float(np.median(inliers[:50])), float(np.median(inliers[-50:]))
    ate = ate_rmse(est[: len(gt)], gt[: len(est)])
    floor = _launch_floor(cfg, 0, 0, extra_hops=n - 1)
    out = {"frames": n, "poses": len(est), "inliers_early_median": early,
           "inliers_late_median": late, "promoted_last_100": int(sum(promoted[-100:])),
           "ate_m": ate, "rebootstraps": vo.n_rebootstraps, "frames_per_s": n / wall,
           "max_memory_allocated_mb": peak, "launches": launches, "launches_floor": floor}
    _say("[longhorizon] " + json.dumps(out))
    if not (late > 8 and late > 0.3 * early and out["promoted_last_100"] > 0):
        raise AssertionError(f"[longhorizon] the track budget leaked: {out}")
    if not (np.isfinite(ate) and ate < 8.0):
        raise AssertionError(f"[longhorizon] ATE {ate} m")
    if peak["at_the_end"] - peak["after_frame_100"] > LONGHORIZON_MEM_GROWTH_MB:
        raise AssertionError(f"[longhorizon] the device's peak allocation grew after frame "
                             f"100: {peak}")
    if launches < floor:
        raise AssertionError(f"[longhorizon] extract_blocks launched {launches} times, < {floor}")
    return launches, floor


def mode_overrides(mode: str) -> dict:
    """``bench.py``'s mode names as config overrides (``<mode>+ba`` turns BA on)."""
    if mode.endswith("+ba"):
        return {"find_new_candidates_method": mode[: -len("+ba")], "ba": {"enabled": True}}
    return {"find_new_candidates_method": mode}


def replay_layout_phase(root: str, dataset: str, jax_ate: float) -> tuple[int, int]:
    """``[replay:<dataset>]``: ``REPLAY_LAYOUT_FRAMES`` frames written by the dataset
    tool on the card in that dataset's layout and size, replayed by the CLI with
    ``--chunked`` and the default configuration, the launch and decoder counters at 0
    before. Checks one pose per frame from the dataset's bootstrap gap on, pose_ok on
    >= 90% of rows, ATE finite and under 8x the JAX CLI's figure on the same kind of
    files rendered on the CPU, and which decoder read every frame: Malaga's JPEGs are
    declined by the native decoder (counted) and read by PIL, parking's PNGs are all
    decoded natively. Malaga's ground truth is its GPS log (positions only). Returns the
    replay's launches and their floor."""
    import shutil

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data import native_loader
    from lcvo_tpu_torch.data.datasets import load_dataset

    sys.path.insert(0, os.path.join(root, "tools"))
    import port_make_replay_dataset

    tag = f"replay:{dataset}"
    work = os.path.join(root, "chiprun_out", f"smoke_replay_{dataset}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    N = REPLAY_LAYOUT_FRAMES
    try:
        made = port_make_replay_dataset.make_dataset(dataset, frames=N,
                                                     out=os.path.join(work, "data"), device="cuda")
        ds = load_dataset(dataset, os.path.join(work, "data"))
        gap = ds.bootstrap_pair[1]
        out_dir = os.path.join(work, "run")
        native_loader.reset_counts()
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary, plots = _run_cli(["--dataset", dataset, "--data-root", os.path.join(work, "data"),
                                   "--frames", str(N), "--chunked", "--out", out_dir], out_dir)
        wall = time.perf_counter() - t0
        launches = kernels.LAUNCHES["extract_blocks"]
        decoded = native_loader.counts()
    finally:
        shutil.rmtree(os.path.join(work, "data"), ignore_errors=True)
    cfg = load_config(overrides={"bootstrap": {"frame_gap": gap}})
    n_reb = summary["n_rebootstraps"]
    skip = max(cfg.bootstrap.rebootstrap_skip, 1)
    floor = _launch_floor(cfg, N - 1 - gap - (skip + 1) * n_reb, 1 + n_reb)
    # the CLI looks at frame 0 once for the image size, then every frame once
    want_decoder = ({"decoded": 0, "declined": N + 1} if dataset == "malaga"
                    else {"decoded": N + 1, "declined": 0})
    out = {"dataset": dataset, "size": [made["width"], made["height"]], "frames_on_disk": N,
           "summary": summary, "plots": plots, "wall_s": wall, "jax_cpu_ate_m": jax_ate,
           "ate_bound_m": 8 * jax_ate, "launches": launches, "launches_floor": floor,
           "decoder_counts": decoded, "decoder_counts_expected": want_decoder,
           "dataset_tool": made}
    _say(f"[{tag}] " + json.dumps(out))
    ate = summary.get("ate_rmse_m")
    if (made["width"], made["height"]) != REPLAY_LAYOUT_SIZES[dataset]:
        raise AssertionError(f"[{tag}] the tool wrote {made['width']}x{made['height']}, the "
                             f"kernel phase checked {REPLAY_LAYOUT_SIZES[dataset]}")
    if summary["frames"] != N - gap or summary["metric_rows"] != summary["frames"]:
        raise AssertionError(f"[{tag}] {summary['frames']} poses ({summary['metric_rows']} rows) "
                             f"for {N} frames at gap {gap}")
    if summary["pose_ok_rate"] < POSE_OK_MIN:
        raise AssertionError(f"[{tag}] pose_ok on {summary['pose_ok_rate']:.3f} of rows")
    if not (isinstance(ate, float) and np.isfinite(ate) and ate < 8 * jax_ate):
        raise AssertionError(f"[{tag}] ATE {ate} m, bound {8 * jax_ate} m")
    if dataset == "malaga" and summary.get("gt_type") != "positions_only":
        raise AssertionError(f"[{tag}] the GPS ground truth was not read: {summary}")
    if decoded != want_decoder:
        raise AssertionError(f"[{tag}] decoder counts {decoded}, expected {want_decoder}")
    if launches < floor:
        raise AssertionError(f"[{tag}] extract_blocks launched {launches} times, < {floor}")
    return launches, floor


def render_phase(smi: str) -> dict:
    """The port's renderers on the card at full size: deterministic, against the CPU
    frame of the same pose, and their rate beside the PNG encoder's."""
    import tempfile

    import torch

    from lcvo_tpu_torch.data.datasets import imwrite_gray_png
    from lcvo_tpu_torch.data.render import FastArenaRenderer, FastCorridorRenderer
    from lcvo_tpu_torch.data.synthetic import trajectory_loop

    W, H = 1240, 376
    traj = trajectory_loop(REPLAY_FRAMES, 0.35, straight_frames=260, turn_frames=45)
    out = {"size": [W, H], "card": smi}
    worst, worst_share = 0, 0.0
    for name, make, idx in (
            ("arena", lambda d: FastArenaRenderer(traj, W, H, device=d), (0, 283)),
            ("arena_occluder", lambda d: FastArenaRenderer(traj, W, H, occluder=True, device=d), (290,)),
            ("corridor", lambda d: FastCorridorRenderer(64, W, H, device=d), (63,))):
        gpu, cpu = make("cuda"), make("cpu")
        per = []
        for i in idx:
            a = gpu.frame(i)
            if a.shape != (H, W) or a.dtype != np.uint8 or a.std() < 10.0:
                raise AssertionError(f"[render] {name} frame {i}: {a.dtype} {a.shape}, std {a.std()}")
            if not np.array_equal(a, gpu.frame(i)):
                raise AssertionError(f"[render] {name} frame {i} differs between two renders")
            if not np.array_equal(a, gpu.frames_device(i - i % 4, i - i % 4 + 4)[i % 4].cpu().numpy()):
                raise AssertionError(f"[render] {name} frame {i} differs inside a batch")
            d = np.abs(a.astype(np.int16) - cpu.frame(i).astype(np.int16))
            per.append({"frame": i, "max_diff": int(d.max()), "share_differing": float((d > 0).mean())})
            worst, worst_share = max(worst, int(d.max())), max(worst_share, float((d > 0).mean()))
        out[name] = per
    out["max_diff"], out["max_share_differing"] = worst, worst_share
    out["limits"] = {"max_diff": RENDER_MAX_DIFF, "share_differing": RENDER_MAX_DIFF_SHARE}
    if worst > RENDER_MAX_DIFF or worst_share > RENDER_MAX_DIFF_SHARE:
        raise AssertionError(f"[render] card against CPU: {json.dumps(out)}")

    r = FastArenaRenderer(traj, W, H, device="cuda")
    r.frames_device(0, CHUNK).cpu()                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 8
    for k in range(reps):
        frames = r.frames_device(k * CHUNK, (k + 1) * CHUNK).cpu().numpy()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    out["render_fps"] = reps * CHUNK / render_s
    out["render_ms_per_frame"] = 1e3 * render_s / (reps * CHUNK)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        for k in range(4):
            list(pool.map(lambda j: imwrite_gray_png(os.path.join(tmp, f"{k}_{j}.png"), frames[j], level=1),
                          range(CHUNK)))
        enc_s = time.perf_counter() - t0
        out["png_bytes_per_frame"] = os.path.getsize(os.path.join(tmp, "0_0.png"))
    out["encode_fps_4_threads"] = 4 * CHUNK / enc_s
    _say("[render] " + json.dumps(out))
    return out


def _rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS in /proc/self/status")


class _RssSampler:
    """Resident set of this process while the block runs, sampled every 50 ms on the
    clock that stamps ``metrics.jsonl`` (``time.monotonic``)."""

    def __enter__(self):
        import threading

        self.samples = [(time.monotonic(), _rss_mb())]
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(0.05):
                self.samples.append((time.monotonic(), _rss_mb()))

        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.samples.append((time.monotonic(), _rss_mb()))

    def peak_mb(self, since: float = 0.0) -> float:
        return max(r for t, r in self.samples if t >= since)

    def at_mb(self, when: float) -> float:
        """The last sample taken at or before ``when``."""
        return [r for t, r in self.samples if t <= when][-1]


def _run_cli(argv: list[str], out_dir: str) -> tuple[dict, str]:
    """The port's CLI in process: ``main`` whole where matplotlib is installed (and then
    ``trajectory.png`` must exist), else ``summarise_only``, said in plain words. No
    error of the run is caught."""
    import importlib.util

    from lcvo_tpu_torch.cli import run as cli_run

    if importlib.util.find_spec("matplotlib") is None:
        return cli_run.summarise_only(argv), "matplotlib is not installed on this machine"
    summary = cli_run.main(argv)
    if not os.path.exists(os.path.join(out_dir, "trajectory.png")):
        raise AssertionError(f"the CLI wrote no trajectory.png into {out_dir}")
    return summary, "trajectory.png written"


def replay_phase(root: str, smi: str) -> tuple[dict, int]:
    """An on-disk turn dataset through the product's entry point: written by the dataset
    tool, decoded by the native library on the Prefetcher's thread, replayed by the CLI.
    Then the same replay interrupted and resumed through the CLI. Returns the printed
    summary and the replay's ``extract_blocks`` launches."""
    import shutil

    from lcvo_tpu_torch.data import native_loader

    sys.path.insert(0, os.path.join(root, "tools"))
    tag = "replay:kitti_turn"
    work = os.path.join(root, "chiprun_out", "smoke_replay")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if not native_loader.available():
        raise AssertionError(f"[{tag}] the native PNG decoder is not loaded: "
                             f"{native_loader.build_error()}")
    try:
        return _replay_checks(root, smi, work, tag)
    finally:
        # 400 PNGs are ~130 MB: what stays under chiprun_out/ is the runs' small files
        shutil.rmtree(os.path.join(work, "data"), ignore_errors=True)
        for d in ("run_a", "run_b", ""):
            for f in glob.glob(os.path.join(work, d, "checkpoint*.npz")):
                os.remove(f)


def _replay_checks(root: str, smi: str, work: str, tag: str) -> tuple[dict, int]:
    import shutil

    import yaml

    import port_make_replay_dataset
    import port_run_replay
    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data import native_loader

    made = port_make_replay_dataset.make_dataset("kitti-turn", frames=REPLAY_FRAMES,
                                                 out=os.path.join(work, "data"), device="cuda")
    if made["written"] != REPLAY_FRAMES:
        raise AssertionError(f"[{tag}] the dataset tool wrote {made['written']} frames into a fresh directory")
    _say(f"[{tag}] dataset " + json.dumps(made))

    # the file's own settings at seed 1: the CLI has no seed flag, the YAML carries it
    with open(os.path.join(root, TURN_CONFIG)) as fh:
        doc = yaml.safe_load(fh)
    doc["seed"] = TURN_SEED
    cfg_path = os.path.join(work, "turn_robust_seed1.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(doc, fh)
    cfg = load_config(cfg_path)

    def argv(out, *extra):
        return ["--config", cfg_path, "--dataset", "kitti", "--data-root", os.path.join(work, "data"),
                "--chunked", "--checkpoint-every", str(REPLAY_CKPT_EVERY), "--out", out, *extra]

    # what one frame costs the Prefetcher's thread, beside a step's tens of milliseconds
    from lcvo_tpu_torch.data.datasets import kitti

    ds = kitti(made["root"])
    t0 = time.perf_counter()
    for i in range(2 * CHUNK):
        ds.frame(i)
    decode_ms = 1e3 * (time.perf_counter() - t0) / (2 * CHUNK)

    out_a = os.path.join(work, "run_a")
    native_loader.reset_counts()
    kernels.reset_launches()
    with _RssSampler() as rss:
        summary, plots = _run_cli(argv(out_a), out_a)
    launches = kernels.LAUNCHES["extract_blocks"]
    decoded = native_loader.counts()

    N, gap, skip = REPLAY_FRAMES, cfg.bootstrap.frame_gap, max(cfg.bootstrap.rebootstrap_skip, 1)
    n_reb = summary["n_rebootstraps"]
    # 6 KLT + 6 SIFT launches per step, the KLT bootstrap's 6 per hop and 6 for its last
    # frame's descriptors; a re-bootstrap holds skip + 1 frames back from the steps
    want_launches = (6 * gap + 6) + 12 * (N - 1 - gap) - 12 * (skip + 1) * n_reb
    # RSS once everything a step loads lazily is loaded (the end of the second chunk)
    # against its peak over the rest of the replay: frames kept would show here
    warm_rows = 1 + 2 * CHUNK
    with open(os.path.join(out_a, "metrics.jsonl")) as fh:
        t_warm = json.loads(fh.readlines()[warm_rows - 1])["t"]
    rss_warm = rss.at_mb(t_warm)
    finite = ("ate_rmse_m", "kitti_t_err_pct", "kitti_r_err_deg_per_m", "rpe_trans_rmse_m",
              "rpe_rot_rmse_deg", "seg_scale_worst")
    bad = [k for k in finite if not (isinstance(summary.get(k), float) and np.isfinite(summary[k]))]
    out = {
        "frames_on_disk": N, "summary": summary, "plots": plots, "card": smi,
        "ate_bound_m": REPLAY_ATE_BOUND_M, "jax_cpu_ate_m": REPLAY_JAX_CPU_ATE_M,
        "ate_over_jax_cpu": summary["ate_rmse_m"] / REPLAY_JAX_CPU_ATE_M,
        "ate_over_port_seed_median": summary["ate_rmse_m"] / REPLAY_PORT_MEDIAN_ATE_M,
        "launches": launches, "launches_formula": want_launches,
        "decoder": "native" if decoded == {"decoded": N + 1, "declined": 0} else f"mixed: {decoded}",
        "native_decoded": decoded["decoded"], "native_declined": decoded["declined"],
        "decode_ms_per_frame": decode_ms, "prefetch_depth": cfg.runtime.prefetch_depth,
        "steady_fps_from_t_stamps": port_run_replay.steady_fps(os.path.join(out_a, "metrics.jsonl")),
        "rss_mb_at_start": rss.samples[0][1], "rss_mb_warm": rss_warm, "rss_mb_peak": rss.peak_mb(),
        "rss_growth_mb_over_frames_after_warm": rss.peak_mb(t_warm) - rss_warm,
        "frames_after_warm": N - gap - warm_rows, "rss_growth_limit_mb": REPLAY_RSS_GROWTH_MB,
        "mb_if_those_frames_were_staged": (N - gap - warm_rows) * 1240 * 376 / 2**20,
    }
    _say(f"[{tag}] " + json.dumps(out))
    if summary["frames"] != N - gap:
        raise AssertionError(f"[{tag}] {summary['frames']} poses for {N} frames at gap {gap}")
    if summary["pose_ok_rate"] < POSE_OK_MIN:
        raise AssertionError(f"[{tag}] pose_ok on {summary['pose_ok_rate']:.3f} of rows < {POSE_OK_MIN}")
    if bad:
        raise AssertionError(f"[{tag}] summary keys absent or not finite: {bad}")
    if not summary["ate_rmse_m"] < REPLAY_ATE_BOUND_M:
        raise AssertionError(f"[{tag}] ATE {summary['ate_rmse_m']} m >= {REPLAY_ATE_BOUND_M} m")
    if launches < want_launches:
        raise AssertionError(f"[{tag}] extract_blocks launched {launches} times, < {want_launches}")
    if out["decoder"] != "native":
        raise AssertionError(f"[{tag}] frames not all served by the native decoder: {decoded} "
                             f"for {N} frames and the CLI's first look at frame 0")
    if out["rss_growth_mb_over_frames_after_warm"] > REPLAY_RSS_GROWTH_MB:
        raise AssertionError(f"[{tag}] RSS grew by {out['rss_growth_mb_over_frames_after_warm']:.0f} MB "
                             f"over the {out['frames_after_warm']} frames after the second chunk")
    for name in ("trajectory.npz", "metrics.jsonl", "checkpoint.npz"):
        if not os.path.exists(os.path.join(out_a, name)):
            raise AssertionError(f"[{tag}] the CLI left no {name}")

    # interrupted at REPLAY_RESUME_FRAMES, resumed from its one checkpoint
    tag = "replay:resume"
    out_b = os.path.join(work, "run_b")
    _run_cli(argv(out_b, "--frames", str(REPLAY_RESUME_FRAMES)), out_b)
    ck = os.path.join(out_b, "checkpoint.npz")
    with np.load(ck) as data:
        saved_at = int(data["frame_idx_host"])
    if saved_at != gap + 1 + REPLAY_CKPT_EVERY:
        raise AssertionError(f"[{tag}] checkpoint taken at frame {saved_at}, expected "
                             f"{gap + 1 + REPLAY_CKPT_EVERY}")
    ck_keep = os.path.join(work, "checkpoint_at_%d.npz" % saved_at)
    shutil.copy(ck, ck_keep)   # the resumed run writes later checkpoints over its own
    resumed, _ = _run_cli(argv(out_b, "--resume", ck_keep, "--frames", str(N)), out_b)
    with np.load(os.path.join(out_a, "trajectory.npz")) as a, \
            np.load(os.path.join(out_b, "trajectory.npz")) as b:
        pa, pb = a["positions"], b["positions"]
    same = pa.shape == pb.shape and np.array_equal(pa, pb)
    res = {"checkpoint_at_frame": saved_at, "resumed_to_frames": N, "poses": len(pb),
           "equal_to_uninterrupted": bool(same),
           "max_abs_diff_m": float(np.abs(pa - pb).max()) if pa.shape == pb.shape else None,
           "ate_rmse_m": resumed.get("ate_rmse_m"), "n_rebootstraps": resumed["n_rebootstraps"]}
    _say(f"[{tag}] " + json.dumps(res))
    if not same:
        raise AssertionError(f"[{tag}] the resumed CLI run left the uninterrupted one: {res}")
    return out, launches


def _profile_summary(prof, wall_us: float, n: int):
    """Per-frame figures of a profiled run of ``n`` frames: device busy time and idle
    share, device ops (kernels and copies), ``lcvo.*`` stage spans, top kernels. Returns
    the summary and the event lists it was read from."""
    from torch.autograd import DeviceType

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
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    summary = {
        "frames": n, "wall_ms_per_frame": wall_us / n / 1e3,
        "device_busy_ms_per_frame": busy / n / 1e3, "device_idle_share": 1 - busy / wall_us,
        "device_ops_per_frame": len(kern) / n,
        "stage_span_ms_per_frame": {k: v[1] / n / 1e3 for k, v in sorted(stages.items())},
        "top_kernels_ms_per_frame": [[k, v[0] / n, v[1] / n / 1e3] for k, v in top],
    }
    return summary, dev_events, kern, stages


def profile_chunk(vo, frames, out_dir: str, fname: str) -> None:
    """One more chunk of the main path under ``torch.profiler``: host and device span
    of each ``lcvo.*`` stage, device busy share, launches and the kernels with the
    most device time. Writes the summary to ``out_dir``. The profiler's own cost
    inflates the wall time; the shares are what it is for."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lcvo_tpu_torch.pipeline import make_chunk_fn

    chunk_fn = make_chunk_fn(vo.cfg, vo.K, vo.device)
    batch = torch.from_numpy(frames).to(vo.device)
    n = frames.shape[0]
    carry, _ = chunk_fn(vo.chunk_carry(), batch, vo._gen, frame_idx=vo._frame_idx)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, outs = chunk_fn(carry, batch, vo._gen, frame_idx=vo._frame_idx + n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary, dev_events, kern, stages = _profile_summary(prof, wall_us, n)
    # the keyframe step: host and device span of one lcvo.ba, and the device ops that
    # start inside its device-side span
    ba_dev = [(e.time_range.start, e.time_range.end) for e in dev_events if e.name == "lcvo.ba"]
    if ba_dev:
        inside = [e for e in kern if any(s0 <= e.time_range.start <= e0 for s0, e0 in ba_dev)]
        summary["ba_keyframes"] = len(ba_dev)
        summary["ba_device_busy_ms_per_keyframe"] = (
            sum(e.time_range.elapsed_us() for e in inside) / len(ba_dev) / 1e3)
        summary["ba_span_ms_per_keyframe"] = {
            side: stages[f"lcvo.ba {side}"][1] / stages[f"lcvo.ba {side}"][0] / 1e3
            for side in ("host", "device") if f"lcvo.ba {side}" in stages}
        summary["ba_device_ops_per_keyframe"] = len(inside) / len(ba_dev)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, fname), "w") as fh:
        json.dump(summary, fh, indent=1)
    # the headline numbers on one short line; the top kernels only in the file
    _say(f"[profile] {fname} " + json.dumps({k: v for k, v in summary.items()
                                             if k != "top_kernels_ms_per_frame"}))


def _layered_bound_bytes(img, centers, layer, S: int, pad: int) -> int:
    """Bytes the layered call must move: per layer what :func:`bound_bytes` counts for
    its centers, and the layer indices."""
    total = 0
    for li in range(img.shape[0]):
        mine = centers[layer == li]
        if mine.shape[0]:
            total += bound_bytes(img[li], mine, S, pad)
    return total + centers.shape[0] * 4


def _check_layered(img, c, layer, S: int, pad_y: int, pad_x: int, what: str) -> float:
    """Layered kernel against its plain version on one input, exactly; max |err| (0.0)."""
    import torch

    from lcvo_tpu_torch.ops.klt_extract import extract_blocks_layered, extract_blocks_layered_plain

    b, o = extract_blocks_layered(img, c, layer, S, pad_y, pad_x)
    bp, op = extract_blocks_layered_plain(img, c, layer, S, pad_y, pad_x)
    torch.cuda.synchronize()
    err = max((b.float() - bp.float()).abs().max().item(), (o - op).abs().max().item())
    if not (torch.equal(b, bp) and torch.equal(o, op)):
        raise AssertionError(f"extract_blocks_layered differs from its plain version: {what} "
                             f"{img.dtype} {tuple(img.shape)} N={c.shape[0]} S={S} pads "
                             f"{(pad_y, pad_x)} max|err|={err}")
    return err


def layered_kernel_phase(turn_cfg) -> dict:
    """The layered entry against its plain version, exactly. First at the calls the
    streams path makes, for L = 1, 4, 8 streams in f32 and bf16, one layer per stream
    as the batching rule builds it: the KLT target and template blocks of every pyramid
    level with pad (S+1)//2 on both axes (centers per stream past every edge), and
    SIFT's flattened octave stacks with pad 0 (the keypoints per stream that
    ``sift.stack_centers`` turns into centers); there the caller itself under
    ``torch.func.vmap`` is held against its per-stream calls on the CPU. Then L in
    {1, 4, 8} layers of the KITTI level-0 size, S in {21, 29, 33, 35, 59}, pads per axis
    ((p, p), (p, 0), (0, p) with p = (S+1)//2) and centers past every edge on mixed
    layers. Then its time at the streams path's level-0 target call for L = 1, 4, 8
    streams beside the 2-D call's, its plain version's and its bytes bound."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.core.state import pyramid_dims
    from lcvo_tpu_torch.frontend import sift
    from lcvo_tpu_torch.ops.klt_extract import (_stream_layers, extract_blocks,
                                                extract_blocks_layered,
                                                extract_blocks_layered_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    calls = _level_calls(turn_cfg)
    H, W, S0, p0 = calls[0]
    N = turn_cfg.state.max_tracks + turn_cfg.state.max_candidates
    det = turn_cfg.detector
    n_layers = det.sift_scales_per_octave + 3
    k_oct = turn_cfg.descriptor.max_keypoints // det.sift_octaves
    octaves = pyramid_dims(turn_cfg.image_height, turn_cfg.image_width, det.sift_octaves)
    max_err, n_path, n_vmap = 0.0, 0, 0
    path_shapes = set()
    for L in (1, 4, 8):
        layer_klt = _stream_layers(L, N, dev)
        layer_sift = _stream_layers(L, k_oct, dev)
        for dtype in (torch.float32, torch.bfloat16):
            for (h, w, S, pad) in calls:
                img = (torch.rand((L, h, w), generator=gen, device=dev) * 255).to(dtype)
                for S_call in (S, turn_cfg.klt.window + 6):      # target and template
                    c = torch.cat([_test_centers(N, h, w, S_call, gen, dev) for _ in range(L)])
                    max_err = max(max_err, _check_layered(img, c, layer_klt, S_call, pad, pad,
                                                           "streams KLT"))
                    path_shapes.add(("klt", h, w, S_call, pad))
                    n_path += 1
            for (h, w) in octaves:
                S = sift.block_size(1.6, w)
                sts = (torch.rand((L, n_layers, h, w), generator=gen, device=dev) * 255).to(dtype)
                kps = [_stack_keypoints(k_oct, n_layers, h, w, gen, dev) for _ in range(L)]
                flats, cs = zip(*[sift.stack_centers(sts[s], li, xy, S)[:2]
                                  for s, (xy, li) in enumerate(kps)])
                flat = torch.stack(flats)
                max_err = max(max_err, _check_layered(flat, torch.cat(cs), layer_sift, S, 0, 0,
                                                      "streams SIFT stack"))
                path_shapes.add(("sift", *flat.shape[1:], S, 0))
                n_path += 1
                if dtype == torch.float32:
                    # the caller under vmap (one layered launch) against its calls on the CPU
                    xys = torch.stack([xy for xy, _ in kps])
                    lis = torch.stack([li for _, li in kps])
                    got = torch.func.vmap(lambda g, li, xy: sift._extract_stack_blocks(g, li, xy, S))(
                        sts, lis, xys)
                    for s in range(L):
                        want = sift._extract_stack_blocks(sts[s].cpu(), lis[s].cpu(), xys[s].cpu(), S)
                        if not all(torch.equal(g[s].cpu(), v) for g, v in zip(got, want)):
                            raise AssertionError(f"vmap of _extract_stack_blocks on the card, stream "
                                                 f"{s} of {L}, differs from the CPU: {(h, w)}")
                    n_vmap += 1
    _say(f"[streams:kernel] extract_blocks_layered == plain on {n_path} cases at the streams "
         f"path's calls (L 1/4/8 streams, f32+bf16, one layer per stream; KLT N={N} per stream, "
         f"SIFT N={k_oct} per stream; (kind, H, W, S, pad) {sorted(path_shapes)}); vmap of "
         f"_extract_stack_blocks == its CPU calls on {n_vmap} cases: max|err| {max_err}")

    n_cases = 0
    for L in (1, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            img = (torch.rand((L, H, W), generator=gen, device=dev) * 255).to(dtype)
            for S in (21, 29, 33, 35, 59):
                p = (S + 1) // 2
                for pad_y, pad_x in ((p, p), (p, 0), (0, p)):
                    c = _test_centers(N, H, W, S, gen, dev)
                    layer = torch.randint(0, L, (N,), generator=gen, device=dev, dtype=torch.int32)
                    max_err = max(max_err, _check_layered(img, c, layer, S, pad_y, pad_x,
                                                          "mixed layers"))
                    n_cases += 1
    _say(f"[streams:kernel] extract_blocks_layered == plain on {n_cases} cases (L 1/4/8, "
         f"{H}x{W} layers, N={N}, S 21/29/33/35/59, f32+bf16, pads (p,p) (p,0) (0,p), mixed "
         f"layers): max|err| {max_err}")

    # the streams path's level-0 target call: L streams' images, N centers each
    times = {}
    for L in (1, 4, 8):
        img = torch.rand((L, H, W), generator=gen, device=dev) * 255
        c = torch.rand((L * N, 2), generator=gen, device=dev)
        c = c * torch.tensor([float(W), float(H)], device=dev)
        layer = torch.arange(L, device=dev, dtype=torch.int32).repeat_interleave(N)
        row = {"ms": graph_ms(lambda: extract_blocks_layered(img, c, layer, S0, p0, p0))}
        if L == 1:
            row["two_d_ms"] = graph_ms(lambda: extract_blocks(img[0], c, S0, pad=p0))
        row["plain_ms"] = graph_ms(lambda: extract_blocks_layered_plain(img, c, layer, S0, p0, p0),
                                   inner=10)
        row["bytes"] = _layered_bound_bytes(img, c, layer, S0, p0)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        times[L] = row
        _say(f"[streams:kernel] extract_blocks_layered f32 L={L} x {H}x{W} pad={p0} "
             f"N={L}x{N} S={S0}: " + json.dumps(row))
    kernels.reset_launches()
    top = times[8]
    return {"name": "extract_blocks_layered", "route": "cuda",
            "source": "lcvo_tpu_torch/csrc/extract_blocks.cu",
            "replaces": "lcvo_tpu/ops/klt_pallas.py:94", "max_abs_err": max_err,
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "ms_by_streams": {str(L): r["ms"] for L, r in times.items()},
            "two_d_ms_one_stream": times[1]["two_d_ms"]}


def _stream_poses(R, t):
    """Camera centers (world) of (..., 3, 3) world-to-camera rotations and (..., 3)
    translations: -R^T t."""
    return -np.einsum("...ji,...j->...i", R, t)


def streams_phase(cfg, seq, frames, profile_dir: str | None) -> tuple[dict, dict]:
    """S = 1, 2, 4, 8 streams of ``cfg`` through the batched chunk step, each stream
    bootstrapped by the single-stream bootstrap on the same frames (so every stream
    starts from the bootstrap the single-stream path of this file checks; the streams
    then differ by their RANSAC draws). Per S: aggregate frames/s over the chunks after
    the first, extraction launches per batched step, each stream's ATE and pose_ok; at
    S = 8 (the largest) a whole chunk with keyframe steps under the sync detector and,
    with ``--profile``, device ops per frame per stream. Then stream 0 at S = 4 against
    the S = 1 run on the first chunk with the same injected samples. Returns the phase's
    line and, for the ``[dist]`` phase, the bootstrapped streams, the frames and the
    poses of the S = 8 run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.parallel import streams as ps
    from lcvo_tpu_torch.pipeline import VisualOdometry

    dev = torch.device("cuda")
    gap = cfg.bootstrap.frame_gap
    n_chunks = STREAMS_CHUNKS
    S_max = max(STREAMS)
    vos = []
    for _ in range(S_max):
        vo = VisualOdometry(cfg, seq.K, device="cuda")
        vo.bootstrap(list(frames[: gap + 1]))
        vos.append(vo)
    batch = torch.from_numpy(frames[gap + 1: gap + 1 + n_chunks * CHUNK]).to(dev)
    step = ps.make_multistream_chunk_step(cfg, seq.K, device="cuda")
    gt = seq.gt_positions()[gap: gap + 1 + n_chunks * CHUNK]
    out = {"config": "turn_robust", "seed": cfg.seed, "frames_per_stream": gap + 1 + n_chunks * CHUNK,
           "chunk": CHUNK, "by_streams": {}}
    launches_per_step = {}
    for S in STREAMS:
        carry = ps.stack_streams([vo.chunk_carry() for vo in vos[:S]])
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        Rs, ts, oks, ends = [], [], [], []
        torch.cuda.synchronize()
        kernels.reset_launches()
        for k in range(n_chunks):
            fr = batch[None, k * CHUNK:(k + 1) * CHUNK].expand(S, -1, -1, -1)
            carry, (R, t, ok, _) = step(carry, fr, gen, frame_idx=k * CHUNK)
            packed = torch.cat([R.reshape(S, CHUNK, 9), t, ok[..., None].float()], -1).cpu().numpy()
            ends.append(time.perf_counter())
            Rs.append(packed[..., :9].reshape(S, CHUNK, 3, 3))
            ts.append(packed[..., 9:12])
            oks.append(packed[..., 12] > 0.5)
        launches = dict(kernels.LAUNCHES)
        if launches["extract_blocks_layered"] < 1 or launches["extract_blocks"] != 0:
            raise AssertionError(f"[streams] S={S}: launches {launches}: the batched path must "
                                 f"go through the layered entry only")
        launches_per_step[S] = launches["extract_blocks_layered"] / (n_chunks * CHUNK)
        R0, t0 = vos[0]._host_pose()
        centers = np.concatenate([np.repeat(_stream_poses(R0, t0)[None, None], S, 0),
                                  _stream_poses(np.concatenate(Rs, 1), np.concatenate(ts, 1))], 1)
        ok_rate = np.concatenate([np.ones((S, 1), bool), np.concatenate(oks, 1)], 1).mean(1)
        ates = [float(ate_rmse(centers[s], gt)) for s in range(S)]
        if S == S_max:
            run_max = {"vos": vos, "batch": batch, "R": np.concatenate(Rs, 1),
                       "t": np.concatenate(ts, 1), "pose_ok": np.concatenate(oks, 1)}
        row = {"aggregate_fps": S * CHUNK * (n_chunks - 1) / (ends[-1] - ends[0]),
               "fps_per_stream": CHUNK * (n_chunks - 1) / (ends[-1] - ends[0]),
               "launches": launches["extract_blocks_layered"],
               "launches_per_batched_step": launches_per_step[S],
               "ate_m": ates, "pose_ok_rate": ok_rate.tolist()}
        bad = [s for s in range(S) if not (np.all(np.isfinite(centers[s])) and ates[s] < TURN_ATE_BOUND_M
                                          and ok_rate[s] >= POSE_OK_MIN)]
        if bad:
            raise AssertionError(f"[streams] S={S}: streams {bad} fail the ATE bound "
                                 f"{TURN_ATE_BOUND_M} m or pose_ok >= {POSE_OK_MIN}: {row}")
        if S == S_max:
            # one more chunk with its keyframe steps, under the sync detector
            fidx = n_chunks * CHUNK
            nxt = torch.from_numpy(frames[gap + 1 + fidx: gap + 1 + fidx + CHUNK]).to(dev)
            nxt = nxt[None].expand(S, -1, -1, -1)
            syncs = _host_syncs(lambda: step(carry, nxt, gen, frame_idx=fidx))
            if syncs:
                raise AssertionError(f"[streams] S={S}: the batched chunk waits for the device at {syncs}")
            row["host_syncs_in_a_chunk_with_keyframes"] = 0
            if profile_dir:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0p = time.perf_counter()
                    step(carry, nxt, gen, frame_idx=fidx)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0p) * 1e6
                summary, _, _, _ = _profile_summary(prof, wall_us, CHUNK)
                summary["device_ops_per_frame_per_stream"] = summary["device_ops_per_frame"] / S
                os.makedirs(profile_dir, exist_ok=True)
                with open(os.path.join(profile_dir, f"streams_S{S}_profile.json"), "w") as fh:
                    json.dump(summary, fh, indent=1)
                row["profile"] = {k: v for k, v in summary.items()
                                  if k not in ("top_kernels_ms_per_frame", "stage_span_ms_per_frame")}
        out["by_streams"][str(S)] = row
        _say(f"[streams] S={S} " + json.dumps(row))
    if len(set(launches_per_step.values())) != 1:
        raise AssertionError(f"[streams] extraction launches per batched step grow with S: "
                             f"{launches_per_step}")

    # stream 0 at S = 4 against S = 1 and against the unbatched chunk_fn on the first
    # chunk, the same injected samples; stream k sees the frames k on. The control: the
    # same S = 4 run with stream 0 given stream 1's frames, read by the same check, shows
    # what the check reads when a stream reads another's data
    from lcvo_tpu_torch.pipeline import make_chunk_fn

    sgen = torch.Generator(device=dev)
    sgen.manual_seed(7)
    n_hyp = cfg.ransac.pnp_hypotheses
    valid = vos[0].state.tracks.valid.float()
    samples = torch.multinomial(valid, 4 * CHUNK * n_hyp * 3, replacement=True,
                                generator=sgen).reshape(4, CHUNK, n_hyp, 3)
    fr = torch.stack([batch[k: k + CHUNK] for k in range(4)])
    got = {}
    swapped = fr.clone()
    swapped[0] = fr[1]
    for key, S, images in ((1, 1, fr), (4, 4, fr), ("control", 4, swapped)):
        carry = ps.stack_streams([vo.chunk_carry() for vo in vos[:S]])
        _, (R, t, ok, ninl) = step(carry, images[:S], samples[:S], frame_idx=0)
        got[key] = (R[0].cpu(), t[0].cpu(), ok[0].cpu(), ninl[0].cpu())
    _, (R, t, ok, ninl) = make_chunk_fn(cfg, seq.K, "cuda")(vos[0].chunk_carry(), fr[0], samples[0],
                                                           frame_idx=0)
    got["unbatched"] = (R.cpu(), t.cpu(), ok.cpu(), ninl.cpu())

    def per_frame(a, b):
        d = torch.maximum((a[0] - b[0]).abs().amax((1, 2)), (a[1] - b[1]).abs().amax(1))
        return {"max_abs_diff_R_t_by_frame": d.tolist(),
                "pose_ok_equal": bool(torch.equal(a[2], b[2])),
                "n_inliers_equal": bool(torch.equal(a[3], b[3])),
                "n_inliers_diff": (a[3] - b[3]).tolist()}

    cmp = {"S4_vs_S1": per_frame(got[4], got[1]), "S1_vs_unbatched": per_frame(got[1], got["unbatched"]),
           "control_S4_stream1_frames_vs_S1": per_frame(got["control"], got[1])}
    diff = max(cmp["S4_vs_S1"]["max_abs_diff_R_t_by_frame"])
    control = max(cmp["control_S4_stream1_frames_vs_S1"]["max_abs_diff_R_t_by_frame"])
    one = cmp["S1_vs_unbatched"]
    out["stream0_S4_vs_S1_max_abs_diff"] = diff
    out["control_stream0_fed_stream1_frames_max_abs_diff"] = control
    out["stream0_S1_equals_unbatched"] = (max(one["max_abs_diff_R_t_by_frame"]) == 0.0
                                          and one["pose_ok_equal"] and one["n_inliers_equal"])
    out["stream0_comparisons"] = cmp
    _say(f"[streams] stream 0, first chunk, same samples (limit {STREAMS_S4_VS_S1_TOL} on S=4 "
         f"against S=1, which the control must exceed; S=1 equal to the unbatched chunk_fn): "
         + json.dumps(cmp))
    if not out["stream0_S1_equals_unbatched"]:
        raise AssertionError(f"[streams] the batched step at S=1 is not the unbatched chunk_fn: {one}")
    if not (diff <= STREAMS_S4_VS_S1_TOL and cmp["S4_vs_S1"]["pose_ok_equal"]):
        raise AssertionError(f"[streams] stream 0 at S=4 left the S=1 run: {cmp['S4_vs_S1']}")
    if not control > STREAMS_S4_VS_S1_TOL:
        raise AssertionError(f"[streams] stream 0 fed stream 1's frames reads {control}, within "
                             f"the limit {STREAMS_S4_VS_S1_TOL}: the check cannot tell them apart")
    out["launches_per_batched_step"] = launches_per_step[S_max]
    out["launches"] = sum(r["launches"] for r in out["by_streams"].values())
    return out, run_max


def _ba_scene(W: int, K: int, seed: int = 0) -> dict:
    """A seeded window: W cameras along +x looking at K points, 0.3 px of noise, the
    free poses and every landmark moved (``tests/multiprocess_worker.py``'s scene)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-4, -2, 6], [4, 2, 14], (K, 3))
    Rs, ts, obs = [], [], []
    for w in range(W):
        a = 0.02 * w
        Rw = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = -Rw @ np.array([0.4 * w, 0.0, 0.0])
        p = (Rw @ X.T).T + t
        Rs.append(Rw)
        ts.append(t)
        obs.append(p[:, :2] / p[:, 2:3] + rng.normal(0, 0.3 / DIST_FX, (K, 2)))
    t = np.stack(ts).astype(np.float32)
    tp = t + rng.normal(0, 0.01, t.shape).astype(np.float32)
    tp[:2] = t[:2]
    return {"R": np.stack(Rs).astype(np.float32), "t": tp,
            "X": (X + rng.normal(0, 0.05, X.shape)).astype(np.float32),
            "obs": np.stack(obs).astype(np.float32), "mask": np.ones((W, K), bool)}


def _match_inputs(seed: int = 0) -> dict:
    """Nq x Nt x D descriptors with a quarter of the queries planted among the targets."""
    rng = np.random.default_rng(seed)
    nq, nt, d = DIST_MATCH
    dq = rng.normal(size=(nq, d)).astype(np.float32)
    dt = rng.normal(size=(nt, d)).astype(np.float32)
    dt[: nq // 4] = dq[: nq // 4] + rng.normal(size=(nq // 4, d)).astype(np.float32) * 1e-3
    return {"dq": dq, "vq": rng.random(nq) < 0.9, "dt": dt, "vt": rng.random(nt) < 0.9}


def _ba_kwargs(cfg) -> dict:
    return {"iters": cfg.ba.gn_iters, "n_fix": 2, "huber": cfg.ba.huber_px / DIST_FX,
            "lam0": cfg.ba.damping}


def _ba_line_errors(got, ref) -> dict:
    """The ``ba_solve`` line's quantities of ``got`` against ``ref`` (BAResult-like)."""
    err = {f: float(np.abs(np.asarray(got[f]) - np.asarray(ref[f])).max()) for f in ("R", "t", "X")}
    err["cost0_rel"] = abs(float(got["cost0"]) - float(ref["cost0"])) / abs(float(ref["cost0"]))
    err["cost_rel"] = abs(float(got["cost"]) - float(ref["cost"])) / max(abs(float(ref["cost"])), 1e-12)
    return err


def _dist_rank(dev, argv) -> None:
    """One rank of the [dist] phase's gloo run (``run_ranks`` calls it): the sharded BA
    and matcher over the world and their unsharded forms on this rank, to ``<out>_rank<r>.npz``."""
    import torch
    import torch.distributed as dist

    from lcvo_tpu_torch.frontend.match import knn_match_ratio, knn_match_ratio_sharded
    from lcvo_tpu_torch.parallel.mesh import make_mesh
    from lcvo_tpu_torch.solve.ba.schur import BAProblem, ba_solve
    from lcvo_tpu_torch.solve.ba.sharded import ba_solve_sharded

    src, out = argv
    d = np.load(src)
    mesh = make_mesh(dist.get_world_size(), device_type=dev.type)
    prob = BAProblem(*(torch.from_numpy(d[k]).to(dev) for k in ("R", "t", "X", "obs", "mask")))
    kw = {k: d[f"kw_{k}"].item() for k in ("iters", "n_fix", "huber", "lam0")}
    got = {}
    for tag, res in (("sharded", ba_solve_sharded(prob, mesh, **kw)), ("one", ba_solve(prob, **kw))):
        for f in res._fields:
            got[f"{tag}_{f}"] = getattr(res, f).cpu().numpy()
    q, vq, t, vt = (torch.from_numpy(d[k]).to(dev) for k in ("dq", "vq", "dt", "vt"))
    for tag, (idx, ok) in (("sharded", knn_match_ratio_sharded(mesh, q, vq, t, vt)),
                           ("one", knn_match_ratio(q, vq, t, vt))):
        got[f"{tag}_idx"], got[f"{tag}_ok"] = idx.cpu().numpy(), ok.cpu().numpy()
    np.savez(f"{out}_rank{dist.get_rank()}.npz", **got)


def _dispatched_ops(fn) -> int:
    """How many operators ``fn()`` sends to the backend (each a launch or a collective)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _gloo_ranks_check(scene: dict, match: dict, kw: dict) -> dict:
    """``DIST_RANKS`` gloo ranks on this card, each a process of its own (``_dist_rank``):
    the sharded BA within the ``ba_solve`` line of each rank's own ``ba_solve`` and the
    same on every rank, the sharded matcher equal to the unsharded one."""
    import tempfile

    from lcvo_tpu_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory(prefix="dist_phase_") as work:
        src = os.path.join(work, "inputs.npz")
        np.savez(src, **scene, **match, **{f"kw_{k}": np.array(v) for k, v in kw.items()})
        t0 = time.perf_counter()
        run_ranks("chip_smoke.py:_dist_rank", DIST_RANKS, [src, os.path.join(work, "r")],
                  device="cuda", backend="gloo", timeout=DIST_RANK_TIMEOUT_S)
        ranks = [dict(np.load(os.path.join(work, f"r_rank{r}.npz"))) for r in range(DIST_RANKS)]
        two = {"backend": "gloo", "world": DIST_RANKS, "tensors": "cuda",
               "seconds": time.perf_counter() - t0}
    fields = ("R", "t", "X", "cost0", "cost")
    err = _ba_line_errors({f: ranks[0][f"sharded_{f}"] for f in fields},
                          {f: ranks[0][f"one_{f}"] for f in fields})
    bad = {k: v for k, v in err.items() if not v <= BA_LINE[k]}
    same = all(np.array_equal(r[f"sharded_{f}"], ranks[0][f"sharded_{f}"]) for r in ranks for f in fields)
    match_ok = all(np.array_equal(r["sharded_idx"], r["one_idx"]) and np.array_equal(r["sharded_ok"], r["one_ok"])
                   for r in ranks)
    two.update({"ba_vs_ba_solve": err, "ba_line": BA_LINE, "ba_same_on_every_rank": same,
                "match_equal": match_ok})
    if bad or not same or not match_ok:
        raise AssertionError(f"[dist] {DIST_RANKS} gloo ranks: {two}")
    return two


def _world_of_one_solvers(mesh, dev, scene: dict, match: dict, kw: dict) -> dict:
    """At one rank: the sharded BA equal to ``ba_solve`` and the sharded matcher equal to
    ``knn_match_ratio``, exactly; the BA with no host sync, its time beside ``ba_solve``'s
    (host clock, in turns) and the operators each dispatches."""
    import torch
    import torch.distributed as dist

    from lcvo_tpu_torch.frontend.match import knn_match_ratio, knn_match_ratio_sharded
    from lcvo_tpu_torch.solve.ba.schur import BAProblem, ba_solve
    from lcvo_tpu_torch.solve.ba.sharded import ba_solve_sharded

    one = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh_shape": mesh.shape, "group_size": dist.get_world_size(mesh.group("data"))}
    if one["backend"] != "nccl" or one["group_size"] != 1:
        raise AssertionError(f"[dist] a world of one on NCCL: {one}")
    prob = BAProblem(*(torch.from_numpy(scene[k]).to(dev) for k in ("R", "t", "X", "obs", "mask")))
    solvers = {"one": lambda: ba_solve(prob, **kw), "sharded": lambda: ba_solve_sharded(prob, mesh, **kw)}
    a, b = solvers["sharded"](), solvers["one"]()
    differ = [f for f in a._fields if not torch.equal(getattr(a, f), getattr(b, f))]
    if differ:
        raise AssertionError(f"[dist] world of one: ba_solve_sharded differs from ba_solve in {differ}")
    if not float(a.cost) < float(a.cost0):
        raise AssertionError(f"[dist] the sharded BA did not lower its cost: {float(a.cost0)} -> {float(a.cost)}")
    syncs = _host_syncs(solvers["sharded"])
    if syncs:
        raise AssertionError(f"[dist] ba_solve_sharded waits for the device at {syncs}")
    times = {"one": [], "sharded": []}
    for _ in range(3):
        for tag in ("one", "sharded", "sharded", "one"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                solvers[tag]()
            torch.cuda.synchronize()
            times[tag].append((time.perf_counter() - t0) / 5 * 1e3)
    one.update({"ba": f"W={DIST_W} K={DIST_K} iters={kw['iters']}", "ba_equal_to_ba_solve": True,
                "ba_cost0": float(a.cost0), "ba_cost": float(a.cost), "ba_host_syncs": 0,
                "ba_sharded_ms": statistics.median(times["sharded"]),
                "ba_solve_ms": statistics.median(times["one"]),
                "ba_sharded_ops": _dispatched_ops(solvers["sharded"]),
                "ba_solve_ops": _dispatched_ops(solvers["one"])})
    q, vq, tq, vt = (torch.from_numpy(match[k]).to(dev) for k in ("dq", "vq", "dt", "vt"))
    (i1, o1), (i2, o2) = knn_match_ratio_sharded(mesh, q, vq, tq, vt), knn_match_ratio(q, vq, tq, vt)
    if not (torch.equal(i1, i2) and torch.equal(o1, o2)):
        raise AssertionError("[dist] world of one: knn_match_ratio_sharded differs from knn_match_ratio")
    one.update({"match": "x".join(map(str, DIST_MATCH)), "match_equal": True,
                "match_ok": int(o1.sum())})
    return one


def _world_of_one_streams(cfg, seq, run_max: dict, mesh, dev) -> dict:
    """At one rank: the streams chunk step through the mesh, from the same carry and seed
    as the S = 8 run of ``[streams]``, equal to it exactly, with its layered launches."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.parallel import streams as ps
    from lcvo_tpu_torch.parallel.mesh import shard_batched_state

    vos, batch = run_max["vos"], run_max["batch"]
    S = len(vos)
    step = ps.make_multistream_chunk_step(cfg, seq.K, mesh=mesh, device="cuda")
    carry = shard_batched_state(ps.stack_streams([vo.chunk_carry() for vo in vos]), mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    got = {"R": [], "t": [], "pose_ok": []}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for k in range(STREAMS_CHUNKS):
        fr = shard_batched_state(batch[None, k * CHUNK:(k + 1) * CHUNK].expand(S, -1, -1, -1), mesh)
        carry, (R, t, ok, _) = step(carry, fr, gen, frame_idx=k * CHUNK)
        for name, x in (("R", R), ("t", t), ("pose_ok", ok)):
            got[name].append(x.cpu().numpy())
    launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    differ = [n for n in got if not np.array_equal(np.concatenate(got[n], 1), run_max[n])]
    if differ:
        raise AssertionError(f"[dist] the streams chunk step through the mesh differs from the "
                             f"batched chunk step in {differ}")
    if launches["extract_blocks"] != 0 or launches["extract_blocks_layered"] != 12 * STREAMS_CHUNKS * CHUNK:
        raise AssertionError(f"[dist] streams through the mesh launched {launches}")
    return {"streams": f"S={S} chunks={STREAMS_CHUNKS}x{CHUNK}", "streams_equal_to_batched": True,
            "streams_layered_launches": launches["extract_blocks_layered"]}


def dist_phase(cfg, seq, run_max: dict) -> dict:
    """``[dist]``: the NCCL probe; a world of one NCCL rank in this process (sharded BA =
    ``ba_solve`` and sharded matcher = ``knn_match_ratio`` exactly, the BA with no host
    sync and its time beside ``ba_solve``'s, the streams chunk step through the mesh =
    the S = 8 run of ``[streams]`` exactly, with its layered launches); then
    ``DIST_RANKS`` gloo ranks on this card (BA within the ``ba_solve`` line, matcher
    exact) and ``tools/port_dryrun_multirank.py`` on as many, which runs beside the
    untimed part. The group is destroyed at the end, and no process it started outlives it."""
    import socket

    import torch
    import torch.distributed as dist

    from lcvo_tpu_torch.parallel.mesh import init_distributed, make_mesh

    t_phase = time.perf_counter()
    probe = {"nccl_available": dist.is_nccl_available(),
             "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
             "gloo_available": dist.is_gloo_available(), "device_count": torch.cuda.device_count()}
    _say("[dist] " + json.dumps(probe))
    out = {"probe": probe}
    scene, match, kw = _ba_scene(DIST_W, DIST_K), _match_inputs(), _ba_kwargs(cfg)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dry = None
    try:
        dev = init_distributed(f"localhost:{port}", num_processes=1, process_id=0)
        try:
            mesh = make_mesh(1)
            one = _world_of_one_solvers(mesh, dev, scene, match, kw)
            t_dry = time.perf_counter()
            dry = subprocess.Popen(
                [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                              "port_dryrun_multirank.py"),
                 "--nproc", str(DIST_RANKS), "--device", "cuda", "--backend", "gloo",
                 "--timeout", str(DIST_RANK_TIMEOUT_S)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
            one.update(_world_of_one_streams(cfg, seq, run_max, mesh, dev))
        finally:
            dist.destroy_process_group()
        out["world_one_nccl"] = one
        out["streams_mesh_launches"] = one["streams_layered_launches"]
        _say("[dist] world of one, nccl: " + json.dumps(one))
        two = _gloo_ranks_check(scene, match, kw)
        dry_out, _ = dry.communicate(timeout=DIST_RANK_TIMEOUT_S + 30)
    finally:
        if dry is not None and dry.poll() is None:     # its ranks are in its session
            os.killpg(dry.pid, signal.SIGKILL)
            dry.wait()
    if dry.returncode or f"dryrun_multirank({DIST_RANKS}): OK" not in dry_out:
        raise AssertionError(f"[dist] tools/port_dryrun_multirank.py: rc {dry.returncode}\n"
                             f"{dry_out[-4000:]}")
    two["dryrun_multirank"] = "OK"
    two["dryrun_seconds"] = time.perf_counter() - t_dry
    out["two_ranks_gloo"] = two
    out["seconds"] = time.perf_counter() - t_phase
    two["phase_seconds"] = out["seconds"]
    _say(f"[dist] {DIST_RANKS} gloo ranks on one card (a check, no speed figure): " + json.dumps(two))
    return out


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
    thr_cfg = load_config(os.path.join(root, THR_CONFIG))
    turn_cfg = load_config(os.path.join(root, TURN_CONFIG), overrides={"seed": TURN_SEED})
    for c in (ref_cfg, thr_cfg, turn_cfg):
        if (c.image_height, c.image_width) != (cfg.image_height, cfg.image_width):
            raise AssertionError("the main paths share their frames, so their image size")
    # the configurations whose KLT calls the paths below make: the main and mode paths
    # share the default's (BA and the candidate method change no KLT call), the stress
    # scenes run it at STRESS_SMALL and the layout replays at their datasets' sizes
    sized = [load_config(overrides={"image_width": W, "image_height": H})
             for (W, H) in (STRESS_SMALL, *REPLAY_LAYOUT_SIZES.values())]
    row = kernel_phase(cfg, ref_cfg, [cfg, thr_cfg, turn_cfg, *sized])

    from lcvo_tpu_torch.data.synthetic import SyntheticSequence

    # the BA paths run BA_FRAMES frames, then one more chunk under the sync detector
    n_render = BA_FRAMES + CHUNK
    seq = SyntheticSequence(n_frames=n_render, width=cfg.image_width, height=cfg.image_height)
    t0 = time.perf_counter()
    frames = render(seq, n_render)
    _say(f"[main] rendered {len(frames)} frames {frames.shape[1:]} uint8 in "
         f"{time.perf_counter() - t0:.1f} s")
    # default path: every frame pair goes through the tracker (6 launches), bootstrap
    # hops included. Reference path: 6 KLT + 6 SIFT launches per step, and the SIFT
    # bootstrap describes its two endpoint frames (12 launches, no KLT hops).
    main, _ = main_path_phase("main", cfg, seq, frames, ATE_BOUND_M, 6 * (N_FRAMES - 1),
                              args.profile)
    n_steps = N_FRAMES - 1 - ref_cfg.bootstrap.frame_gap
    ref, _ = main_path_phase("main:reference", ref_cfg, seq, frames, REF_ATE_BOUND_M,
                             12 * n_steps + 12, args.profile)
    # BA paths: 6 KLT + 6 SIFT launches per step; the KLT bootstrap tracks frame_gap
    # hops (6 launches each) and describes its last frame for the sift-sift table (6)
    by_path = {"default": main["launches"]["extract_blocks"],
               "reference": ref["launches"]["extract_blocks"]}
    floors = {"default": main["min_launches"], "reference": ref["min_launches"]}
    poses = {}
    for tag, c, bound in (("throughput", thr_cfg, THR_ATE_BOUND_M),
                          ("turn_robust", turn_cfg, TURN_ATE_BOUND_M)):
        gap = c.bootstrap.frame_gap
        out, poses[tag] = main_path_phase(f"main:{tag}", c, seq, frames, bound,
                                          12 * (BA_FRAMES - 1 - gap) + 6 * gap + 6,
                                          args.profile, n_frames=BA_FRAMES)
        by_path[tag] = out["launches"]["extract_blocks"]
        floors[tag] = out["min_launches"]
        rate_without_ba(f"main:{tag}:ba_off", c, seq, frames, BA_FRAMES)
    checkpoint_phase("checkpoint:turn_robust", turn_cfg, seq, frames, BA_FRAMES,
                     poses["turn_robust"])
    for mode, n_frames, jax_ate in MODES:
        c = load_config(overrides=mode_overrides(mode))
        out, _ = main_path_phase(f"main:{mode}", c, seq, frames, 8 * jax_ate,
                                 _launch_floor(c, n_frames - 1 - c.bootstrap.frame_gap, 1),
                                 args.profile, n_frames=n_frames)
        path = mode.replace("-", "_").replace("+", "_")
        by_path[path], floors[path] = out["launches"]["extract_blocks"], out["min_launches"]
    counted = {**recovery_phase(cfg, turn_cfg, seq, frames), **stress_phase(cfg),
               "longhorizon": longhorizon_phase(cfg)}
    render_phase(smi)
    replay, by_path["replay_kitti_turn"] = replay_phase(root, smi)
    floors["replay_kitti_turn"] = replay["launches_formula"]
    for dataset, jax_ate in REPLAY_LAYOUT_JAX_CPU_ATE_M.items():
        counted[f"replay_{dataset}"] = replay_layout_phase(root, dataset, jax_ate)
    for path, (n, floor) in counted.items():
        by_path[path], floors[path] = n, floor
    kernels.reset_launches()
    if min(by_path.values()) < 1:
        raise AssertionError(f"a main path never launched extract_blocks: {by_path}")
    row["launches"] = sum(by_path.values())
    row["launches_by_path"] = by_path
    # the floors are worked out from the configurations and the re-bootstrap counts, not
    # measured, so they have a line of their own, outside the kernel table
    _say("[launch-floors] " + json.dumps(floors))
    under = {p: (by_path[p], f) for p, f in floors.items() if by_path[p] < f}
    if under:
        raise AssertionError(f"extract_blocks launched under its floor on {under}")
    lrow = layered_kernel_phase(turn_cfg)
    st, run_max = streams_phase(turn_cfg, seq, frames, args.profile)
    dst = dist_phase(turn_cfg, seq, run_max)
    lrow["launches"] = st["launches"] + dst["streams_mesh_launches"]
    lrow["launches_by_path"] = {f"streams_S{S}": r["launches"] for S, r in st["by_streams"].items()}
    lrow["launches_by_path"][f"streams_mesh_S{max(STREAMS)}"] = dst["streams_mesh_launches"]
    lrow["launches_per_batched_step"] = st["launches_per_batched_step"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path",
            "sift_ms", "sift_plain_ms", "sift_bound_ms", "sift_ypad_ms")
    lkeys = keys[:12] + ("launches_per_batched_step", "ms_by_streams", "two_d_ms_one_stream")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}, {k: lrow[k] for k in lkeys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

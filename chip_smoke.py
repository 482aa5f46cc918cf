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
   Then ``[svd]``: the SVD route (``ops/svd.py``, ``csrc/svd.cu``: cuSOLVER's
   ``gesvdjBatched`` called as ``torch.linalg.svd`` calls it, its convergence codes left on
   the device) against ``torch.linalg.svd`` at the four call sites' shapes (512 x 8 x 9
   thin, 512 x 3 x 3, one 3 x 3, 51 x 5 x 9 full): singular values within 1e-5 relative,
   reconstruction within 1e-5, the vectors the callers take within 1e-4 up to sign (the
   five-point null space as its projector), and whether every bit agrees; each replayed
   in a CUDA graph beside ``torch.linalg.svd``'s eager time and the bound; on the
   bootstrap's own points (eight-point and five-point) ``essential_ransac``'s essential
   matrix, inliers and count equal with either. Then the failure semantics, JAX's: a
   matrix whose SVD fails is NaN and nothing raises. By sweep cap, the matrices of a
   batch cuSOLVER flags, the record's count of them, and exactly those NaN; a NaN and an
   inf matrix NaN too; a bootstrap under ``SVD_FORCED_SWEEPS`` returns (0 inliers, a NaN
   pose: a NaN hypothesis wins the MSAC argmin, as in the JAX package), each SVD call's
   NaN matrices those flagged or not finite, graphed = eager bit for bit (the graphs
   captured under the cap); ``run`` with its first bootstrap capped extends the window.
   Then ``[kernel] p3p``: the P3P kernel (``csrc/p3p.cu``) against its plain version
   (``ops/pnp.py::p3p_grunert_plain``) at 512 and 8 x 512 minimal sets: sets drawn from
   a noisy scene, sets whose quartic has a double or a near-double root, and the sets
   that the default and ``turn_robust`` paths draw in an eager run of their first
   ``P3P_RECORD_FRAMES`` frames (each call alone, and all a path's calls as one batch).
   Prints the share of bit-equal R, t and ok, the largest gaps where both keep a root,
   and the ok mismatches, and raises unless every call of 512 sets is bit-equal with no
   ok mismatch: the scene, double and near-double batches, each 512-set slice of the
   8 x 512 stack and each call the paths made. A stack in one call must give the bits of
   its calls one by one; its comparison with the plain version called on the whole stack
   is only printed (the plain version's 5 x 5 coefficient product runs there as another
   cuBLAS kernel, whose sums round otherwise). The 8 x 512 stack through
   ``torch.func.vmap`` equal to the direct call, exactly; each recorded ``pnp_ransac``
   call with the kernel against the same call with the plain version (R and t within
   ``P3P_RANSAC_TOL``, the same inlier count); kernel and plain times replayed in a CUDA
   graph beside the kernel's bound. The main paths below hold their ``p3p`` launches to
   their PnP calls: one a ``process_frame`` replay, one a batched streams step.
   Then ``[kernel] klt_iterate``: the KLT level kernel (``csrc/klt_iterate.cu``) against
   its plain tail (``ops/klt.py::_iterate_level_plain``) on every level that the default
   (window 15), reference (window 21) and ``turn_robust`` paths make in an eager run of
   their first ``KLT_RECORD_FRAMES`` frames, with f32 blocks and an f32 or a bf16 loop and
   with bf16 blocks: the largest and median |delta d|, the status agreement, the
   residual gap and the bit-equal shares; raises unless every call gives the plain
   tail's bits. A call twice and a stack of 3 through ``torch.func.vmap`` give the same
   bits; one launch and the plain tail timed, replayed in a CUDA graph, beside the bound.
   The main, mode, recovery, stress and longhorizon paths hold their ``klt_iterate``
   launches to their KLT levels (the tracked levels of each ``process_frame`` replay, all
   levels of each ``track_pair`` replay), the streams paths to the tracked levels of
   each batched step.
4. Main paths, on the same 42 synthetic corridor frames at 1240x376, each with the
   launch counters set to 0 just before and read just after, each through
   ``VisualOdometry(cfg, K, device="cuda").run_chunked(frames, chunk=16)`` (bootstrap,
   two chunks of 16, three tail frames):
   a. the default configuration (shi-mask, KLT bootstrap, eight-point): ATE < 0.0113 m,
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
   afterwards, eager (host stage spans, device busy share, top kernels), then one
   replayed chunk (device busy, idle share, ops per frame); summaries to DIR. The device
   time of a replay's stages is the benchmark's reading (``vo_bench``, ``--trace 1``).
   Every path of this script runs as ``VisualOdometry`` runs on the card: its per-frame
   and keyframe steps captured into CUDA graphs at their first call and replayed
   (``lcvo_tpu_torch/utils/graphs.py``), the launch counters counting each replay's
   launches. ``[graphs:<path>]`` (after the four paths): each path once more with every
   step eager (``disable_graphs()``) from the same seed, held equal to the graphed run bit
   for bit (poses, pose_ok, inliers, launches, every tensor of the final state and
   window), with frames/s and ``step`` latency graphed and eager, graphs captured, warm-up
   and capture plus instantiation seconds, nodes, pool bytes and the host time of one
   replay; ``[graphs:run]`` the same for the default configuration through ``run``; then a
   replayed chunk of the default and of ``turn_robust`` (with keyframe replays) under the
   sync detector. ``[bootstrap:<path>]`` (default, reference, throughput, turn_robust,
   sift-mask): the bootstrap's pieces (pyramid, ``detect0``, ``track_pair`` per hop,
   ``two_view_init``; the SIFT features and ``mutual_match`` where the path takes them)
   replayed as graphs against ``disable_graphs()`` from the same seed: the state after
   the bootstrap, R, t, the inlier count and the launches equal bit for bit, no host sync
   inside the replays, the first and the warm bootstrap's wall seconds each way, the
   replayed pieces alone (the rest is the eager assembly), the graphs, their capture and
   instantiation seconds, nodes and pool bytes, 4 SVD launches per eight-point bootstrap
   and 3 per five-point one. The streams, recovery and checkpoint phases below also run graphed:
   each S of ``[streams]`` and each recovery run is held to its eager twin (streams:
   equal exactly; recovery: the same re-bootstraps and anchors).
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
   layered launches counted (``launches_by_path.streams_mesh_S8``). The sharded BA, the
   sharded matcher and the mesh ``make_multistream_step`` (its ``agg`` summed inside its
   graph) run as CUDA graphs with their NCCL collectives: each held to its run under
   ``disable_graphs()`` bit for bit, reported replayed, with no host sync in a replay,
   its graph's nodes, capture and instantiation seconds, ms per call graphed and eager
   and host ms per replay. Then ``DIST_RANKS``
   gloo ranks on the one card, each a process of its own with CUDA tensors: the sharded BA
   within the ``ba_solve`` line, the matcher exact, both eager (not replayed: gloo's
   collectives cannot be captured), and ``tools/port_dryrun_multirank.py
   --device cuda --backend gloo``. NCCL holds one rank per card, so the two ranks check
   the cross-rank arithmetic and give no speed figure.
12. Candidate modes (``[main:sift-mask]``, ``[main:harris-mask]``, ``[main:shi-mask+ba]``):
   ``bench.py``'s three modes that no path above runs, through ``main_path_phase`` on the
   same frames (42, 42 and 74), each under 3x the JAX package's CPU figure, with the
   launch floor of its candidate stage (SIFT in sift-mask) and, for shi-mask+ba, the BA
   checks. They run right after the checkpoint phase.
13. Recovery (``[recovery]``, ``[recovery:run]``, ``[recovery:ba]``, ``[recovery:tracks]``):
   the first 64 corridor frames with seeded noise on frames 28-30, through ``run_chunked``
   and ``run`` (default configuration) and ``configs/turn_robust.yaml`` (chunked): one
   pose per frame from ``frame_gap`` on, at least one re-bootstrap, health 0 and the last
   8 poses good at the end, no more re-bootstraps than the JAX package on the CPU on the
   same frames and an ATE under the JAX file's 1.0 m where that package meets it, else
   ``RECOVERY_ATE_FACTOR`` times its figure, the median step after the recovery within ``SCALE_SEAM`` of the one before,
   launches at or above the floor that counts the re-bootstrap's KLT chain, no host sync
   in a chunk of the corrupted frames; with BA, every bootstrap leaves an empty window and
   the mirror at 0, and keyframes pushed = refines run = the cadence over each segment,
   none above its starting cost; each bootstrap's wall seconds graphed and eager, and no
   re-bootstrap captures a graph the first bootstrap did not. Then a track table cut to 8 refills past 24 by
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
17. Lock-step (``[lockstep:<path>]``, on every path above: default, reference,
   throughput, turn_robust, the three modes, the three recovery runs, the five stress
   runs, the three CLI replays and streams at S = 1): the port draws the JAX package's
   random stream, so each run is held to the JAX package's run of the same frames,
   configuration and seed on the CPU, read from ``lcvo_tpu_torch/data/jax_lockstep.json``
   (``tools/port_jax_reference.py``; no JAX here): per-entry camera-center distance
   unaligned and after Sim(3), the shares of equal pose_ok and PnP inlier counts, the
   first entry where they part, both ATEs and whether the frames' bytes are the
   reference's (the replays' files are written on the card, the reference's on the
   CPU). A missing file or path fails; a bound of ``LOCKSTEP_BOUNDS`` missed fails the
   script once every phase has run.
18. Windows from the JAX package's states (``[segments:<path>]``: the 400-frame replay's
   turn at three chunk boundaries after its bootstrap, the full-width sharp turn and arena
   corner with one window before the loss of track and one across it, shi-mask+ba once):
   one host loop on the card resumes each window's state from
   ``lcvo_tpu_torch/data/jax_segments/<path>/`` (``tools/port_jax_reference.py
   --segments``; the image leaves rebuilt from the frame before) and runs the window with
   the JAX package's draws (``lcvo_tpu_torch/utils/segments.py``), on the frames that the
   path's own phase ran. Per window: the
   unaligned camera-center distance to the JAX package's continuation (largest, at the
   end, at the first entry), pose_ok equal, the first frame where they part. pose_ok is
   held equal on every window that keeps track, the distance under ``SEGMENT_BOUNDS``;
   the replay's second window run again in a fresh host loop gives the same entries bit
   for bit. A missing state file fails; a bound missed fails the script once every phase
   has run. The launches count under ``segments_<path>``.
19. Output: ``[launch-floors]``, each path's lower limit on its launches (worked out
   from its configuration and re-bootstrap count, each path checked against it); the
   kernel table as one JSON line (the 2-D entry, whose ``launches_by_path`` holds every
   single-stream path above, the layered entry, and the SVD route with its launches on
   the main and mode paths, and the P3P kernel with its launches by phase), the
   ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

The script imports neither JAX nor ``lcvo_tpu``.
"""

from __future__ import annotations

import contextlib
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
# H100 SXM float32 outside the tensor cores (NVIDIA data sheet), for the operations bound
F32_FLOPS_PER_S = 67e12
N_FRAMES = 42            # 7 bootstrap + 2 chunks of 16 + 3 tail frames
N_LATENCY = 6            # extra frames for the per-frame step latency
CHUNK = 16
# ATE bounds of the main and mode paths: LOCKSTEP_ATE_FACTOR times the JAX package's
# figure on the CPU on the same frames, configuration and seed (its run in LOCKSTEP_FILE;
# tools/port_parity_cpu.py --width 1240 --height 376 [--config F] [--frames 74] --seed S
# prints it too). While the port drew its own random stream the bounds were 8x;
# drawing the JAX package's samples, the H100 read 0.62-2.19x the JAX figure on these
# seven paths over two runs (harris-mask the highest: 0.00613 m against 0.0027965), so 3x.
LOCKSTEP_ATE_FACTOR = 3.0
ATE_BOUND_M = LOCKSTEP_ATE_FACTOR * 0.0037638     # the default path, seed 0, 42 frames
REF_CONFIG = os.path.join("configs", "reference.yaml")
REF_ATE_BOUND_M = LOCKSTEP_ATE_FACTOR * 0.012625  # configs/reference.yaml, seed 0
# The two BA paths, on BA_FRAMES frames: the JAX package reads 0.013236 m at seed 0
# (throughput) and 0.018652 m at seed 1 (turn_robust).
# turn_robust runs at cfg.seed 1. At seed 0 the two-view bootstrap on the card, with this
# file's KLT settings, draws a weak init (261 essential-matrix inliers against 688-705 at
# seeds 1-3) and the ATE is 1.03 m with BA and 1.73 m without: one of the wrong-bootstrap
# draws that both packages show on about 1 seed in 20 (PERF.md), not a matter of BA.
BA_FRAMES = 74           # 7 bootstrap + 4 chunks of 16 + 3 tail frames
THR_CONFIG = os.path.join("configs", "throughput.yaml")
THR_ATE_BOUND_M = LOCKSTEP_ATE_FACTOR * 0.013236
TURN_CONFIG = os.path.join("configs", "turn_robust.yaml")
TURN_SEED = 1
TURN_ATE_BOUND_M = LOCKSTEP_ATE_FACTOR * 0.018652
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
# [kernel] p3p: the driven paths' own minimal sets come from an eager run of this many
# frames (bootstrap and 19 steps); pnp_ransac with the kernel is held to the same call
# with the plain P3P within P3P_RANSAC_TOL on R and t, with the same inlier count.
P3P_RECORD_FRAMES = 26
P3P_RANSAC_TOL = 1e-4
# operations of one minimal set, counted from csrc/p3p.cu: the loop's 40 iterations x 4
# roots x 76 (Horner 26, differences 16, three complex products 18, Smith's division 10,
# the guard 4, the update 2), the setup ~200 and the back-substitution with the two
# triads and R, t ~700
P3P_FLOPS_PER_SET = 40 * 4 * 76 + 200 + 700
# bytes a set reads (Pw, f) and writes (R, t, ok)
P3P_BYTES_PER_SET = 2 * 9 * 4 + 4 * (9 + 3) * 4 + 4
# [kernel] klt_iterate: the driven paths' own KLT levels come from an eager run of this
# many frames (bootstrap and 5 steps); on each, at each storage dtype, the kernel is held
# to the plain tail: the track's status (det_ok, not saturated, residual under the
# path's max_residual) the same on at least KLT_STATUS_MIN of the tracks, the median
# |d_kernel - d_plain| (px of the level) at most KLT_MEDIAN_DD, and every bit of d,
# det_ok, sat and residual equal.
KLT_RECORD_FRAMES = 12
KLT_STATUS_MIN = 0.995
KLT_MEDIAN_DD = 1e-4


def klt_flops_per_track(w: int, iters: int) -> int:
    """Operations of one track of a ``klt_iterate`` call, counted from csrc/klt_iterate.cu:
    the (w+2)^2 template samples (6 each), the gradients and three Hessian products and
    sums (8 a term), and per iteration and the final sample 6 for the sample, 1 for the
    error and 4 for the two products and sums a term."""
    return 6 * (w + 2) ** 2 + 8 * w * w + (iters + 1) * 11 * w * w


# The three candidate modes of bench.py that no earlier phase runs, as bench.py builds
# them (the VOConfig defaults with find_new_candidates_method set; "+ba" turns window BA
# on at its defaults): sift-mask and harris-mask on N_FRAMES frames, shi-mask+ba on
# BA_FRAMES. ATE bounds: LOCKSTEP_ATE_FACTOR times the JAX package's CPU figure on the
# same frames at seed 0 (tools/port_parity_cpu.py --width 1240 --height 376 --packages
# jax --mode M [--ba] --frames F).
MODES = (("sift-mask", N_FRAMES, 0.0032837), ("harris-mask", N_FRAMES, 0.0027965),
         ("shi-mask+ba", BA_FRAMES, 0.0117692))
# The recovery and stress paths are held to what the JAX package does on the same
# frames on the CPU: no more re-bootstraps than it needs, and an ATE under the JAX test
# file's bound where the JAX package meets that bound, else under JAX_ATE_FACTOR times
# its figure.
JAX_ATE_FACTOR = 1.5


# The recovery runs retrace the JAX package's: the H100 read 1.195793 / 1.194216 m
# against its 1.195753 / 1.194775 m, so where the JAX figure is above the file's
# bound the recovery bound is this factor of it, not JAX_ATE_FACTOR.
RECOVERY_ATE_FACTOR = 1.2


def jax_held_bound(jax_ate: float, file_bound: float, factor: float = JAX_ATE_FACTOR) -> float:
    return file_bound if jax_ate < file_bound else factor * jax_ate


# Lock-step: the port draws the JAX package's random stream, so every path is held to
# the JAX package's own run of the same frames, configuration and seed on the CPU
# (LOCKSTEP_FILE, written by tools/port_jax_reference.py; a missing file or path fails
# the phase). Each [lockstep:<path>] line gives the per-entry camera-center distance
# unaligned and after Sim(3), the shares of equal pose_ok and inlier counts, the first
# entry where they part, both ATEs and whether the frames' bytes are the reference's.
# Bounds per path: (largest unaligned camera-center distance in m, least share of
# entries with equal pose_ok), about twice the largest the H100 read (two runs of this
# file, before and after the normalized points took XLA's rounding, see
# core/geometry.py::backproject: the swaps move but do not go) and the port on the CPU
# at full width (tools/port_parity_cpu.py: 0.0063 / 0.0094 / 0.0277 / 0.0212 m on the
# four main paths); pose_ok equal on every entry where the card showed it. The
# full-width sharp turn and arena corner lose track in both packages (the JAX package
# re-bootstraps 3 and 2 times there): the runs part at the first re-bootstrap and stay
# metres apart (3.6 and 6.4 m), so only a loose distance and the pose_ok share hold
# them. The replays' files are written on the card, the reference's on the CPU (a grey
# level on a few pixels in a million), which the distance also carries.
LOCKSTEP_FILE = os.path.join("lcvo_tpu_torch", "data", "jax_lockstep.json")
LOCKSTEP_BOUNDS = {
    "default": (0.02, 1.0), "reference": (0.02, 1.0), "throughput": (0.06, 1.0),
    "turn_robust": (0.08, 1.0), "sift-mask": (0.015, 1.0), "harris-mask": (0.04, 1.0),
    "shi-mask+ba": (0.17, 1.0), "recovery": (0.035, 1.0), "recovery:run": (0.015, 1.0),
    "recovery:ba": (0.025, 1.0), "stress:sharp_turn_416x160": (0.6, 0.95),
    "stress:sharp_turn": (7.5, 0.8), "stress:textureless_occluder": (0.45, 1.0),
    "stress:arena_corner_416x160": (0.2, 1.0), "stress:arena_corner": (13.0, 0.85),
    "streams:S1": (0.12, 1.0), "replay:kitti_turn": (1.5, 1.0), "replay:malaga": (0.09, 1.0),
    "replay:parking": (0.33, 1.0),
}
_lockstep_ref: dict = {}
_lockstep_faults: list = []

# [segments:<path>]: windows of four paths, each started from the JAX package's own state
# at its start, so no divergence carries into a window: the states (stripped of their
# image leaves, which the port rebuilds from the frame before; host lists cut) and the
# JAX package's continuation of each window in lcvo_tpu_torch/data/jax_segments/<path>/
# (tools/port_jax_reference.py --segments; no JAX here), resumed and run by
# lcvo_tpu_torch/utils/segments.py on the frames, configuration and K of the phase that
# ran the path (kept in _segment_inputs). One host loop resumes window after window;
# one window again in a fresh loop must give the same entries bit for bit. Bounds per
# path: (largest unaligned camera-center distance in a window that keeps track, in one
# that crosses a loss of track), about twice the larger of the H100's reading and the
# port's on the CPU (window by window: 0.0357 / 0.0280 / 0.1304 m and 0.090 / 0.062 /
# 0.085 m on the replay, whose whole run reads 0.735 m; sharp turn 0.0045 / 0.0167 and
# 0.0040 / 0.0286 m, whole 3.6 m; arena corner 0.0042 / 1.764 and 0.0006 / 2.305 m,
# whole 6.4 m; shi-mask+ba 0.0082 and 0.029 m, whole 0.0865 m); pose_ok is held equal on
# every entry of a window that keeps track.
SEGMENT_BOUNDS = {
    "replay:kitti_turn": (0.26, None), "stress:sharp_turn": (0.01, 0.06),
    "stress:arena_corner": (0.01, 4.6), "shi-mask+ba": (0.06, None),
}
SEGMENT_FRESH = "replay:kitti_turn"       # the path whose second window runs again fresh
_segment_faults: list = []
_segment_inputs: dict = {}                # path: (configuration, K, uint8 frames)


def _keep_segment_inputs(path: str, cfg, K, frames) -> None:
    """What a path's own phase ran, for its ``[segments:<path>]`` windows."""
    if path in SEGMENT_BOUNDS:
        _segment_inputs[path] = (cfg, K, frames)


def frames_sha256(frames) -> str:
    """tools/port_jax_reference.py's hash of a path's uint8 frames."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(frames, dtype=np.uint8).tobytes()).hexdigest()


def lockstep_check(path: str, centers, pose_ok, n_inliers, ate: float, frames_sha: str) -> dict:
    """``[lockstep:<path>]``: this run against the JAX package's run of the path in
    LOCKSTEP_FILE. A missing file or entry raises now; a bound missed is kept and
    raised when every phase has run."""
    from lcvo_tpu_torch.metrics import lockstep

    if not _lockstep_ref:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), LOCKSTEP_FILE)) as fh:
            _lockstep_ref.update(json.load(fh)["paths"])
    ref = _lockstep_ref[path]
    cmp = lockstep(centers, pose_ok, n_inliers, ref["centers"], ref["pose_ok"], ref["n_inliers"])
    max_d, min_ok = LOCKSTEP_BOUNDS[path]
    out = {**cmp, "ate_m": ate, "jax_cpu_ate_m": ref["ate_m"],
           "frames_equal_reference": frames_sha == ref["frames_sha256"],
           "bound_distance_m": max_d, "bound_pose_ok_equal_share": min_ok}
    _say(f"[lockstep:{path}] " + json.dumps(out))
    if not (cmp["entries"] == cmp["reference_entries"] and cmp["distance_m_max"] <= max_d
            and cmp["pose_ok_equal_share"] >= min_ok):
        _lockstep_faults.append(f"{path}: {out}")
    return out


# The recovery path: the first RECOVERY_FRAMES frames of the corridor with frames 28-30
# replaced by seeded uniform noise (data.synthetic.noise_burst), inside the second chunk
# of 16. JAX figures: tools/port_parity_cpu.py --width 1240 --height 376 --frames 64
# --burst 28 31 --packages jax [--per-frame] [--config configs/turn_robust.yaml --seed 1]
# as (ATE m, re-bootstraps); tests/test_fault_injection.py bounds both loops at 1.0 m.
# The chunked runs hold the pose from the burst to the end of its chunk and through the
# re-bootstrap (15 entries), hence their larger figure, above that bound in both packages.
# [svd]: the four call sites of the two-view bootstrap at the shapes it gives them
# (ops/epipolar.py: 512 hypotheses' 8 x 9 systems thin, their 3 x 3 projections, the
# one 3 x 3 decomposition; ops/five_point.py: 51 samples' 5 x 9 systems, full), and
# the route's limits against torch.linalg.svd on the card
SVD_SHAPES = (("eight_point", (512, 8, 9), False), ("project_to_essential", (512, 3, 3), True),
              ("decompose_essential", (3, 3), True), ("five_point", (51, 5, 9), True))
SVD_S_REL = 1e-5          # singular values, relative
SVD_RECON_REL = 1e-5      # |U S Vh - A| / |A|, per matrix
SVD_VEC = 1e-4            # the vectors the callers take, up to sign (five-point: the
                          # projector onto its 4-dim null space, whose basis is not unique)
# SVD launches of one bootstrap: the eight-point fit, the projection and the two
# decompositions (recover_pose in essential_ransac and in two_view_init); five-point:
# its null space and the two decompositions
SVD_PER_BOOTSTRAP = {"eight_point": 4, "five_point": 3}
# a sweep cap under which the bootstrap's SVDs do not converge: on an H100 with
# torch 2.11.0+cu128, cuSOLVER's batched routine flagged none of a random eight-point
# batch at caps 1-4, 351 of 512 at 5 and 161 at 6 ([svd]'s own count, printed each run)
SVD_FORCED_SWEEPS = 5
SVD_RUN_FRAMES = 16       # run() from a bootstrap under SVD_FORCED_SWEEPS
BOOT_REPS = 3             # warm bootstraps timed per path in [bootstrap:*]
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


def _p3p_sets(kind: str, n: int, rng):
    """``n`` minimal sets of ``kind`` (``data/minimal_sets.py``) on the card."""
    import torch

    from lcvo_tpu_torch.data import minimal_sets

    return tuple(torch.from_numpy(a).cuda() for a in minimal_sets.p3p_sets(kind, n, rng))


def _p3p_compare(got, want) -> dict:
    """The kernel's (R, t, ok) against the plain version's: shares of bit-equal values and
    of sets equal in every bit, ok mismatches, the largest gaps where both keep a root."""
    (R, t, ok), (Rp, tp, okp) = got, want

    def same(a, b):
        return (a == b) | (a.isnan() & b.isnan())

    both = ok & okp
    sets = same(R, Rp).flatten(-3).all(-1) & same(t, tp).flatten(-2).all(-1) & (ok == okp).all(-1)
    return {"sets": int(sets.numel()), "sets_bits_equal": float(sets.float().mean()),
            "R_bits_equal": float(same(R, Rp).float().mean()),
            "t_bits_equal": float(same(t, tp).float().mean()),
            "ok_mismatches": int((ok != okp).sum()), "ok_kernel": int(ok.sum()),
            "R_gap_max": float((R - Rp).abs()[both].max()) if both.any() else 0.0,
            "t_gap_max": float((t - tp).abs()[both].max()) if both.any() else 0.0}


@contextlib.contextmanager
def _plain_p3p():
    """``pnp_ransac`` with the plain P3P in place of the kernel."""
    from lcvo_tpu_torch.ops import pnp

    kernel = pnp.p3p_grunert
    pnp.p3p_grunert = pnp.p3p_grunert_plain
    try:
        yield
    finally:
        pnp.p3p_grunert = kernel


def _recorded_pnp(cfg, seq, frames, n_frames: int) -> tuple[list, list]:
    """Every ``pnp_ransac`` call (its arguments, cloned) and every P3P input of an eager
    run of ``cfg`` over the first ``n_frames`` frames."""
    import torch
    from torch.utils._pytree import tree_map

    from lcvo_tpu_torch.ops import pnp
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    calls, sets = [], []
    ransac, p3p = pnp.pnp_ransac, pnp.p3p_grunert

    def rec_ransac(*a, **kw):
        calls.append(tree_map(clone, (a, kw)))
        return ransac(*a, **kw)

    def rec_p3p(Pw, f):
        sets.append((Pw.clone(), f.clone()))
        return p3p(Pw, f)

    pnp.pnp_ransac, pnp.p3p_grunert = rec_ransac, rec_p3p
    try:
        with disable_graphs():
            VisualOdometry(cfg, seq.K, device="cuda").run_chunked(frames[:n_frames], chunk=CHUNK)
    finally:
        pnp.pnp_ransac, pnp.p3p_grunert = ransac, p3p
    return calls, sets


def p3p_phase(cfg, turn_cfg, seq, frames) -> dict:
    """``[kernel] p3p``: the P3P kernel against its plain version on the card (see the
    module docstring). Returns the kernel table's row."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.data import minimal_sets
    from lcvo_tpu_torch.ops import pnp

    rng = np.random.default_rng(17)
    batches = {kind: _p3p_sets(kind, 512, rng) for kind in minimal_sets.KINDS}
    scene8 = _p3p_sets("scene", 8 * 512, rng)
    batches["scene_8x512"] = tuple(a.reshape(8, 512, 3, 3) for a in scene8)
    recorded = {}
    for tag, c in (("default", cfg), ("turn_robust", turn_cfg)):
        recorded[tag] = _recorded_pnp(c, seq, frames, P3P_RECORD_FRAMES)
        sets = recorded[tag][1]
        batches[f"{tag}_draws"] = (torch.stack([p for p, _ in sets]), torch.stack([q for _, q in sets]))
    torch.cuda.synchronize()
    kernels.reset_launches()
    launched = 0
    out, got = {}, {}
    for name, (Pw, f) in batches.items():
        got[name] = pnp.p3p_grunert(Pw, f)
        launched += 1
        out[name] = _p3p_compare(got[name], pnp.p3p_grunert_plain(Pw, f))
        if Pw.dim() > 3:      # a stack of 512-set calls: each call alone too, at its own shape
            each = [pnp.p3p_grunert(Pw[i], f[i]) for i in range(Pw.shape[0])]
            launched += Pw.shape[0]
            out[name]["one_call_each"] = _p3p_compare(
                tuple(torch.stack([e[k] for e in each]) for k in range(3)),
                tuple(torch.stack(x) for x in zip(*(pnp.p3p_grunert_plain(Pw[i], f[i])
                                                    for i in range(Pw.shape[0])))))
            out[name]["batch_equals_one_call_each"] = all(
                torch.equal(got[name][k], torch.stack([e[k] for e in each])) for k in range(3))
    vmapped = torch.func.vmap(pnp.p3p_grunert)(*batches["scene_8x512"])
    launched += 1
    vmap_ok = all(torch.equal(got["scene_8x512"][k], vmapped[k]) for k in range(3))
    ransac = {}
    for tag, (calls, _) in recorded.items():
        worst = {"R": 0.0, "t": 0.0, "n_inliers_differ": 0, "calls": len(calls)}
        for a, kw in calls:
            R, t, _, n = pnp.pnp_ransac(*a, **kw)
            launched += 1
            with _plain_p3p():
                Rp, tp, _, n_p = pnp.pnp_ransac(*a, **kw)
            worst["R"] = max(worst["R"], float((R - Rp).abs().max()))
            worst["t"] = max(worst["t"], float((t - tp).abs().max()))
            worst["n_inliers_differ"] += int(n != n_p)
        ransac[tag] = worst
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["p3p"]

    times = {}
    for name in ("scene", "scene_8x512"):
        Pw, f = batches[name]
        B = Pw.numel() // 9
        times[name] = {
            "sets": B,
            "kernel_ms": graph_ms(lambda: pnp.p3p_grunert(Pw, f)),
            "plain_ms": graph_ms(lambda: pnp.p3p_grunert_plain(Pw, f), inner=10, reps=7),
            "bound_ms": 1e3 * max(B * P3P_BYTES_PER_SET / HBM_BYTES_PER_S,
                                  B * P3P_FLOPS_PER_SET / F32_FLOPS_PER_S),
        }
    kernels.reset_launches()
    res = {"by_batch": out, "vmap_8x512_equals_direct": vmap_ok,
           "pnp_ransac_kernel_vs_plain": ransac, "launches": launches,
           "launches_expected": launched, "times": times}
    _say("[kernel] p3p " + json.dumps(res))
    # bit for bit at 512 sets a call, the shape every single-stream path calls it at; a
    # stack in one call is held to its calls one by one (the plain version's own sums
    # round otherwise at a stack's row count, so its stacked column is only printed)
    gated = {k: v for k, v in out.items() if k in minimal_sets.KINDS}
    gated.update({f"{k}.one_call_each": v["one_call_each"] for k, v in out.items()
                  if "one_call_each" in v})
    faults = [f"{k}: {v['sets_bits_equal']} of the sets bit-equal, {v['ok_mismatches']} ok "
              f"mismatches" for k, v in gated.items()
              if v["sets_bits_equal"] != 1.0 or v["ok_mismatches"]]
    faults += [f"pnp_ransac {tag}: {w}" for tag, w in ransac.items()
               if w["R"] > P3P_RANSAC_TOL or w["t"] > P3P_RANSAC_TOL or w["n_inliers_differ"]]
    if not vmap_ok:
        faults.append("the vmapped 8 x 512 call differs from the direct call")
    if launches != launched:
        faults.append(f"{launches} p3p launches for {launched} calls on CUDA tensors")
    if any(not v["batch_equals_one_call_each"] for v in out.values() if "one_call_each" in v):
        faults.append("a stack gives other bits in one call than call by call")
    if faults:
        raise AssertionError("[kernel] p3p: " + "; ".join(faults))
    t512 = times["scene"]
    return {"name": "p3p", "route": "cuda", "source": "lcvo_tpu_torch/csrc/p3p.cu",
            "replaces": "lcvo_tpu/ops/pnp.py:p3p_grunert (plain XLA, no Pallas kernel)",
            "max_abs_err": max(max(v["R_gap_max"], v["t_gap_max"]) for v in gated.values()),
            "ms": t512["kernel_ms"], "plain_ms": t512["plain_ms"], "bound_ms": t512["bound_ms"],
            "bound_by": "operations (the limit is the 40-iteration dependent chain)",
            "library_ms": None, "ms_8x512": times["scene_8x512"]["kernel_ms"],
            "plain_ms_8x512": times["scene_8x512"]["plain_ms"]}


def _hold_launches(tag: str, vo) -> None:
    """Raise unless the ``p3p`` launches since the counters were set to 0 are the PnP
    calls of ``vo``'s run (its ``process_frame`` replays: the step runs PnP once), and
    not 0, and the ``klt_iterate`` launches are its KLT levels: the tracked levels of
    every ``process_frame`` replay and all levels of every ``track_pair`` replay (a
    bootstrap hop)."""
    from lcvo_tpu_torch import kernels

    graphs = vo.graph_stats()["graphs"]
    n = kernels.LAUNCHES["p3p"]
    calls = sum(g["replays"] for g in graphs if g["name"] == "process_frame")
    if n != calls or not calls:
        raise AssertionError(f"[{tag}] the P3P kernel launched {n} times for {calls} PnP "
                             f"calls (process_frame replays)")
    klt = vo.cfg.klt
    levels = calls * (klt.track_levels or klt.levels) + klt.levels * sum(
        g["replays"] for g in graphs if g["name"] == "track_pair")
    if kernels.LAUNCHES["klt_iterate"] != levels:
        raise AssertionError(f"[{tag}] klt_iterate launched {kernels.LAUNCHES['klt_iterate']} "
                             f"times for {levels} KLT levels")


def _recorded_klt(cfg, seq, frames, n_frames: int) -> list:
    """Every ``klt_iterate`` call (its arguments, cloned) of an eager run of ``cfg`` over
    the first ``n_frames`` frames."""
    import torch

    from lcvo_tpu_torch.ops import klt
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    calls = []
    real = klt.klt_iterate

    def rec(*a):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real(*a)

    klt.klt_iterate = rec
    try:
        with disable_graphs():
            VisualOdometry(cfg, seq.K, device="cuda").run_chunked(frames[:n_frames], chunk=CHUNK)
    finally:
        klt.klt_iterate = real
    return calls


def _klt_compare(got, want, max_residual: float) -> dict:
    """The kernel's (d, det_ok, sat, residual) against the plain tail's: |delta d| where
    both are finite, the status agreement, the residual gap, the bit-equal shares."""
    (d, ok, sat, res), (dp, okp, satp, resp) = got, want

    def same(a, b):
        return (a == b) | (a.isnan() & b.isnan())

    fin = d.isfinite().all(-1) & dp.isfinite().all(-1)
    dd = (d - dp).abs().amax(-1)[fin]
    status, status_p = ok & ~sat & (res < max_residual), okp & ~satp & (resp < max_residual)
    rfin = res.isfinite() & resp.isfinite()
    return {"tracks": int(d.shape[0]), "dd_max": float(dd.max()) if dd.numel() else 0.0,
            "dd_median": float(dd.median()) if dd.numel() else 0.0,
            "status_agree": float((status == status_p).float().mean()),
            "det_ok_mismatches": int((ok != okp).sum()), "sat_mismatches": int((sat != satp).sum()),
            "residual_gap_max": float((res - resp).abs()[rfin].max()) if rfin.any() else 0.0,
            "d_bits_equal": float(same(d, dp).all(-1).float().mean()),
            "residual_bits_equal": float(same(res, resp).float().mean()),
            "nan_mismatches": int((d.isnan().any(-1) != dp.isnan().any(-1)).sum())}


def klt_phase(cfg, ref_cfg, turn_cfg, seq, frames) -> dict:
    """``[kernel] klt_iterate``: the KLT level kernel against its plain tail on the card,
    on every level the default (window 15), reference (window 21) and turn_robust paths
    made in an eager run of their first ``KLT_RECORD_FRAMES`` frames, with f32 blocks
    and an f32 and a bf16 loop, and with the blocks in bf16. Raises on a status
    agreement under ``KLT_STATUS_MIN``, a median |delta d| over ``KLT_MEDIAN_DD`` or any
    bit apart in any group. Returns the kernel table's row."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.ops import klt

    recorded = {tag: (c, _recorded_klt(c, seq, frames, KLT_RECORD_FRAMES))
                for tag, c in (("default", cfg), ("reference", ref_cfg),
                               ("turn_robust", turn_cfg))}
    torch.cuda.synchronize()
    kernels.reset_launches()
    launched = 0
    out, faults = {}, []
    for tag, (c, calls) in recorded.items():
        for blocks, idt in (("f32", torch.float32), ("f32", torch.bfloat16),
                            ("bf16", torch.bfloat16)):
            name = f"{tag}.blocks_{blocks}.iter_{str(idt).split('.')[-1]}"
            rows = []
            for a in calls:
                tb, to, nb, no, pts, d, w, iters, eps = a[:9]
                if blocks == "bf16":
                    tb, nb = tb.bfloat16(), nb.bfloat16()
                args = (tb, to, nb, no, pts, d, w, iters, eps, idt)
                got = klt.klt_iterate(*args)
                launched += 1
                rows.append(_klt_compare(got, klt._iterate_level_plain(*args),
                                         c.klt.max_residual))
            agg = {"calls": len(rows), "window": calls[0][6],
                   "dd_max": max(r["dd_max"] for r in rows),
                   "dd_median": statistics.median(r["dd_median"] for r in rows),
                   "status_agree_min": min(r["status_agree"] for r in rows),
                   "residual_gap_max": max(r["residual_gap_max"] for r in rows),
                   "d_bits_equal_min": min(r["d_bits_equal"] for r in rows),
                   "d_bits_equal_mean": statistics.mean(r["d_bits_equal"] for r in rows),
                   "residual_bits_equal_min": min(r["residual_bits_equal"] for r in rows),
                   "det_ok_mismatches": sum(r["det_ok_mismatches"] for r in rows),
                   "sat_mismatches": sum(r["sat_mismatches"] for r in rows),
                   "nan_mismatches": sum(r["nan_mismatches"] for r in rows)}
            out[name] = agg
            if agg["status_agree_min"] < KLT_STATUS_MIN or agg["dd_median"] > KLT_MEDIAN_DD:
                faults.append(f"{name}: status agreement {agg['status_agree_min']}, median "
                              f"|delta d| {agg['dd_median']} px")
            # the kernel sums in the order of PyTorch's reduce kernel at these shapes, so
            # it gives the plain tail's bits
            if (agg["d_bits_equal_min"] != 1.0 or agg["residual_bits_equal_min"] != 1.0
                    or agg["det_ok_mismatches"] or agg["sat_mismatches"]):
                faults.append(f"{name}: not the plain tail's bits ({agg})")
    # the same call twice, and through torch.func.vmap as a stack of 3, gives the same bits
    a = recorded["default"][1][-1]
    one = klt.klt_iterate(*a)
    again = klt.klt_iterate(*a)
    stacked = torch.func.vmap(lambda *t: klt.klt_iterate(*t, *a[6:]))(
        *(x[None].expand(3, *x.shape) for x in a[:6]))
    launched += 3
    repeat_ok = all(torch.equal(x, y) for x, y in zip(one, again))
    vmap_ok = all(torch.equal(x[None].expand_as(y), y) for x, y in zip(one, stacked))
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["klt_iterate"]

    times = {}
    for tag in ("default", "reference", "turn_robust"):
        c, calls = recorded[tag]
        # the step's call with the most tracks, iterations and the largest target block
        a = max(calls, key=lambda x: (x[0].shape[0], x[7], x[2].shape[1]))
        tb, nb, w, iters, N = a[0], a[2], a[6], a[7], a[0].shape[0]
        nbytes = (tb.numel() + nb.numel()) * tb.element_size() + N * (4 * 2 * 4 + 2 * 4 + 2 + 4)
        times[tag] = {"tracks": N, "window": w, "S_t": tb.shape[1], "S": nb.shape[1],
                      "iters": iters,
                      "kernel_ms": graph_ms(lambda: klt.klt_iterate(*a)),
                      "plain_ms": graph_ms(lambda: klt._iterate_level_plain(*a), inner=5, reps=7),
                      "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                            N * klt_flops_per_track(w, iters) / F32_FLOPS_PER_S)}
        # the same call with no iteration: the template, Hessian and final sample alone
        times[tag]["kernel_ms_no_iteration"] = graph_ms(
            lambda: klt.klt_iterate(*a[:7], 0, *a[8:]))
    kernels.reset_launches()
    res = {"by_path": out, "repeat_bits_equal": repeat_ok, "vmap_3_equals_direct": vmap_ok,
           "launches": launches, "launches_expected": launched, "times": times}
    _say("[kernel] klt_iterate " + json.dumps(res))
    if not repeat_ok:
        faults.append("two calls on the same inputs gave other bits")
    if not vmap_ok:
        faults.append("the vmapped stack of 3 differs from the direct call")
    if launches != launched:
        faults.append(f"{launches} klt_iterate launches for {launched} calls on CUDA tensors")
    if faults:
        raise AssertionError("[kernel] klt_iterate: " + "; ".join(faults))
    t = times["default"]
    return {"name": "klt_iterate", "route": "cuda", "source": "lcvo_tpu_torch/csrc/klt_iterate.cu",
            "replaces": "lcvo_tpu/ops/klt.py:_track_level after its extractions (plain XLA)",
            "max_abs_err": max(v["dd_max"] for v in out.values()),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "neither (the limit is each track's iteration chain)",
            "library_ms": None, "ms_window_21": times["reference"]["kernel_ms"],
            "plain_ms_window_21": times["reference"]["plain_ms"]}


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
    # carry is not kept and the key chain is not advanced
    from lcvo_tpu_torch.utils import jax_random

    chunk_fn = make_chunk_fn(vo.cfg, vo.K, vo.device)
    batch = torch.from_numpy(frames[n_frames: n_frames + CHUNK]).to(vo.device)
    if keyframes_in(vo._frame_idx, batch.shape[0], ba.keyframe_every) < 1:
        raise AssertionError(f"[{tag}] the chunk under the sync detector holds no keyframe")
    keys = jax_random.split(vo._key, batch.shape[0])
    syncs = _host_syncs(lambda: chunk_fn(vo.chunk_carry(), batch, keys,
                                         frame_idx=vo._frame_idx))
    if syncs:
        raise AssertionError(f"[{tag}] the chunk step with BA waits for the device at {syncs}")
    _say(f"[{tag}] a chunk of {batch.shape[0]} frames with "
         f"{keyframes_in(vo._frame_idx, batch.shape[0], ba.keyframe_every)} keyframe step(s) under "
         f"torch.cuda.set_sync_debug_mode('warn'): no host sync")
    return got


def _bits(tree) -> list:
    """Every tensor of a tree as its bytes on the host (None kept): equal lists are
    equal bit for bit, NaN included."""
    import torch
    from torch.utils._pytree import tree_flatten

    return [None if x is None else x.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            for x in tree_flatten(tree)[0]]


def _same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all((x is None and y is None) or (
        x is not None and y is not None and np.array_equal(x, y)) for x, y in zip(a, b))


def _replay_host_ms(vo, frames) -> dict:
    """Host time of one replay of the compiled per-frame step (the wrapper's copies and
    clones, the draws' copy into the graph's buffer and the graph launch, frames and
    draws already on the card),
    over ``len(frames)`` back-to-back calls that nothing waits for, beside the time per
    call once the card has finished them; with BA the same for the keyframe step. The
    replays move ``vo.state`` and not the host's mirror of it, so this runs last on a
    ``vo``."""
    import torch

    from lcvo_tpu_torch.utils import jax_random

    imgs = [torch.from_numpy(f).to(vo.device) for f in frames]
    draws = vo._uniforms(jax_random.split(vo._key, len(imgs)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for im, u in zip(imgs, draws):
        vo.state, _ = vo._process(vo.state, im, u)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = {"process_frame_host_ms_per_replay": host / len(imgs) * 1e3,
           "process_frame_ms_per_replay_done": (time.perf_counter() - t0) / len(imgs) * 1e3}
    if vo.window is not None:
        t0 = time.perf_counter()
        for _ in range(4):
            (vo.state, vo.window), _ = vo._ba((vo.state, vo.window))
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["ba_step_host_ms_per_replay"] = host / 4 * 1e3
        out["ba_step_ms_per_replay_done"] = (time.perf_counter() - t0) / 4 * 1e3
    return out


def main_path_phase(tag: str, cfg, seq, frames, ate_bound: float, min_launches: int,
                    profile_dir: str | None = None, n_frames: int = N_FRAMES):
    """Drive one configuration through ``run_chunked`` on the first ``n_frames`` rendered
    frames (its steps replayed as CUDA graphs), with the launch counters set to 0 just
    before and read just after, and check what came out. ``min_launches``: the fewest
    ``extract_blocks`` launches the run must have made. Returns the printed summary, the
    run's (4, 4) poses and what ``graphs_phase`` holds the eager run to."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils.graphs import disable_graphs

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
    run = {"poses": np.asarray(vo.poses), "pose_ok": list(vo.pose_ok_flags),
           "inliers": list(inliers), "state": _bits(vo.chunk_carry()), "launches": launches,
           "rebootstraps": vo.n_rebootstraps, "graphs": vo.graph_stats()}

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
    lock = lockstep_check(tag.split(":", 1)[1] if ":" in tag else "default", est, flags,
                          inliers, ate, frames_sha256(frames[:n_frames]))
    if not ate < ate_bound:
        raise AssertionError(f"[{tag}] ATE {ate} m >= {ate_bound} m")
    if launches["extract_blocks"] < min_launches:
        raise AssertionError(f"[{tag}] extract_blocks launched {launches['extract_blocks']} "
                             f"times on the main path, < {min_launches}")
    if launches["svd"] < SVD_PER_BOOTSTRAP[cfg.ransac.e_solver]:
        raise AssertionError(f"[{tag}] the SVD launched {launches['svd']} times on the main "
                             f"path, < {SVD_PER_BOOTSTRAP[cfg.ransac.e_solver]} of a bootstrap")
    _hold_launches(tag, vo)
    # marks: bootstrap end, the chunks, then the per-frame tail; the first chunk carries
    # first-call costs and is left out
    chunk_ends = [t for t, n in marks if n == CHUNK]
    steady_fps = CHUNK * (len(chunk_ends) - 1) / (chunk_ends[-1] - chunk_ends[0])
    bootstrap_first_s = marks[0][0] - t0   # with every first-call cost of the process

    # no host round trip inside the step: every call that synchronises is listed (the
    # eager step, which is where one would be; the graphs' replays are checked in a
    # whole chunk by graphs_phase)
    from lcvo_tpu_torch.utils import jax_random

    img = torch.from_numpy(frames[n_frames]).to("cuda")
    u = vo._uniforms(jax_random.split(vo._key, 1))[0]
    with disable_graphs():
        syncs = _host_syncs(lambda: vo._process(vo.state, img, u))
    if syncs:
        raise AssertionError(f"[{tag}] process_frame waits for the device at {syncs}")
    _say(f"[{tag}] process_frame under torch.cuda.set_sync_debug_mode('warn'): no host sync")
    ba = ba_checks(tag, vo, frames, n_frames) if cfg.ba.enabled else None

    # step latency, graphed, then eager on the frames after those
    lat, lat_eager = [], []
    for f in frames[n_frames: n_frames + N_LATENCY]:
        t1 = time.perf_counter()
        res = vo.step(f)
        res.R.cpu()
        lat.append((time.perf_counter() - t1) * 1e3)
    with disable_graphs():
        for f in frames[n_frames + N_LATENCY: n_frames + 2 * N_LATENCY]:
            t1 = time.perf_counter()
            res = vo.step(f)
            res.R.cpu()
            lat_eager.append((time.perf_counter() - t1) * 1e3)

    # the bootstrap once more, warm, on a fresh VisualOdometry whose graphs its own first
    # bootstrap captured (it ends with a read-back)
    vo_b = VisualOdometry(cfg, seq.K, device="cuda")
    vo_b.bootstrap(list(frames[: gap + 1]))
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
        "step_latency_ms": lat, "step_latency_ms_median_eager": statistics.median(lat_eager),
        "launches": launches, "min_launches": min_launches,
        "rebootstraps": vo.n_rebootstraps, "bootstrap_first_s": bootstrap_first_s,
        "bootstrap_warm_s": bootstrap_warm_s, "lockstep_distance_m_max": lock.get("distance_m_max"),
    }
    if ba is not None:
        out["ba"] = ba
    _say(f"[{tag}] " + json.dumps(out))
    run["steady_fps"] = steady_fps
    run["step_latency_ms_median"] = out["step_latency_ms_median"]
    run["step_latency_ms_median_eager"] = out["step_latency_ms_median_eager"]
    if profile_dir:
        profile_chunk(vo, frames[n_frames - CHUNK: n_frames], profile_dir,
                      tag.replace(":", "_") + "_profile.json")
    # last: the replays below leave the host mirror of frame_idx behind the state
    run["replay"] = _replay_host_ms(vo, frames[n_frames: n_frames + CHUNK])
    return out, poses, run


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


def _graph_summary(stats: dict) -> dict:
    """What ``VisualOdometry.graph_stats()`` says, summed per path: graphs captured,
    warm-up and capture plus instantiation seconds, nodes per graph, pool bytes."""
    g = stats["graphs"]
    return {"graphs_captured": len(g), "graphs": [x["name"] for x in g],
            "warmup_s": sum(x["warmup_s"] for x in g),
            "capture_plus_instantiate_s": sum(x["capture_s"] + x["instantiate_s"] for x in g),
            "nodes": [x["nodes"] for x in g], "pool_bytes": stats["pool_bytes"]}


def graphs_phase(tag: str, cfg, seq, frames, n_frames: int, graphed: dict) -> dict:
    """``[graphs:<tag>]``: the run of ``main_path_phase`` once more with every step
    eager (``disable_graphs()``), from the same seed on the same frames, held equal to
    the graphed run exactly: poses, pose_ok, PnP inliers, launches and every tensor of
    the final state (and window). Prints frames/s and step latency graphed and eager
    side by side, the graphs captured, their capture time, nodes and pool bytes, and the
    host time of one replay."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    vo = VisualOdometry(cfg, seq.K, device="cuda")
    inliers, ends = [], []

    def on_chunk(start, Rs, ts, ok, ninl):
        inliers.extend(int(n) for n in ninl)
        if len(ok) == CHUNK:
            ends.append(time.perf_counter())

    torch.cuda.synchronize()
    kernels.reset_launches()
    with disable_graphs():
        vo.run_chunked(frames[:n_frames], chunk=CHUNK, on_chunk=on_chunk)
    torch.cuda.synchronize()
    eager = {"poses": np.asarray(vo.poses), "pose_ok": list(vo.pose_ok_flags),
             "inliers": inliers, "state": _bits(vo.chunk_carry()),
             "launches": dict(kernels.LAUNCHES), "rebootstraps": vo.n_rebootstraps}
    equal = {k: (np.array_equal(graphed[k], eager[k]) if k == "poses" else
                 _same_bits(graphed[k], eager[k]) if k == "state" else graphed[k] == eager[k])
             for k in ("poses", "pose_ok", "inliers", "state", "launches", "rebootstraps")}
    fps_eager = CHUNK * (len(ends) - 1) / (ends[-1] - ends[0])
    out = {"path": tag, "frames": n_frames, "graphed_equals_eager": equal,
           "fps_graphed": graphed["steady_fps"], "fps_eager": fps_eager,
           "fps_ratio": graphed["steady_fps"] / fps_eager,
           "step_latency_ms_median_graphed": graphed["step_latency_ms_median"],
           "step_latency_ms_median_eager": graphed["step_latency_ms_median_eager"],
           **_graph_summary(graphed["graphs"]), **graphed["replay"],
           "launches": graphed["launches"]}
    _say(f"[graphs:{tag}] " + json.dumps(out))
    if not all(equal.values()):
        raise AssertionError(f"[graphs:{tag}] the graphed run left the eager run: {equal}")
    return out


def graphs_run_phase(cfg, seq, frames) -> dict:
    """``[graphs:run]``: the per-frame loop (``run``) of the default configuration on
    the main paths' frames, graphed and under ``disable_graphs()``: poses, pose_ok, every
    ``FrameResult`` and the final state equal exactly; frames/s of both."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    got = {}
    for name in ("graphed", "eager"):
        vo = VisualOdometry(cfg, seq.K, device="cuda")
        stamps = []
        torch.cuda.synchronize()
        kernels.reset_launches()
        with disable_graphs() if name == "eager" else contextlib.nullcontext():
            vo.run(iter(frames[:N_FRAMES]), N_FRAMES,
                   on_frame=lambda i, res: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        # frames/s over the steps after the first ten (first-call costs left out)
        got[name] = {"poses": np.asarray(vo.poses), "pose_ok": list(vo.pose_ok_flags),
                     "results": _bits(vo.results), "state": _bits(vo.state),
                     "launches": dict(kernels.LAUNCHES),
                     "fps": (len(stamps) - 11) / (stamps[-1] - stamps[10])}
    g, e = got["graphed"], got["eager"]
    equal = {"poses": np.array_equal(g["poses"], e["poses"]), "pose_ok": g["pose_ok"] == e["pose_ok"],
             "results": _same_bits(g["results"], e["results"]),
             "state": _same_bits(g["state"], e["state"]), "launches": g["launches"] == e["launches"]}
    out = {"path": "default:run", "frames": N_FRAMES, "graphed_equals_eager": equal,
           "fps_graphed": g["fps"], "fps_eager": e["fps"], "launches": g["launches"]}
    _say("[graphs:run] " + json.dumps(out))
    if not all(equal.values()):
        raise AssertionError(f"[graphs:run] the graphed run left the eager run: {equal}")
    return out


def graphed_chunk_syncs(tag: str, cfg, seq, frames, n_frames: int) -> None:
    """No host sync inside a replayed chunk: a warm host loop (its graphs captured by
    the chunks before) runs one more chunk of 16 through ``make_chunk_step`` (with BA,
    its keyframe replays too) under ``torch.cuda.set_sync_debug_mode("warn")``."""
    import torch

    from lcvo_tpu_torch.pipeline import VisualOdometry, keyframes_in
    from lcvo_tpu_torch.utils import jax_random

    vo = VisualOdometry(cfg, seq.K, device="cuda")
    vo.run_chunked(frames[:n_frames - 3], chunk=CHUNK)
    step = vo.make_chunk_step(CHUNK)
    batch = torch.from_numpy(frames[n_frames: n_frames + CHUNK]).to(vo.device)
    kf = keyframes_in(vo._frame_idx, CHUNK, cfg.ba.keyframe_every) if cfg.ba.enabled else 0
    steps = (vo._process, vo._ba, vo._uniforms.compiled)
    captures = sum(x.captures() for x in steps if x is not None)
    # the chunk's keys made and uploaded inside, as the host loop does
    syncs = _host_syncs(lambda: vo.set_chunk_carry(
        step(vo.chunk_carry(), batch, jax_random.split(vo._next_key(), CHUNK),
             frame_idx=vo._frame_idx)[0], CHUNK))
    if sum(x.captures() for x in steps if x is not None) != captures:
        raise AssertionError(f"[graphs:{tag}] the chunk under the sync detector captured anew")
    if syncs:
        raise AssertionError(f"[graphs:{tag}] a replayed chunk waits for the device at {syncs}")
    _say(f"[graphs:{tag}] a replayed chunk of {CHUNK} frames with {kf} keyframe replay(s) "
         f"under torch.cuda.set_sync_debug_mode('warn'): no host sync")


def _svd_bound(B: int, m: int, n: int) -> tuple[float, str]:
    """The least time of B SVDs of m x n with U and V on the card: bytes (A read, S, U,
    V and the codes written once) at the HBM rate, or operations (the Golub-Reinsch
    count for S, U and V, 4a^2 b + 8a b^2 + 9b^3 with a >= b, Golub and Van Loan) at the
    float32 rate, whichever is larger. A direct method's count, not the Jacobi sweeps
    cuSOLVER makes, which its batched routine does not report."""
    a, b = max(m, n), min(m, n)
    nbytes = 4 * B * (m * n + b + m * m + n * n + 1)
    ops = B * (4 * a * a * b + 8 * a * b * b + 9 * b ** 3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _svd_errors(site: str, A, got, want) -> dict:
    """The route's results against torch.linalg.svd's: singular values (relative),
    reconstruction (relative, per matrix), the vectors the call site takes up to sign."""
    import torch

    U, S, Vh = got
    U0, S0, V0 = want
    k = S.shape[-1]
    s_rel = float(((S - S0).abs() / S0.abs().clamp_min(1e-30)).max())
    rec = (U[..., :k] * S[..., None, :]) @ Vh[..., :k, :]
    recon = float((torch.linalg.norm((rec - A).flatten(-2), dim=-1)
                   / torch.linalg.norm(A.flatten(-2), dim=-1)).max())

    def signed(v, v0):          # vectors along the last axis, each matched in sign
        sgn = torch.sign((v * v0).sum(-1, keepdim=True))
        return float((v * torch.where(sgn == 0, 1.0, sgn) - v0).abs().max())

    if site == "eight_point":
        vec = signed(Vh[..., -1, :], V0[..., -1, :])
    elif site == "five_point":
        N, N0 = Vh[..., 5:, :], V0[..., 5:, :]
        vec = float((N.mT @ N - N0.mT @ N0).abs().max())
    else:
        vec = max(signed(U.mT, U0.mT), signed(Vh, V0))
    return {"s_rel": s_rel, "recon_rel": recon, "vectors": vec}


def _nan_bits_equal(a, b) -> bool:
    """Two tensor tuples equal bit for bit, NaN included."""
    import torch

    return all(torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


def _svd_failures(cfg, seq, frames, gen) -> dict:
    """The SVD failure semantics on the card (JAX's: a failed matrix is NaN, nothing
    raises). At each sweep cap, on one eight-point batch: the matrices cuSOLVER flags
    (``info != 0``), the record's count and whether exactly those come back NaN. A batch
    with a NaN and an inf matrix: their codes, and both NaN. Then the default bootstrap
    under ``SVD_FORCED_SWEEPS``, eager with every SVD call's codes kept: it returns, each
    call's NaN matrices are those flagged or not finite, the record counts the
    eight-point fit's flagged ones; the same bootstrap graphed (its graphs captured
    under the cap, which a graph keeps) equal to it bit for bit; and ``run`` (eager) with
    its first bootstrap capped extends the window, as the JAX loop does."""
    import torch

    from lcvo_tpu_torch.ops import svd as svd_mod
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    eight = svd_mod.SITES.index("eight_point")
    A = torch.randn(SVD_SHAPES[0][1], generator=gen, device="cuda")
    caps, bad = {}, []
    for cap in range(1, 9):
        svd_mod.reset("cuda")
        with svd_mod.sweep_cap(cap):
            flagged = svd_mod._gesvdj(A)[3] != 0
            S = svd_mod.svd(A, False, site="eight_point")[1]
        caps[cap] = {"flagged": int(flagged.sum()), "recorded": int(svd_mod.record("cuda")[eight, 0]),
                     "nan_are_flagged": bool(torch.equal(torch.isnan(S).any(-1), flagged))}
        if caps[cap]["recorded"] != caps[cap]["flagged"] or not caps[cap]["nan_are_flagged"]:
            bad.append(f"cap {cap}: {caps[cap]}")
    B = A.clone()
    B[3, 1, 1], B[7, 0, 0] = float("nan"), float("inf")
    info = svd_mod._gesvdj(B)[3]
    got = svd_mod.svd(B, False, site="eight_point")
    nonfinite = {"codes_of_nan_inf_matrices": info[[3, 7]].tolist(),
                 "nan_matrices": torch.nonzero(torch.isnan(got[1]).any(-1)).flatten().tolist(),
                 "equal_to_plain": _nan_bits_equal(got, svd_mod.svd_plain(B, False))}
    if nonfinite["nan_matrices"] != [3, 7] or not nonfinite["equal_to_plain"]:
        bad.append(f"non-finite input: {nonfinite}")

    boot = list(frames[: cfg.bootstrap.frame_gap + 1])
    calls, gesvdj, route = [], svd_mod._gesvdj, svd_mod._svd_cuda

    def kept_codes(A):
        out = gesvdj(A)
        calls.append({"finite": torch.isfinite(A).flatten(-2).all(-1).reshape(-1),
                      "flagged": out[3] != 0})
        return out

    def kept_nan(A, full, site):
        out = route(A, full, site)
        calls[-1].update(site=site, nan=torch.isnan(out[1]).reshape(calls[-1]["flagged"].shape[0], -1).any(-1))
        return out

    svd_mod._gesvdj, svd_mod._svd_cuda = kept_codes, kept_nan
    try:
        with disable_graphs(), svd_mod.sweep_cap(SVD_FORCED_SWEEPS):
            vo_e = VisualOdometry(cfg, seq.K, device="cuda")
            n_e = vo_e.bootstrap(boot)
        rec_e = svd_mod.record("cuda").cpu()
    finally:
        svd_mod._gesvdj, svd_mod._svd_cuda = gesvdj, route
    per_call = [{"site": c["site"], "flagged": int(c["flagged"].sum()),
                 "not_finite": int((~c["finite"]).sum()),
                 "nan_are_failed": bool(torch.equal(c["nan"], c["flagged"] | ~c["finite"]))}
                for c in calls]
    with svd_mod.sweep_cap(SVD_FORCED_SWEEPS):
        vo_g = VisualOdometry(cfg, seq.K, device="cuda")
        n_g = vo_g.bootstrap(boot)
    fit = per_call[0]
    capped = {"returned_n_inl": n_e, "svd_failures": vo_e.last_bootstrap_svd_failures,
              "record_by_site": svd_mod.failures(rec_e), "calls": per_call,
              "pose_is_nan": bool(torch.isnan(vo_e.state.R).all()),
              "graphed_equal_eager": bool(n_g == n_e and _same_bits(_bits(vo_g.state), _bits(vo_e.state))
                                          and vo_g.last_bootstrap_svd_failures
                                          == vo_e.last_bootstrap_svd_failures)}
    if not (fit["site"] == "eight_point" and fit["flagged"] > 0
            and int(rec_e[eight, 0]) == fit["flagged"] and all(c["nan_are_failed"] for c in per_call)
            and capped["graphed_equal_eager"]):
        bad.append(f"capped bootstrap: {capped}")

    # run(): the first bootstrap capped, the extended one not (eager: a graph would keep
    # the cap for every bootstrap after)
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    boots, bootstrap = [], vo.bootstrap

    def first_capped(burst, *a, **k):
        with svd_mod.sweep_cap(SVD_FORCED_SWEEPS if not boots else 0):
            n = bootstrap(burst, *a, **k)
        boots.append([len(burst), n, vo.last_bootstrap_svd_failures])
        return n

    vo.bootstrap = first_capped
    with disable_graphs():
        traj = vo.run(iter(frames), SVD_RUN_FRAMES)
    gap = cfg.bootstrap.frame_gap
    run = {"bootstraps": boots, "poses": len(traj), "first_pose_ok": vo.pose_ok_flags[0],
           "later_poses_finite": bool(np.isfinite(np.stack(traj[1:])).all())}
    if not (len(boots) == 2 and boots[0][:2] == [gap + 1, 0] and boots[0][2] > 0
            and boots[1][0] == gap + 2 and boots[1][1] >= cfg.bootstrap.min_matches
            and len(traj) == SVD_RUN_FRAMES - gap and not vo.pose_ok_flags[0]
            and run["later_poses_finite"]):
        bad.append(f"run from a capped bootstrap: {run}")
    svd_mod.reset("cuda")
    out = {"failed_of_512_by_sweep_cap": caps, "non_finite_input": nonfinite,
           f"bootstrap_at_sweep_cap_{SVD_FORCED_SWEEPS}": capped,
           f"run_first_bootstrap_at_cap_{SVD_FORCED_SWEEPS}": run}
    if bad:
        raise AssertionError(f"[svd] failure semantics: {bad}\n{json.dumps(out, default=str)}")
    return out


def svd_phase(cfg, ref_cfg, seq, frames) -> dict:
    """``[svd]``: the SVD route (``ops/svd.py`` + ``csrc/svd.cu``) against
    ``torch.linalg.svd`` on the card at the four call sites' shapes (singular values,
    reconstruction, the vectors used, and whether every bit agrees), each one's time
    replayed in a CUDA graph beside ``torch.linalg.svd``'s eager time (it cannot be
    captured) and the bound; on a bootstrap's own points at 1240x376, the essential
    matrix, inlier mask and count of ``essential_ransac`` with the route equal to those
    with ``torch.linalg.svd`` (eight-point and five-point); then the failure semantics
    (:func:`_svd_failures`). Returns the kernel line's row."""
    import torch

    from lcvo_tpu_torch.core import geometry as geo
    from lcvo_tpu_torch.ops import epipolar
    from lcvo_tpu_torch.ops import svd as svd_mod
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils import jax_random

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, worst = {}, {"s_rel": 0.0, "recon_rel": 0.0, "vectors": 0.0, "max_abs_err": 0.0}
    for site, shape, full in SVD_SHAPES:
        A = torch.randn(shape, generator=gen, device="cuda")
        got = svd_mod.svd(A, full, site=site)
        want = svd_mod.svd_plain(A, full)
        err = _svd_errors(site, A, got, want)
        bits = all(torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
                   for x, y in zip(got, want))
        err["max_abs_err"] = max(float((x - y).abs().max()) for x, y in zip(got, want))
        B = A.shape[0] if A.dim() == 3 else 1
        bound, by = _svd_bound(B, *shape[-2:])
        cases[site] = {"shape": list(shape), "full_matrices": full, **err, "bits_equal": bits,
                       "ms": graph_ms(lambda: svd_mod.svd(A, full, site=site)),
                       "plain_ms": _eager_ms(lambda: svd_mod.svd_plain(A, full), n=50),
                       "bound_ms": bound, "bound_by": by}
        for k in worst:
            worst[k] = max(worst[k], err[k])
    bad = {s: c for s, c in cases.items() if not (c["s_rel"] <= SVD_S_REL and
                                                 c["recon_rel"] <= SVD_RECON_REL and
                                                 c["vectors"] <= SVD_VEC)}

    # essential_ransac on a bootstrap's points, with the route and with torch.linalg.svd
    ransac = {}
    for solver, c in (("eight_point", cfg), ("five_point", ref_cfg)):
        vo = VisualOdometry(c, seq.K, device="cuda")
        gap = c.bootstrap.frame_gap
        imgs = [vo._frame(f).to(torch.float32) for f in frames[: gap + 1]]
        pyrs = [vo._pyramid(im) for im in imgs]
        pts0, ok = vo._detect0(imgs[0])
        pts = pts0
        for i in range(gap):
            pts, ok = vo._track_pair(pyrs[i], pyrs[i + 1], pts, ok)
        Kt = torch.as_tensor(np.asarray(seq.K, np.float32), device="cuda")
        x0, x1 = geo.normalize_points(pts0, Kt), geo.normalize_points(pts, Kt)
        outs = []
        for route in (svd_mod.svd, lambda A, full_matrices=True, *, site:
                      svd_mod.svd_plain(A, full_matrices)):
            saved, svd_mod.svd = svd_mod.svd, route
            try:
                u = torch.from_numpy(jax_random.uniform(
                    jax_random.PRNGKey(c.seed),
                    epipolar.draw_shape(c.ransac.e_hypotheses, solver))).to("cuda")
                outs.append(epipolar.essential_ransac(
                    u, x0, x1, ok, thresh=c.ransac.e_thresh_px / float(seq.K[0, 0]),
                    n_hyp=c.ransac.e_hypotheses, solver=solver))
            finally:
                svd_mod.svd = saved
        (E, inl, n), (E0, inl0, n0) = outs
        ransac[solver] = {"E_equal": bool(torch.equal(E, E0)), "inliers_equal": bool(torch.equal(inl, inl0)),
                          "n_inl": int(n), "n_inl_plain": int(n0)}

    forced = _svd_failures(cfg, seq, frames, gen)
    out = {"cases": cases, "worst": worst, "limits": {"s_rel": SVD_S_REL, "recon_rel": SVD_RECON_REL,
                                                      "vectors": SVD_VEC},
           "essential_ransac_route_vs_torch": ransac, **forced}
    _say("[svd] " + json.dumps(out))
    if bad:
        raise AssertionError(f"[svd] the route leaves torch.linalg.svd at {bad}")
    if not all(r["E_equal"] and r["inliers_equal"] and r["n_inl"] == r["n_inl_plain"]
               for r in ransac.values()):
        raise AssertionError(f"[svd] essential_ransac differs with the route: {ransac}")
    main = cases["eight_point"]
    return {"name": "svd", "route": "cuda", "source": "lcvo_tpu_torch/csrc/svd.cu",
            "replaces": "lcvo_tpu/ops/epipolar.py:47 (jnp.linalg.svd, XLA; no Pallas kernel)",
            "max_abs_err": worst["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["plain_ms"],
            "ms_by_site": {s: c["ms"] for s, c in cases.items()},
            "library_ms_by_site": {s: c["plain_ms"] for s, c in cases.items()},
            "bound_ms_by_site": {s: c["bound_ms"] for s, c in cases.items()}}


def bootstrap_phase(tag: str, cfg, seq, frames) -> dict:
    """``[bootstrap:<tag>]``: the bootstrap of ``cfg`` on the first ``frame_gap + 1``
    frames, graphed (a fresh host loop, so its first bootstrap captures the pieces'
    graphs) and under ``disable_graphs()`` (a second host loop from the same seed): the
    state after it (R and t among its tensors) and the inlier count equal bit for bit,
    launches equal; no host sync inside the replays of the pieces (the bootstrap's own
    read-back comes after them); wall seconds of the first bootstrap and of
    ``BOOT_REPS`` warm ones each way, the replayed pieces alone (what is left is the
    eager assembly), the graphs, their capture and instantiation seconds, nodes and
    pool bytes."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.pipeline import VisualOdometry, keys_to_device
    from lcvo_tpu_torch.utils import jax_random
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    burst = list(frames[: cfg.bootstrap.frame_gap + 1])
    got = {}
    for name in ("graphed", "eager"):
        vo = VisualOdometry(cfg, seq.K, device="cuda")
        with disable_graphs() if name == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            n = vo.bootstrap(burst)
            first = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            state = _bits(vo.chunk_carry())
            R, t = _bits(vo.state.R), _bits(vo.state.t)
            stats = vo.graph_stats()
            warm = []
            for _ in range(BOOT_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vo.bootstrap(burst)
                warm.append(time.perf_counter() - t0)
        got[name] = {"vo": vo, "n": n, "first_s": first, "warm_s": warm, "launches": launches,
                     "state": state, "R": R, "t": t, "stats": stats}
    g, e = got["graphed"], got["eager"]
    equal = {"state": _same_bits(g["state"], e["state"]), "R": _same_bits(g["R"], e["R"]),
             "t": _same_bits(g["t"], e["t"]), "n_inl": g["n"] == e["n"],
             "launches": g["launches"] == e["launches"]}

    # the pieces alone, replayed: no host sync inside them, and their wall time
    vo = g["vo"]
    imgs = [vo._frame(f).to(torch.float32) for f in burst]
    captures = sum(c.captures() for c in vo._compiled())

    def pieces():
        pyrs = [vo._pyramid(im) for im in imgs]
        if vo._match is not None:
            f0, f1 = vo._sift(imgs[0]), vo._sift(imgs[-1])
            idx, ok = vo._match(f0.desc, f0.valid, f1.desc, f1.valid)
            pts0, pts = f0.pts, f1.pts[idx]
        else:
            pts0, ok = vo._detect0(imgs[0])
            pts = pts0
            for i in range(len(imgs) - 1):
                pts, ok = vo._track_pair(pyrs[i], pyrs[i + 1], pts, ok)
            if vo._sift is not None:
                vo._sift(imgs[-1])
        return vo._two_view(key, pts0, pts, ok)

    def timed(fn, *args):       # one replay and its wall ms until the card has done it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the key of the bootstrap below, on the card: the pieces do not advance the chain
    key = keys_to_device(jax_random.split(vo._key)[1], "cuda")
    syncs = _host_syncs(pieces)
    pieces_s, by_piece = [], {}
    for _ in range(BOOT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pieces()
        torch.cuda.synchronize()
        pieces_s.append(time.perf_counter() - t0)
        # the same replays one by one: where the bootstrap's time goes
        pyrs = [timed(vo._pyramid, im) for im in imgs]
        times = {"build_pyramid": sum(ms for _, ms in pyrs)}
        pyrs = [p for p, _ in pyrs]
        if vo._match is not None:
            (f0, ms0), (f1, ms1) = timed(vo._sift, imgs[0]), timed(vo._sift, imgs[-1])
            (idx, ok), times["mutual_match"] = timed(vo._match, f0.desc, f0.valid, f1.desc,
                                                     f1.valid)
            times["sift_features"] = ms0 + ms1
            pts0, pts = f0.pts, f1.pts[idx]
        else:
            (pts0, ok), times["detect0"] = timed(vo._detect0, imgs[0])
            pts, times["track_pair"] = pts0, 0.0
            for i in range(len(imgs) - 1):
                (pts, ok), ms = timed(vo._track_pair, pyrs[i], pyrs[i + 1], pts, ok)
                times["track_pair"] += ms
            if vo._sift is not None:
                times["sift_features"] = timed(vo._sift, imgs[-1])[1]
        times["two_view_init"] = timed(vo._two_view, key, pts0, pts, ok)[1]
        for k, v in times.items():
            by_piece.setdefault(k, []).append(v)
    boot_syncs = _host_syncs(lambda: vo.bootstrap(burst))
    if sum(c.captures() for c in vo._compiled()) != captures:
        raise AssertionError(f"[bootstrap:{tag}] a warm bootstrap captured anew")

    warm_g, warm_e = statistics.median(g["warm_s"]), statistics.median(e["warm_s"])
    out = {"path": tag, "frames": len(burst), "graphed_equals_eager": equal,
           "n_inl": g["n"], "first_s_graphed": g["first_s"], "first_s_eager": e["first_s"],
           "warm_s_graphed": g["warm_s"], "warm_s_eager": e["warm_s"],
           "warm_s_graphed_median": warm_g, "warm_s_eager_median": warm_e,
           "speedup_warm": warm_e / warm_g,
           "pieces_s_graphed_median": statistics.median(pieces_s),
           "assembly_share_of_graphed": 1.0 - statistics.median(pieces_s) / warm_g,
           "piece_ms_median": {k: statistics.median(v) for k, v in by_piece.items()},
           **_graph_summary(g["stats"]), "launches": g["launches"],
           "syncs_in_replays": syncs, "syncs_in_whole_bootstrap": boot_syncs}
    _say(f"[bootstrap:{tag}] " + json.dumps(out))
    if not all(equal.values()):
        raise AssertionError(f"[bootstrap:{tag}] the graphed bootstrap left the eager one: {equal}")
    if syncs:
        raise AssertionError(f"[bootstrap:{tag}] the bootstrap's replays wait for the device at "
                             f"{syncs}")
    if g["launches"]["svd"] != SVD_PER_BOOTSTRAP[cfg.ransac.e_solver]:
        raise AssertionError(f"[bootstrap:{tag}] {g['launches']['svd']} SVD launches, "
                             f"{SVD_PER_BOOTSTRAP[cfg.ransac.e_solver]} expected")
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


def _watched(vo, tag: str) -> tuple[list, list, list]:
    """Wrap ``vo.bootstrap``: returns the lists it fills, the steps since the previous
    bootstrap, each bootstrap's anchor (R0, t0; None for the first) and each one's wall
    seconds and the bootstrap graphs captured so far, and checks that every bootstrap leaves the
    mirror at 0 and an empty window."""
    import torch

    segments, anchors, boots = [], [], []
    boot = vo.bootstrap

    def watched_bootstrap(*a, **k):     # steps since the previous bootstrap, and after it
        segments.append(vo._frame_idx)
        anchors.append(None if k.get("R0") is None else
                       np.concatenate([np.ravel(k["R0"]), np.ravel(k["t0"])]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = boot(*a, **k)             # ends with its read-back
        boots.append((time.perf_counter() - t0, sum(
            c.captures() for c in vo._compiled()
            if c.name not in ("process_frame", "ba_step", "pnp_uniforms"))))
        if vo.window is not None and (vo._frame_idx or bool(vo.window.kf_valid.any())):
            raise AssertionError(f"[{tag}] a bootstrap left frame_idx {vo._frame_idx} or a "
                                 f"keyframe in the window")
        return out

    vo.bootstrap = watched_bootstrap
    return segments, anchors, boots


def _recovery_eager(cfg, seq, frames, chunked: bool) -> dict:
    """The recovery run with every step eager (``disable_graphs()``): re-bootstraps,
    anchors and poses, which the graphed run must repeat."""
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    vo = VisualOdometry(cfg, seq.K, device="cuda")
    _, anchors, boots = _watched(vo, "recovery:eager")
    with disable_graphs():
        if chunked:
            vo.run_chunked(frames, chunk=CHUNK)
        else:
            vo.run(iter(frames), len(frames))
    return {"rebootstraps": vo.n_rebootstraps, "anchors": anchors, "poses": np.asarray(vo.poses),
            "bootstrap_s": [b[0] for b in boots]}


def _recovery_run(tag: str, cfg, seq, frames, jax: tuple, chunked: bool) -> tuple:
    """One recovery run on the card: counters at 0 before, read after; one pose per
    frame from ``frame_gap`` on, at least one re-bootstrap and no more than the JAX
    package's ``jax = (ATE, re-bootstraps)`` on the same frames, ``health`` 0 at the end
    and the last 8 poses good, ATE under ``jax_held_bound``, the scale seam inside
    ``SCALE_SEAM`` and launches at or above the floor. Through the graphs: the same
    re-bootstraps, anchors and poses, bit for bit, as the eager run of the same frames."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    n = len(frames)
    gap, skip = cfg.bootstrap.frame_gap, max(cfg.bootstrap.rebootstrap_skip, 1)
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    segments, anchors, boots = _watched(vo, tag)
    ninl: list[int] = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if chunked:
        traj = vo.run_chunked(frames, chunk=CHUNK, on_chunk=lambda s, R, t, ok, ni: ninl.extend(
            int(x) for x in ni))
    else:
        traj = vo.run(iter(frames), n, on_frame=lambda i, r: ninl.append(int(r.n_inliers)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["extract_blocks"]
    _hold_launches(tag, vo)
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
    bound = jax_held_bound(jax_ate, RECOVERY_FILE_BOUND_M, RECOVERY_ATE_FACTOR)
    out = {"frames": n, "burst": list(RECOVERY_BURST), "burst_seed": RECOVERY_BURST_SEED,
           "chunked": chunked, "poses": len(est), "rebootstraps": n_reb,
           "health_end": int(vo.state.health), "last_8_pose_ok": bool(flags[-8:].all()),
           "pose_ok_rate": float(flags.mean()),
           "not_ok_indices": [int(i) for i in np.flatnonzero(~flags)],
           "ate_m": ate, "ate_bound_m": bound, "jax_cpu_ate_m": jax_ate,
           "jax_cpu_rebootstraps": jax_reb, "scale_seam": seam, "launches": launches, "launches_floor": floor,
           "steps_per_segment": segments, "wall_s": wall}
    lockstep_check(tag, est, flags, ninl, ate, frames_sha256(frames))
    eager = _recovery_eager(cfg, seq, frames, chunked)
    same_anchors = len(anchors) == len(eager["anchors"]) and all(
        (a is None and b is None) or (a is not None and b is not None and np.array_equal(a, b))
        for a, b in zip(anchors, eager["anchors"]))
    out["graphed_vs_eager"] = {"rebootstraps_eager": eager["rebootstraps"],
                               "anchors_equal": same_anchors,
                               "poses_equal": bool(np.array_equal(np.asarray(vo.poses),
                                                                  eager["poses"]))}
    # each bootstrap's wall seconds (the first pays the bootstrap graphs' captures), and
    # the graphs captured after each: a re-bootstrap replays the first one's
    out["bootstrap_s_graphed"] = [b[0] for b in boots]
    out["bootstrap_s_eager"] = eager["bootstrap_s"]
    out["graphs_after_each_bootstrap"] = [b[1] for b in boots]
    _say(f"[{tag}] " + json.dumps(out))
    if (n_reb != eager["rebootstraps"] or not same_anchors
            or not out["graphed_vs_eager"]["poses_equal"]):
        raise AssertionError(f"[{tag}] the graphed run differs from the eager one: "
                             f"{out['graphed_vs_eager']}")
    if any(b[1] != boots[0][1] for b in boots):
        raise AssertionError(f"[{tag}] a re-bootstrap captured new graphs: "
                             f"{out['graphs_after_each_bootstrap']}")
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
    # a chunk of the burst and the frames around it, from the state the run ended in,
    # replayed (the graphs are warm); the key chain is not advanced
    from lcvo_tpu_torch.utils import jax_random

    lo = cfg.bootstrap.frame_gap + 1 + CHUNK
    batch = torch.from_numpy(frames[lo: lo + CHUNK]).to("cuda")
    step = vo.make_chunk_step(CHUNK)
    keys = jax_random.split(vo._key, CHUNK)
    syncs = _host_syncs(lambda: step(vo.chunk_carry(), batch, keys, frame_idx=vo._frame_idx))
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
    ninl: list[int] = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = vo.run(iter(frames), n, on_frame=lambda i, r: ninl.append(int(r.n_inliers)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.LAUNCHES["extract_blocks"]
    _hold_launches(tag, vo)
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
    lockstep_check(f"stress:{tag}", est, vo.pose_ok_flags, ninl, ate, frames_sha256(frames))
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
        fr = render(turn, n)
        out = _stress_run(tag, c, turn.K, fr, turn.gt_positions(), bound, max_reb)
        _keep_segment_inputs(f"stress:{tag}", c, turn.K, fr)
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
        fr = arena.frames_device(0, m).cpu().numpy()
        out = _stress_run(tag, c, arena.K, fr, arena.gt_positions(), bound, max_reb)
        _keep_segment_inputs(f"stress:{tag}", c, arena.K, fr)
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
    _hold_launches("longhorizon", vo)
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


def segments_phase() -> dict:
    """``[segments:<path>]`` for each path of ``SEGMENT_BOUNDS``: one ``VisualOdometry`` on
    the card resumes every window's JAX state (a missing file raises) and runs the
    window, the launch counters at 0 before the path and read after; per window the
    distance to the JAX package's continuation (largest, at the end, at the first entry),
    pose_ok equal, the first frame where the runs part; ``SEGMENT_FRESH``'s second window
    again in a fresh host loop, equal bit for bit. A bound missed is kept and raised when
    every phase has run. Returns each path's launches and their floor."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils import segments as segs

    t_phase = time.perf_counter()
    counted = {}
    for path, (bound_kept, bound_lost) in SEGMENT_BOUNDS.items():
        seg_dir = segs.segments_dir(path)
        with open(os.path.join(seg_dir, segs.SEGMENTS)) as fh:
            rec = json.load(fh)
        c, K, fr = _segment_inputs[path]
        if c.seed != rec["seed"] or len(fr) != rec["n_frames"]:
            raise AssertionError(f"[segments:{path}] seed {c.seed} / {len(fr)} frames, the "
                                 f"states' {rec['seed']} / {rec['n_frames']}")
        src = segs.array_frames(fr, K)
        vo = VisualOdometry(c, K, device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        runs = [segs.run_port_window(vo, seg_dir, rec, w, src) for w in rec["windows"]]
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES["extract_blocks"]
        n = sum(w["end"] - w["start"] for w in rec["windows"])
        floor = (_launch_floor(c, 0, 0, extra_hops=n) if rec["loop"] == "run"
                 else _launch_floor(c, n, 0))
        fresh = None
        if path == SEGMENT_FRESH:
            w = rec["windows"][1]
            again = segs.run_port_window(VisualOdometry(c, K, device="cuda"), seg_dir, rec, w, src)
            fresh = all(again[k] == runs[1][k] for k in ("centers", "rotations", "pose_ok",
                                                           "n_inliers"))
            if not fresh:
                _segment_faults.append(f"{path}: window {w['start']} in a fresh host loop is "
                                       f"not the resumed loop's")
        out_w = []
        for w, got in zip(rec["windows"], runs):
            cmp = segs.compare_window(w["jax"], got, w["start"], w["anchor"]["centers"])
            lost = not all(w["jax"]["pose_ok"])
            bound = bound_lost if lost else bound_kept
            cmp.update(window=[w["start"], w["end"]], crosses_loss_of_track=lost,
                       bound_distance_m=bound, frames_per_s=(w["end"] - w["start"]) / got["seconds"])
            out_w.append(cmp)
            if (bound is None or cmp.get("distance_m_max", np.inf) > bound
                    or cmp["entries"] != len(w["jax"]["pose_ok"])
                    or (not lost and cmp["pose_ok_equal_share"] < 1.0)):
                _segment_faults.append(f"{path} window {w['start']}: {cmp}")
        out = {"windows": out_w, "launches": launches, "launches_floor": floor,
               "frames_equal_reference": frames_sha256(fr) == rec["frames_sha256"],
               "fresh_host_loop_equal": fresh}
        _say(f"[segments:{path}] " + json.dumps(out))
        if launches < floor:
            raise AssertionError(f"[segments:{path}] extract_blocks launched {launches} "
                                 f"times, < {floor}")
        counted["segments_" + os.path.basename(seg_dir).replace("-", "_")] = (launches, floor)
    _say(f"[segments] phase seconds {time.perf_counter() - t_phase:.1f}")
    return counted


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
        _cli_lockstep(tag, out_dir, summary, ds, N)
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


def _cli_lockstep(path: str, out_dir: str, summary: dict, ds, n: int) -> dict:
    """``lockstep_check`` of a CLI run: its ``trajectory.npz`` positions and the pose_ok
    and inliers of its ``metrics.jsonl`` rows (-1 for a held row), the frames' hash over
    the ``n`` frames the dataset ``ds`` decodes."""
    centers = np.load(os.path.join(out_dir, "trajectory.npz"))["positions"]
    with open(os.path.join(out_dir, "metrics.jsonl")) as fh:
        rows = [r for r in (json.loads(line) for line in fh if line.strip()) if "pose_ok" in r]
    sha = frames_sha256(np.stack([ds.frame(i) for i in range(n)]))
    return lockstep_check(path, centers, [r["pose_ok"] for r in rows],
                          [-1 if r.get("inliers") is None else r["inliers"] for r in rows],
                          summary["ate_rmse_m"], sha)


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
    from lcvo_tpu_torch.utils.segments import replay_config

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
    fr = np.stack([ds.frame(i) for i in range(REPLAY_FRAMES)])
    _keep_segment_inputs(tag, replay_config(cfg_path, TURN_SEED, *fr.shape[1:],
                                            ds.bootstrap_pair[1]), ds.K, fr)

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
    _cli_lockstep(tag, out_a, summary, ds, N)
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
    share, device ops (kernels and copies), ``lcvo.*`` stage spans, top kernels."""
    from torch.autograd import DeviceType

    events = prof.events()
    # device activity: kernels and copies (the program's spans are host ranges only)
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            busy += (cur_e - cur_s) if cur_e is not None else 0.0
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += (cur_e - cur_s) if cur_e is not None else 0.0
    by_kernel: dict = {}
    for e in dev_events:
        d = by_kernel.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    stages: dict = {}
    for e in events:
        if e.name.startswith("lcvo."):
            d = stages.setdefault(f"{e.name} host", [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.elapsed_us()
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    summary = {
        "frames": n, "wall_ms_per_frame": wall_us / n / 1e3,
        "device_busy_ms_per_frame": busy / n / 1e3, "device_idle_share": 1 - busy / wall_us,
        "device_ops_per_frame": len(dev_events) / n,
        "stage_span_ms_per_frame": {k: v[1] / n / 1e3 for k, v in sorted(stages.items())},
        "top_kernels_ms_per_frame": [[k, v[0] / n, v[1] / n / 1e3] for k, v in top],
    }
    return summary


def profile_chunk(vo, frames, out_dir: str, fname: str) -> None:
    """One more chunk of the main path under ``torch.profiler``, eager
    (``disable_graphs()``: a replay records no stage spans): the host span of each
    ``lcvo.*`` stage, device busy share, launches and the kernels with the most device
    time. Then one chunk of the replayed graphs: device busy, idle share and device ops
    per frame (``graphed``). Writes the summary to ``out_dir``. The
    profiler's own cost inflates the wall time; the shares are what it is for."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lcvo_tpu_torch.utils import jax_random
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    chunk_fn = vo.make_chunk_step(CHUNK)
    batch = torch.from_numpy(frames).to(vo.device)
    n = frames.shape[0]

    def keys():
        return jax_random.split(vo._next_key(), n)

    with disable_graphs():     # eager: the carry is not donated, the state stays
        carry, _ = chunk_fn(vo.chunk_carry(), batch, keys(), frame_idx=vo._frame_idx)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry, outs = chunk_fn(carry, batch, keys(), frame_idx=vo._frame_idx + n)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    summary = _profile_summary(prof, wall_us, n)
    # the graphed chunk, its graphs captured by the run before
    vo.set_chunk_carry(chunk_fn(vo.chunk_carry(), batch, keys(), frame_idx=vo._frame_idx)[0], n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
        t0 = time.perf_counter()
        carry, _ = chunk_fn(vo.chunk_carry(), batch, keys(), frame_idx=vo._frame_idx)
        torch.cuda.synchronize()
        gwall_us = (time.perf_counter() - t0) * 1e6
    vo.set_chunk_carry(carry, n)
    graphed = _profile_summary(gprof, gwall_us, n)
    summary["graphed"] = {k: graphed[k] for k in (
        "wall_ms_per_frame", "device_busy_ms_per_frame", "device_idle_share",
        "device_ops_per_frame", "top_kernels_ms_per_frame")}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, fname), "w") as fh:
        json.dump(summary, fh, indent=1)
    # the headline numbers on one short line; the top kernels only in the file
    line = {k: v for k, v in summary.items() if k != "top_kernels_ms_per_frame"}
    line["graphed"] = {k: v for k, v in summary["graphed"].items()
                       if k != "top_kernels_ms_per_frame"}
    _say(f"[profile] {fname} " + json.dumps(line))


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
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    dev = torch.device("cuda")
    gap = cfg.bootstrap.frame_gap
    n_chunks = STREAMS_CHUNKS
    klt_levels = cfg.klt.track_levels or cfg.klt.levels
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

    def chunks(S, graphed: bool):
        """The n_chunks chunks at S streams from the stacked bootstraps, the streams' keys
        made as the JAX package's callers make them (``split(PRNGKey(cfg.seed), S)``,
        each chain split per chunk): per-chunk poses, pose_ok and inliers on the host,
        chunk end times, the final carry and the chains where they stand."""
        carry = ps.stack_streams([vo.chunk_carry() for vo in vos[:S]])
        chains = ps.stream_keys(cfg.seed, S)
        Rs, ts, oks, ninls, ends = [], [], [], [], []
        torch.cuda.synchronize()
        with contextlib.nullcontext() if graphed else disable_graphs():
            for k in range(n_chunks):
                fr = batch[None, k * CHUNK:(k + 1) * CHUNK].expand(S, -1, -1, -1)
                chains, keys = ps.chunk_keys(chains, CHUNK)
                carry, (R, t, ok, ninl) = step(carry, fr, keys, frame_idx=k * CHUNK)
                packed = torch.cat([R.reshape(S, CHUNK, 9), t, ok[..., None].float(),
                                    ninl[..., None].float()], -1).cpu().numpy()
                ends.append(time.perf_counter())
                Rs.append(packed[..., :9].reshape(S, CHUNK, 3, 3))
                ts.append(packed[..., 9:12])
                oks.append(packed[..., 12] > 0.5)
                ninls.append(packed[..., 13])
        return Rs, ts, oks, ninls, ends, carry, chains

    for S in STREAMS:
        kernels.reset_launches()
        Rs, ts, oks, ninls, ends, carry, chains = chunks(S, graphed=True)
        launches = dict(kernels.LAUNCHES)
        final = _bits(carry)
        eRs, ets, eoks, eninls, eends, ecarry, _ = chunks(S, graphed=False)
        graph_eq = (all(np.array_equal(a, b) for x, y in ((Rs, eRs), (ts, ets), (oks, eoks),
                                                           (ninls, eninls))
                        for a, b in zip(x, y))
                    and _same_bits(final, _bits(ecarry)))
        del ecarry
        if launches["extract_blocks_layered"] < 1 or launches["extract_blocks"] != 0:
            raise AssertionError(f"[streams] S={S}: launches {launches}: the batched path must "
                                 f"go through the layered entry only")
        launches_per_step[S] = launches["extract_blocks_layered"] / (n_chunks * CHUNK)
        if launches["p3p"] != n_chunks * CHUNK:
            raise AssertionError(f"[streams] S={S}: the P3P kernel launched {launches['p3p']} "
                                 f"times in {n_chunks * CHUNK} batched steps: one a step")
        if launches["klt_iterate"] != klt_levels * n_chunks * CHUNK:
            raise AssertionError(f"[streams] S={S}: klt_iterate launched "
                                 f"{launches['klt_iterate']} times in {n_chunks * CHUNK} "
                                 f"batched steps: one a tracked level a step")
        R0, t0 = vos[0]._host_pose()
        centers = np.concatenate([np.repeat(_stream_poses(R0, t0)[None, None], S, 0),
                                  _stream_poses(np.concatenate(Rs, 1), np.concatenate(ts, 1))], 1)
        ok_rate = np.concatenate([np.ones((S, 1), bool), np.concatenate(oks, 1)], 1).mean(1)
        ates = [float(ate_rmse(centers[s], gt)) for s in range(S)]
        if S == 1:
            lockstep_check("streams:S1", centers[0, 1:], np.concatenate(oks, 1)[0],
                           np.concatenate(ninls, 1)[0], ates[0],
                           frames_sha256(frames[: gap + 1 + n_chunks * CHUNK]))
        if S == S_max:
            run_max = {"vos": vos, "batch": batch, "R": np.concatenate(Rs, 1),
                       "t": np.concatenate(ts, 1), "pose_ok": np.concatenate(oks, 1)}
        row = {"aggregate_fps": S * CHUNK * (n_chunks - 1) / (ends[-1] - ends[0]),
               "fps_per_stream": CHUNK * (n_chunks - 1) / (ends[-1] - ends[0]),
               "aggregate_fps_eager": S * CHUNK * (n_chunks - 1) / (eends[-1] - eends[0]),
               "graphed_equals_eager": graph_eq,
               "launches": launches["extract_blocks_layered"],
               "launches_per_batched_step": launches_per_step[S],
               "p3p_launches": launches["p3p"],
               "klt_iterate_launches": launches["klt_iterate"],
               "ate_m": ates, "pose_ok_rate": ok_rate.tolist()}
        if not graph_eq:
            raise AssertionError(f"[streams] S={S}: the graphed chunks left the eager ones: {row}")
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
            keys = ps.chunk_keys(chains, CHUNK)[1]
            syncs = _host_syncs(lambda: step(carry, nxt, keys, frame_idx=fidx))
            if syncs:
                raise AssertionError(f"[streams] S={S}: the batched chunk waits for the device at {syncs}")
            row["host_syncs_in_a_chunk_with_keyframes"] = 0
            if profile_dir:
                # the replayed chunk, then the same chunk eager (stage spans, ops)
                for name, ctx in (("profile", contextlib.nullcontext),
                                  ("profile_eager", disable_graphs)):
                    torch.cuda.synchronize()
                    with ctx(), profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA]) as prof:
                        t0p = time.perf_counter()
                        step(carry, nxt, keys, frame_idx=fidx)
                        torch.cuda.synchronize()
                        wall_us = (time.perf_counter() - t0p) * 1e6
                    summary = _profile_summary(prof, wall_us, CHUNK)
                    summary["device_ops_per_frame_per_stream"] = summary["device_ops_per_frame"] / S
                    os.makedirs(profile_dir, exist_ok=True)
                    with open(os.path.join(profile_dir, f"streams_S{S}_{name}.json"), "w") as fh:
                        json.dump(summary, fh, indent=1)
                    row[name] = {k: v for k, v in summary.items()
                                 if k not in ("top_kernels_ms_per_frame", "stage_span_ms_per_frame")}
        out["by_streams"][str(S)] = row
        _say(f"[streams] S={S} " + json.dumps(row))
    if len(set(launches_per_step.values())) != 1:
        raise AssertionError(f"[streams] extraction launches per batched step grow with S: "
                             f"{launches_per_step}")

    # stream 0 at S = 4 against S = 1 and against the unbatched chunk_fn on the first
    # chunk, the same keys (stream 0's are its own at every S); stream k sees the frames
    # k on. The control: the same S = 4 run with stream 0 given stream 1's frames, read
    # by the same check, shows what the check reads when a stream reads another's data
    from lcvo_tpu_torch.pipeline import make_chunk_fn

    samples = ps.chunk_keys(ps.stream_keys(7, 4), CHUNK)[1]
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

    from lcvo_tpu_torch.frontend.match import (compiled_matcher, knn_match_ratio,
                                               knn_match_ratio_sharded)
    from lcvo_tpu_torch.parallel.mesh import make_mesh
    from lcvo_tpu_torch.solve.ba.schur import BAProblem, ba_solve
    from lcvo_tpu_torch.solve.ba.sharded import ba_solve_sharded, compiled_solver

    src, out = argv
    d = np.load(src)
    mesh = make_mesh(dist.get_world_size(), device_type=dev.type)
    prob = BAProblem(*(torch.from_numpy(d[k]).to(dev) for k in ("R", "t", "X", "obs", "mask")))
    kw = {k: d[f"kw_{k}"].item() for k in ("iters", "n_fix", "huber", "lam0")}
    got = {}
    for tag, res in (("sharded", ba_solve_sharded(prob, mesh, **kw)), ("one", ba_solve(prob, **kw))):
        for f in res._fields:
            got[f"{tag}_{f}"] = getattr(res, f).cpu().numpy()
    got["ba_replayed"] = np.array(compiled_solver(mesh, **kw).replayed)
    q, vq, t, vt = (torch.from_numpy(d[k]).to(dev) for k in ("dq", "vq", "dt", "vt"))
    for tag, (idx, ok) in (("sharded", knn_match_ratio_sharded(mesh, q, vq, t, vt)),
                           ("one", knn_match_ratio(q, vq, t, vt))):
        got[f"{tag}_idx"], got[f"{tag}_ok"] = idx.cpu().numpy(), ok.cpu().numpy()
    got["match_replayed"] = np.array(compiled_matcher(mesh).replayed)
    np.savez(f"{out}_rank{dist.get_rank()}.npz", **got)


def _eager(fn):
    """``fn()`` with every compiled step eager."""
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    with disable_graphs():
        return fn()


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
    replayed = any(bool(r["ba_replayed"]) or bool(r["match_replayed"]) for r in ranks)
    two.update({"ba_vs_ba_solve": err, "ba_line": BA_LINE, "ba_same_on_every_rank": same,
                "match_equal": match_ok, "replayed": replayed})
    if bad or not same or not match_ok or replayed:
        raise AssertionError(f"[dist] {DIST_RANKS} gloo ranks: {two}")
    return two


def _graphed_vs_eager(call, compiled, reps: int = 5) -> dict:
    """A compiled sharded call at a world of one NCCL rank: ``call()`` replayed (its
    graph captured at an earlier call) against ``call()`` under ``disable_graphs()``,
    bit for bit; whether it replayed; the host syncs inside a replay; its graph's nodes,
    capture and instantiation seconds; ms per call each way (host clock around ``reps``
    calls fenced by ``synchronize``, in turns graphed, eager, eager, graphed, medians);
    and the host ms per replay (``reps`` back-to-back replays that nothing waits for)."""
    import torch

    from lcvo_tpu_torch.utils.graphs import disable_graphs

    call()
    graphed = _bits(call())
    replayed = compiled.replayed
    with disable_graphs():
        eager = _bits(call())
    out = {"graphed_equal_eager": _same_bits(graphed, eager), "replayed": replayed,
           "syncs_in_replay": _host_syncs(call)}
    (g,) = compiled.stats()
    out.update({k: g[k] for k in ("nodes", "warmup_s", "capture_s", "instantiate_s")})
    times = {"graphed": [], "eager": []}
    for _ in range(3):
        for mode in ("graphed", "eager", "eager", "graphed"):
            with disable_graphs() if mode == "eager" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    out.update({"ms_graphed": statistics.median(times["graphed"]),
                "ms_eager": statistics.median(times["eager"]), "host_ms_per_replay": host})
    if not (out["graphed_equal_eager"] and replayed and not out["syncs_in_replay"]):
        raise AssertionError(f"[dist] a compiled sharded call at a world of one: {out}")
    return out


def _world_of_one_solvers(mesh, dev, scene: dict, match: dict, kw: dict) -> dict:
    """At one rank: the sharded BA equal to ``ba_solve`` and the sharded matcher equal to
    ``knn_match_ratio``, exactly; the BA with no host sync, its time beside ``ba_solve``'s
    (host clock, in turns) and the operators each dispatches. Both sharded calls are
    CUDA graphs with their NCCL collectives: each held to its eager run
    (:func:`_graphed_vs_eager`)."""
    import torch
    import torch.distributed as dist

    from lcvo_tpu_torch.frontend.match import (compiled_matcher, knn_match_ratio,
                                               knn_match_ratio_sharded)
    from lcvo_tpu_torch.parallel.mesh import capturable
    from lcvo_tpu_torch.solve.ba.schur import BAProblem, ba_solve
    from lcvo_tpu_torch.solve.ba.sharded import ba_solve_sharded, compiled_solver

    one = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh_shape": mesh.shape, "group_size": dist.get_world_size(mesh.group("data"))}
    one["capturable"] = capturable(mesh, "data")
    if one["backend"] != "nccl" or one["group_size"] != 1 or not one["capturable"]:
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
    # ba_sharded_ms is the eager sharded solve beside the eager ba_solve;
    # the graphed one is ba_sharded_graph's ms_graphed
    timed = {"one": solvers["one"], "sharded": lambda: _eager(solvers["sharded"])}
    times = {"one": [], "sharded": []}
    for _ in range(3):
        for tag in ("one", "sharded", "sharded", "one"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                timed[tag]()
            torch.cuda.synchronize()
            times[tag].append((time.perf_counter() - t0) / 5 * 1e3)
    one.update({"ba": f"W={DIST_W} K={DIST_K} iters={kw['iters']}", "ba_equal_to_ba_solve": True,
                "ba_cost0": float(a.cost0), "ba_cost": float(a.cost), "ba_host_syncs": 0,
                "ba_sharded_ms": statistics.median(times["sharded"]),
                "ba_solve_ms": statistics.median(times["one"]),
                "ba_sharded_ops": _dispatched_ops(lambda: _eager(solvers["sharded"])),
                "ba_solve_ops": _dispatched_ops(solvers["one"]),
                "ba_sharded_graph": _graphed_vs_eager(solvers["sharded"], compiled_solver(mesh, **kw))})
    q, vq, tq, vt = (torch.from_numpy(match[k]).to(dev) for k in ("dq", "vq", "dt", "vt"))
    (i1, o1), (i2, o2) = knn_match_ratio_sharded(mesh, q, vq, tq, vt), knn_match_ratio(q, vq, tq, vt)
    if not (torch.equal(i1, i2) and torch.equal(o1, o2)):
        raise AssertionError("[dist] world of one: knn_match_ratio_sharded differs from knn_match_ratio")
    one.update({"match": "x".join(map(str, DIST_MATCH)), "match_equal": True,
                "match_ok": int(o1.sum()),
                "match_sharded_graph": _graphed_vs_eager(
                    lambda: knn_match_ratio_sharded(mesh, q, vq, tq, vt), compiled_matcher(mesh))})
    return one


def _world_of_one_streams(cfg, seq, run_max: dict, mesh, dev) -> dict:
    """At one rank: the streams chunk step through the mesh, from the same carry and seed
    as the S = 8 run of ``[streams]``, equal to it exactly, with its layered launches;
    then the mesh ``make_multistream_step`` (its ``agg`` summed inside its graph) held to
    its eager run (:func:`_graphed_vs_eager`)."""
    import torch

    from lcvo_tpu_torch import kernels
    from lcvo_tpu_torch.parallel import streams as ps
    from lcvo_tpu_torch.parallel.mesh import shard_batched_state
    from lcvo_tpu_torch.utils.graphs import place

    vos, batch = run_max["vos"], run_max["batch"]
    S = len(vos)
    step = ps.make_multistream_chunk_step(cfg, seq.K, mesh=mesh, device="cuda")
    carry = shard_batched_state(ps.stack_streams([vo.chunk_carry() for vo in vos]), mesh)
    chains = ps.stream_keys(cfg.seed, S)
    got = {"R": [], "t": [], "pose_ok": []}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for k in range(STREAMS_CHUNKS):
        fr = shard_batched_state(batch[None, k * CHUNK:(k + 1) * CHUNK].expand(S, -1, -1, -1), mesh)
        chains, keys = ps.chunk_keys(chains, CHUNK)
        keys = shard_batched_state(torch.from_numpy(keys.astype(np.int64)), mesh)
        carry, (R, t, ok, _) = step(carry, fr, keys, frame_idx=k * CHUNK)
        for name, x in (("R", R), ("t", t), ("pose_ok", ok)):
            got[name].append(x.cpu().numpy())
    launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    differ = [n for n in got if not np.array_equal(np.concatenate(got[n], 1), run_max[n])]
    if differ:
        raise AssertionError(f"[dist] the streams chunk step through the mesh differs from the "
                             f"batched chunk step in {differ}")
    steps = STREAMS_CHUNKS * CHUNK
    klt_levels = cfg.klt.track_levels or cfg.klt.levels
    if (launches["extract_blocks"] != 0 or launches["extract_blocks_layered"] != 12 * steps
            or launches["p3p"] != steps or launches["klt_iterate"] != klt_levels * steps):
        raise AssertionError(f"[dist] streams through the mesh launched {launches}")
    # the mesh step, its sum over ranks inside the graph on NCCL: from the streams'
    # states, one frame, the same keys at each call (the state copied in: the step
    # donates it)
    mstep = ps.make_multistream_step(cfg, seq.K, mesh=mesh, device="cuda")
    states = shard_batched_state(ps.stack_streams([vo.state for vo in vos]), mesh)
    image = shard_batched_state(batch[None, 0].expand(S, -1, -1), mesh)
    step_keys = shard_batched_state(
        torch.from_numpy(ps.stream_keys(cfg.seed, S).astype(np.int64)), mesh)

    def call():
        return mstep(place(None, states), image, step_keys)

    graph = _graphed_vs_eager(call, mstep.compiled)
    if not mstep.sum_in_graph:
        raise AssertionError("[dist] the mesh step on NCCL sums its agg outside its graph")
    _, res, agg = call()
    return {"streams": f"S={S} chunks={STREAMS_CHUNKS}x{CHUNK}", "streams_equal_to_batched": True,
            "streams_layered_launches": launches["extract_blocks_layered"],
            "streams_p3p_launches": launches["p3p"],
            "streams_klt_iterate_launches": launches["klt_iterate"],
            "mesh_step_sum_in_graph": True, "mesh_step_agg": {k: int(v) for k, v in agg.items()},
            "mesh_step_pose_ok": int(res.pose_ok.sum()), "mesh_step_graph": graph}


def dist_phase(cfg, seq, run_max: dict) -> dict:
    """``[dist]``: the NCCL probe; a world of one NCCL rank in this process (sharded BA =
    ``ba_solve`` and sharded matcher = ``knn_match_ratio`` exactly, the BA with no host
    sync and its time beside ``ba_solve``'s, the streams chunk step through the mesh =
    the S = 8 run of ``[streams]`` exactly, with its layered launches; the sharded BA,
    matcher and mesh step replayed as graphs = eager bit for bit); then
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
        out["streams_mesh_p3p_launches"] = one["streams_p3p_launches"]
        out["streams_mesh_klt_iterate_launches"] = one["streams_klt_iterate_launches"]
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
    t_script = time.perf_counter()
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
    srow = svd_phase(cfg, ref_cfg, seq, frames)
    prow = p3p_phase(cfg, turn_cfg, seq, frames)
    krow = klt_phase(cfg, ref_cfg, turn_cfg, seq, frames)
    runs = {}      # each main path's graphed run, for [graphs]
    # default path: every frame pair goes through the tracker (6 launches), bootstrap
    # hops included. Reference path: 6 KLT + 6 SIFT launches per step, and the SIFT
    # bootstrap describes its two endpoint frames (12 launches, no KLT hops).
    main, _, runs["default"] = main_path_phase("main", cfg, seq, frames, ATE_BOUND_M,
                                               6 * (N_FRAMES - 1), args.profile)
    n_steps = N_FRAMES - 1 - ref_cfg.bootstrap.frame_gap
    ref, _, runs["reference"] = main_path_phase("main:reference", ref_cfg, seq, frames,
                                                REF_ATE_BOUND_M, 12 * n_steps + 12, args.profile)
    # BA paths: 6 KLT + 6 SIFT launches per step; the KLT bootstrap tracks frame_gap
    # hops (6 launches each) and describes its last frame for the sift-sift table (6)
    by_path = {"default": main["launches"]["extract_blocks"],
               "reference": ref["launches"]["extract_blocks"]}
    svd_by_path = {"default": main["launches"]["svd"], "reference": ref["launches"]["svd"]}
    p3p_by_path = {"default": main["launches"]["p3p"], "reference": ref["launches"]["p3p"]}
    klt_by_path = {"default": main["launches"]["klt_iterate"],
                   "reference": ref["launches"]["klt_iterate"]}
    floors = {"default": main["min_launches"], "reference": ref["min_launches"]}
    poses = {}
    for tag, c, bound in (("throughput", thr_cfg, THR_ATE_BOUND_M),
                          ("turn_robust", turn_cfg, TURN_ATE_BOUND_M)):
        gap = c.bootstrap.frame_gap
        out, poses[tag], runs[tag] = main_path_phase(
            f"main:{tag}", c, seq, frames, bound, 12 * (BA_FRAMES - 1 - gap) + 6 * gap + 6,
            args.profile, n_frames=BA_FRAMES)
        by_path[tag] = out["launches"]["extract_blocks"]
        svd_by_path[tag] = out["launches"]["svd"]
        p3p_by_path[tag] = out["launches"]["p3p"]
        klt_by_path[tag] = out["launches"]["klt_iterate"]
        floors[tag] = out["min_launches"]
        rate_without_ba(f"main:{tag}:ba_off", c, seq, frames, BA_FRAMES)
    # [graphs]: each path's graphed run against its eager run, exactly
    for tag, c, n in (("default", cfg, N_FRAMES), ("reference", ref_cfg, N_FRAMES),
                      ("throughput", thr_cfg, BA_FRAMES), ("turn_robust", turn_cfg, BA_FRAMES)):
        graphs_phase(tag, c, seq, frames, n, runs.pop(tag))
    graphs_run_phase(cfg, seq, frames)
    graphed_chunk_syncs("default", cfg, seq, frames, N_FRAMES)
    graphed_chunk_syncs("turn_robust", turn_cfg, seq, frames, BA_FRAMES)
    for tag, c in (("default", cfg), ("reference", ref_cfg), ("throughput", thr_cfg),
                   ("turn_robust", turn_cfg),
                   ("sift-mask", load_config(overrides=mode_overrides("sift-mask")))):
        bootstrap_phase(tag, c, seq, frames)
    checkpoint_phase("checkpoint:turn_robust", turn_cfg, seq, frames, BA_FRAMES,
                     poses["turn_robust"])
    for mode, n_frames, jax_ate in MODES:
        c = load_config(overrides=mode_overrides(mode))
        _keep_segment_inputs(mode, c, seq.K, frames[:n_frames])
        out, _, _ = main_path_phase(f"main:{mode}", c, seq, frames, LOCKSTEP_ATE_FACTOR * jax_ate,
                                    _launch_floor(c, n_frames - 1 - c.bootstrap.frame_gap, 1),
                                    args.profile, n_frames=n_frames)
        path = mode.replace("-", "_").replace("+", "_")
        by_path[path], floors[path] = out["launches"]["extract_blocks"], out["min_launches"]
        svd_by_path[path] = out["launches"]["svd"]
        p3p_by_path[path] = out["launches"]["p3p"]
        klt_by_path[path] = out["launches"]["klt_iterate"]
    counted = {**recovery_phase(cfg, turn_cfg, seq, frames), **stress_phase(cfg),
               "longhorizon": longhorizon_phase(cfg)}
    render_phase(smi)
    replay, by_path["replay_kitti_turn"] = replay_phase(root, smi)
    floors["replay_kitti_turn"] = replay["launches_formula"]
    for dataset, jax_ate in REPLAY_LAYOUT_JAX_CPU_ATE_M.items():
        counted[f"replay_{dataset}"] = replay_layout_phase(root, dataset, jax_ate)
    counted.update(segments_phase())
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
    srow["launches"] = sum(svd_by_path.values())
    srow["launches_by_path"] = svd_by_path
    skeys = keys[:12] + ("ms_by_site", "library_ms_by_site", "bound_ms_by_site")
    p3p_by_path.update({f"streams_S{S}": r["p3p_launches"] for S, r in st["by_streams"].items()})
    p3p_by_path[f"streams_mesh_S{max(STREAMS)}"] = dst["streams_mesh_p3p_launches"]
    prow["launches"] = sum(p3p_by_path.values())
    prow["launches_by_path"] = p3p_by_path
    pkeys = keys[:12] + ("ms_8x512", "plain_ms_8x512")
    klt_by_path.update({f"streams_S{S}": r["klt_iterate_launches"]
                        for S, r in st["by_streams"].items()})
    klt_by_path[f"streams_mesh_S{max(STREAMS)}"] = dst["streams_mesh_klt_iterate_launches"]
    krow["launches"] = sum(klt_by_path.values())
    krow["launches_by_path"] = klt_by_path
    kkeys = keys[:12] + ("ms_window_21", "plain_ms_window_21")
    if _lockstep_faults or _segment_faults:
        raise AssertionError("[lockstep] bounds missed: " + "; ".join(_lockstep_faults)
                             + " [segments] " + "; ".join(_segment_faults))
    _say(f"[wall] chip_smoke.py: {time.perf_counter() - t_script:.1f} s from the device check "
         f"to the kernel line")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}, {k: lrow[k] for k in lkeys},
                                  {k: srow[k] for k in skeys}, {k: prow[k] for k in pkeys},
                                  {k: krow[k] for k in kkeys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

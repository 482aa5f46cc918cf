"""Typed configuration tree for the VO framework.

The reference keeps its knobs in a flat ``config.yaml`` loaded into a module global at
import time (reference ``src/vo_pipeline.py:11-17``) with many de-facto config values
hard-coded inline (reprojection threshold 2 px at ``src/vo_pipeline.py:238``, Lowe ratio
0.8 at ``:113``, essential-RANSAC (0.999, 1.0 px) at ``:156``, detector params at
``:86-87,382``, re-bootstrap skip=4 at ``:288``). Here every one of those becomes a named
field with the reference value as default, in one explicit, injected dataclass tree —
no ambient module globals.

All capacity fields (``max_tracks`` etc.) are fixed table shapes.

This is the PyTorch port's own copy of ``lcvo_tpu/config.py``, field for field, so
that ``configs/*.yaml`` loads into both packages. The port keeps a copy instead of
importing it because importing anything under ``lcvo_tpu`` initialises JAX.
Comments that cite TPU measurements describe the JAX package's history, not the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DetectorConfig:
    """Corner/blob detection. Reference: ``cv2.goodFeaturesToTrack`` params at
    ``src/vo_pipeline.py:86-87,382`` and SIFT usage at ``:95-104,417-444``."""

    method: str = "shi"            # 'shi' | 'harris' | 'sift'
    max_corners: int = 1024        # cap on corners returned per detection call
    #   (reference: 600 init / 500 per-frame, :86/:382; here the default matches
    #    the table capacities so capacity fields govern unless the user lowers it)
    quality_level: float = 0.03    # reference :86-87
    min_distance: int = 10         # reference :86-87 (NMS radius, px)
    # Grid-cell NMS (static-shape replacement for OpenCV's sorted greedy NMS):
    grid_cells_x: int = 32
    grid_cells_y: int = 12
    cells_topk: int = 4            # keypoints kept per cell
    harris_k: float = 0.04
    window: int = 3                # structure-tensor box window radius
    # SIFT-class detector:
    sift_octaves: int = 3
    sift_scales_per_octave: int = 3
    sift_contrast_thresh: float = 0.04
    sift_edge_thresh: float = 10.0


@dataclass(frozen=True)
class DescriptorConfig:
    """Descriptor extraction + matching. Reference: SIFT 128-d + BF knn with Lowe ratio
    0.8 (``src/vo_pipeline.py:102-114,443-450``)."""

    method: str = "sift"           # 'sift' | 'patch'
    ratio_thresh: float = 0.8      # Lowe ratio, reference :113,:450
    patch_size: int = 16
    max_keypoints: int = 1024      # static descriptor-table capacity


@dataclass(frozen=True)
class KLTConfig:
    """Pyramidal Lucas-Kanade tracking. Reference: ``cv2.calcOpticalFlowPyrLK`` with
    default params — 21x21 window, 3 levels, 30 iters / 0.01 eps
    (``src/vo_pipeline.py:215,501``). Our tuned defaults (15x15, 6 iters) track within
    ~0.1 px median of OpenCV's 21x21/30 on textured frames and measured *better*
    end-to-end ATE, at ~1.8x the frame rate; set window=21, iters=10 for the
    reference-matched operating point."""

    window: int = 15               # odd; patch is window x window
    levels: int = 3                # pyramid levels (level 0 = full res)
    iters: int = 6                 # fixed iteration count (no data-dependent exit)
    eps: float = 0.01              # convergence epsilon: per-track updates smaller
    #                                than this (level px) freeze — OpenCV's criteria
    #                                eps as a mask instead of an early exit
    max_residual: float = 12.0     # mean |I_t - I_{t+1}| over patch to keep a track
    max_displacement: float = 60.0 # tracks moving further than this are dropped
    border: int = 12               # tracks within this many px of border are dropped
    margin: int = 6                # per-level block wander margin (px) for KLT calls
    #                                WITHOUT a motion prior (bootstrap hops start
    #                                from zero displacement; reach ≈ margin*(4+2+1)
    #                                px at 3 levels must cover raw frame-to-frame
    #                                flow). Round-4 negative result: raising to 8
    #                                (56 px reach, to help in-turn re-bootstraps
    #                                against ~50 px edge flow) degraded the
    #                                311-frame turn smoke at ALL three seeds
    #                                (1.3/1.8/1.9 → 7.1/9.4/3.9 m ATE) and was
    #                                neutral at full scale — the wider wander
    #                                admits ambiguous-texture matches into the
    #                                bootstrap map. 6 is the validated point.
    track_margin: int = 6          # wander margin for the in-pipeline tracker, where
    #                                the constant-velocity warm start (process_frame)
    #                                absorbs the bulk displacement — the margin only
    #                                covers prediction error. Round 5 raised the
    #                                default 4 -> 6: at a turn ENTRY/EXIT the
    #                                velocity model mispredicts by one frame's
    #                                yaw step (25-43 px at KITTI focal), and at
    #                                margin 4 that wiped ~85% of the track table
    #                                in one frame (the event that seeded every
    #                                turn-replay scale collapse). LK's per-level
    #                                convergence basin makes the FINE margins the
    #                                binding reach constraint (CPU probe:
    #                                wrong-prior survival 0.44 at (4,4,8) vs
    #                                0.83 at (6,6,8)); r4 priced m6 at -0.7% fps.
    track_margin_coarse: int = 8   # wander margin at the COARSEST tracked level
    #                                (0 = same as track_margin). Correction reach
    #                                is ~margin·2^level full-res px, so the
    #                                coarsest level buys reach cheapest. 8 at
    #                                level 2 -> ~44 px total reach: covers the
    #                                constant-velocity model's worst transient
    #                                (turn entry/exit, yaw stepping 0↔2°/frame =
    #                                25-43 px prediction error at KITTI focal) —
    #                                without it the turn-exit frame kills ~85% of
    #                                the track table in one step and reseeds the
    #                                scale-decay spiral (round-5 microscope,
    #                                BASELINE.md)
    track_levels: int = 0          # pyramid levels used by the IN-PIPELINE tracker
    #                                (0 = all `levels`). With the constant-velocity
    #                                warm start the coarse levels only correct the
    #                                small prediction error — dropping them removes
    #                                whole per-level iteration loops from the
    #                                latency-chained hot path (VERDICT r4 #3).
    #                                Bootstrap hops (zero-start) always use all
    #                                `levels` for full displacement reach.
    iters_coarse: int = 2          # LK iterations at levels > 0 (0 = same as
    #                                `iters`). A coarse level only needs to land
    #                                the displacement within the next level's
    #                                wander margin, not converge — fewer coarse
    #                                iterations cut the latency-bound per-level
    #                                loops (the r4 trace: 3 x 1.09 ms at 70 GB/s).
    #                                Default 2 since round 5: sift-sift 119 ->
    #                                142.9 fps with the 3-seed turn band at
    #                                1.27/0.97/0.22 m — inside the round-4
    #                                1.28/1.81/1.88 envelope (the VERDICT r4 #3
    #                                acceptance bar). The quality-flagship
    #                                preset (configs/turn_robust.yaml) pins 0
    #                                (full coarse convergence: its band is
    #                                0.29/0.29/0.36). track_levels=2 was
    #                                REJECTED decisively (correction reach 22 px
    #                                < turn transients; pose_ok 66-80%).
    iter_dtype: str = "float32"    # storage dtype of the LK iteration loop's
    #                                re-read tensors (blocks/template/gradients).
    #                                'bfloat16' halves the tracker's dominant HBM
    #                                stream and buys +6% fps (sweep_klt_r4), with
    #                                sub-0.01 px single-pair deltas (test_ops.py)
    #                                — but the round-4 turn-rich quality gate
    #                                REJECTED it as the default: through 90°
    #                                corners (full map turnover under rotation)
    #                                the compounded tracking noise drives
    #                                arena-loop ATE 1.28 → 9.17 m (BASELINE.md
    #                                round 4). f32 stays the default; bf16 is a
    #                                deliberate per-deployment trade for
    #                                turn-light trajectories.


@dataclass(frozen=True)
class RansacConfig:
    """Hypothesis-scoring RANSAC, fixed hypothesis counts (XLA-static).

    Reference: essential matrix 5-pt RANSAC prob 0.999 / thresh 1.0 px
    (``src/vo_pipeline.py:156``); PnP-RANSAC reproj thresh 2 px, confidence 0.99999
    (``:238-243``)."""

    e_hypotheses: int = 512        # essential-matrix hypothesis count
    e_thresh_px: float = 1.0       # Sampson threshold (reference :156)
    # minimal solver for E: "eight_point" (batched DLT) or "five_point" (Nistér,
    # parity with cv2.findEssentialMat's 5-pt; ~10 hypotheses per minimal sample)
    e_solver: str = "eight_point"
    pnp_hypotheses: int = 512      # P3P hypothesis count
    pnp_thresh_px: float = 2.0     # reprojection threshold (reference :238)
    refine_iters: int = 8          # Gauss-Newton pose-polish iterations
    min_pnp_inliers: int = 4       # below this → re-bootstrap (reference :274)


@dataclass(frozen=True)
class TriangulationConfig:
    """Candidate validation + promotion. Reference: bearing angle alpha > 1 deg
    (``config.yaml:21``, ``src/vo_pipeline.py:607-655``). Unlike the reference (which
    thresholds a pixel-space proxy, see SURVEY §2.1), we compute the *true* parallax
    angle through K^-1 and the first/current rotations."""

    alpha_deg: float = 1.0
    max_depth: float = 120.0       # landmarks further than this are rejected.
    #                                Round-4 null result: raising to 300 produced
    #                                a BIT-IDENTICAL 2,760-frame turn replay —
    #                                the α-gate and the depth/baseline-ratio gate
    #                                bind strictly earlier for far points, so
    #                                this cap is a backstop, not an active gate.
    min_depth: float = 1.0
    max_reproj_px: float = 3.0     # post-triangulation reprojection gate on
    #                                promotion. A 1.5 px tightening looked like a
    #                                turn-ATE win at one seed (1.28 → 1.05 m) but
    #                                WIDENED the seed spread (2.93/3.81 vs
    #                                1.81/1.88 at 3.0) — kept at the reference's
    #                                operating point; see diag_turn.py matrix
    max_candidate_age: int = 90    # candidates older than this (frames) are dropped
    max_depth_baseline_ratio: float = 30.0  # reject triangulations with depth >
    #                                ratio x the first-obs↔current baseline: at
    #                                low parallax, linear-triangulation noise is
    #                                biased toward NEAR depths (inverse-depth
    #                                noise), and a map rebuilt from such points
    #                                during rotation-heavy segments leaks metric
    #                                scale (measured: arena-loop seg-scale 2→12
    #                                through 90° corners without this gate).
    #                                30 ≈ a 1.9° effective parallax floor; 0
    #                                disables.
    track_refine: bool = True      # continuous anchor re-triangulation: each
    #                                landmark keeps its first observation (pixel
    #                                + frozen promotion-time pose) and is
    #                                re-triangulated inside the compiled step
    #                                whenever its parallax to that anchor has
    #                                grown by refine_min_improve — a landmark
    #                                promoted at the α-gate's minimum parallax
    #                                improves as the baseline grows instead of
    #                                freezing its noisiest depth estimate (the
    #                                round-5 attack on the turn scale-decay
    #                                spiral, VERDICT r4 #1)
    refine_min_improve: float = 1.15  # re-triangulate when the current parallax
    #                                exceeds the last triangulation's by this
    #                                factor (growth-staggered: tracks refine on
    #                                different frames, so map error never
    #                                correlates with a single frame's pose
    #                                noise). 1.15 since round 5: the denser
    #                                refit ladder cuts the secular scale decay
    #                                of the full turn replay 2.7x (-0.050 →
    #                                -0.018 %/frame, benchmarks/probe_drift.py)
    #                                and improves the 311-frame no-BA band at
    #                                every seed; 1.05 re-couples map error to
    #                                per-frame pose noise (drift back to
    #                                -0.044) — the stagger matters.


@dataclass(frozen=True)
class StateConfig:
    """Fixed capacities of the masked track tables (XLA static shapes)."""

    max_tracks: int = 1024         # landmark tracks: P[K,2], X[K,3]
    max_candidates: int = 1024     # candidate tracks: C/F[M,2] + first pose
    max_new_per_frame: int = 256   # new candidates admitted per frame


@dataclass(frozen=True)
class BAConfig:
    """Sliding-window local bundle adjustment (reference future work, report §3.2;
    BASELINE.json config 3: window=10 keyframes, Schur-complement Gauss-Newton)."""

    enabled: bool = False
    landmarks_only: bool = False   # freeze ALL keyframe poses and refine only
    #                                structure: multi-view depth correction with
    #                                zero pose feedback / gauge motion — the
    #                                round-4 probe of why full window BA trails
    #                                no-BA through turns (see BASELINE.md r4)
    gauge: str = "newest"          # which real keyframes anchor the window's
    #                                7-DoF gauge (incl. monocular scale):
    #                                'oldest' — classic sliding-window anchor;
    #                                through scale-drifting turns it drags the
    #                                NEWEST pose toward the window's old scale,
    #                                and the live-pose write-back then fights
    #                                PnP (the round-4 net-negative, VERDICT r4
    #                                weak #1). 'newest' — freeze the newest
    #                                n_fix keyframes instead: the live pose
    #                                never jumps; BA smooths the PAST and makes
    #                                structure consistent with the current
    #                                pose (backward smoothing). Default since
    #                                round 5: WITH track_refine, the 311-frame
    #                                turn band is 0.29/0.29/0.36 m vs
    #                                0.69/1.02/0.70 no-BA (newest gauge alone —
    #                                without anchors pinning scale — is
    #                                unstable; see BASELINE.md round-5 table).
    window: int = 10               # keyframes in the window
    #   (landmark capacity inside the window is state.max_tracks — the window
    #    refines the live track table in place, solve/ba/window.py)
    gn_iters: int = 5
    damping: float = 1e-4          # initial LM diagonal damping (lam0 of ba_solve)
    huber_px: float = 2.0
    keyframe_every: int = 5        # simple keyframe cadence


@dataclass(frozen=True)
class RuntimeConfig:
    """Mesh / device-runtime knobs."""

    mesh_shape: tuple = ()         # e.g. (2, 4) for ('host','chip'); () = all devices
    #                                on one axis (see parallel.mesh.mesh_from_config)
    mesh_axes: tuple = ("data",)   # mesh axis names; first axis shards streams
    dtype: str = "float32"         # pyramid/KLT compute dtype ('float32'|'bfloat16';
    #                                bf16 halves HBM traffic but costs subpixel
    #                                precision AND forces the KLT block extraction
    #                                onto the slower XLA gather path — Mosaic's
    #                                dynamic rotate is 32-bit only)
    donate_state: bool = True      # donate the state buffer to the compiled step: on
    #                                the card its CUDA graph writes the new state back
    #                                into the state's own buffers, which it returns
    #                                (utils/graphs.py); false returns a copy and leaves
    #                                the caller's state valid. Eager on the CPU
    prefetch_depth: int = 2        # frames in flight host->device


@dataclass(frozen=True)
class BootstrapConfig:
    """Two-view initialization. Reference: bootstrap frame pairs [0,6] KITTI/Malaga,
    [0,4] parking (``src/main.py:27,45,63``); re-bootstrap skips 4 frames
    (``src/vo_pipeline.py:288``)."""

    frame_gap: int = 6
    rebootstrap_skip: int = 4
    min_matches: int = 40
    # 'klt': track corners through the intermediate frames (robust for video);
    # 'sift': descriptor-match the endpoint pair directly — the reference's init
    # (``src/vo_pipeline.py:69-121``: SIFT detect+describe + BF knn + ratio 0.8)
    init_method: str = "klt"


@dataclass(frozen=True)
class VOConfig:
    dataset: str = "synthetic"     # 'kitti' | 'malaga' | 'parking' | 'synthetic'
    data_root: str = "datasets"
    # the three reference candidate-detection modes (``config.yaml:6``):
    find_new_candidates_method: str = "shi-mask"  # 'shi-mask'|'sift-mask'|'sift-sift'
    image_height: int = 376        # KITTI default; static shape of the compiled step
    image_width: int = 1240
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    descriptor: DescriptorConfig = field(default_factory=DescriptorConfig)
    klt: KLTConfig = field(default_factory=KLTConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    triangulation: TriangulationConfig = field(default_factory=TriangulationConfig)
    state: StateConfig = field(default_factory=StateConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    bootstrap: BootstrapConfig = field(default_factory=BootstrapConfig)
    seed: int = 0
    debug: bool = False
    visualization: bool = False
    animation: bool = False


def _update_dataclass(obj: Any, updates: dict) -> Any:
    """Recursively apply a nested dict of overrides to a frozen dataclass tree."""
    kw = {}
    for f in dataclasses.fields(obj):
        if f.name not in updates:
            continue
        v = updates[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[f.name] = _update_dataclass(cur, v)
        else:
            kw[f.name] = tuple(v) if isinstance(cur, tuple) and isinstance(v, list) else v
    unknown = set(updates) - {f.name for f in dataclasses.fields(obj)}
    if unknown:
        raise KeyError(f"unknown config keys for {type(obj).__name__}: {sorted(unknown)}")
    return dataclasses.replace(obj, **kw)


def load_config(path: str | None = None, overrides: dict | None = None) -> VOConfig:
    """Build a :class:`VOConfig`, optionally from a YAML file plus a dict of overrides.

    Unlike the reference's import-time module-global (``src/vo_pipeline.py:11-17``),
    this is explicit and injected: callers pass the config object down the stack.
    """
    cfg = VOConfig()
    if path is not None:
        import yaml

        with open(path) as fh:
            data = yaml.safe_load(fh) or {}
        cfg = _update_dataclass(cfg, data)
    if overrides:
        cfg = _update_dataclass(cfg, overrides)
    return cfg

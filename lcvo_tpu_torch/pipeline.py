"""The Markovian VO state machine: bootstrap + per-frame processing (port of
``lcvo_tpu/pipeline.py``, the default path).

    state_i, result_i = process_frame(state_{i-1}, I_i, u_i)

One frame runs pyramid build → joint KLT over tracks and candidates (the CUDA
block-extraction kernel on the card) → PnP-RANSAC localization → inlier filtering →
anchor re-triangulation → candidate validation, triangulation and promotion →
re-detection of candidates (corners, or SIFT keypoints, in sift-sift mode only those
whose descriptor does not match the previous frame), all as fixed-shape tensor code
with no host round trip. With ``ba.enabled`` every ``ba.keyframe_every``-th frame is
pushed into the keyframe ring and the window is refined (Schur-complement LM), also
with no host round trip: the host keeps a mirror of ``state.frame_idx`` and decides the
cadence from it. The host loop (:class:`VisualOdometry`) reads results back once per
chunk, performs re-bootstrap recovery when the ``health`` counter says tracking
collapsed, and saves and resumes checkpoints. On the card it replays the per-frame step
and the keyframe step as CUDA graphs with the state donated, and the bootstrap's pieces
as CUDA graphs of their own (``utils/graphs.py``, where the JAX package jits them); the
``make_*`` functions return the eager steps, as the JAX package's return unjitted ones.

The randomness is the JAX package's (``utils/jax_random.py``): the host loop keeps its
key chain (``PRNGKey(cfg.seed)``, split at every bootstrap, frame and chunk as the JAX
package splits it), ``two_view_init`` takes its key, and a step takes the uniforms of
its key's PnP draw (``u_i``), computed on the device for a whole chunk at once, so one
seed gives both packages the same RANSAC samples.

Ported: the ``shi-mask``/``harris-mask``/``sift-mask``/``sift-sift`` candidate modes,
the KLT and the SIFT-matching bootstrap, the eight-point and five-point essential
solvers, sliding-window BA (both gauges, ``landmarks_only``) in the per-frame and the
chunked loop, and checkpoint/resume in the JAX package's file format.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from lcvo_tpu_torch.config import VOConfig
from lcvo_tpu_torch.core import geometry as geo
from lcvo_tpu_torch.core import state as st
from lcvo_tpu_torch.core.state import resolve_device
from lcvo_tpu_torch.frontend import sift as sift_mod
from lcvo_tpu_torch.frontend.match import knn_match_ratio, mutual_match
from lcvo_tpu_torch.ops import epipolar, harris, pnp
from lcvo_tpu_torch.ops import svd as svd_mod
from lcvo_tpu_torch.ops.klt import pyramidal_klt
from lcvo_tpu_torch.ops.pyramid import build_pyramid
from lcvo_tpu_torch.solve.ba import window as win_mod
from lcvo_tpu_torch.utils import checkpoint as ckpt
from lcvo_tpu_torch.utils import graphs
from lcvo_tpu_torch.utils import jax_random, profiling


class FrameResult(NamedTuple):
    R: torch.Tensor          # (3,3) world→camera
    t: torch.Tensor          # (3,)
    pose_ok: torch.Tensor    # () bool — PnP had enough inliers
    n_tracked: torch.Tensor  # () int — tracks surviving KLT
    n_inliers: torch.Tensor  # () int — PnP inliers
    n_candidates: torch.Tensor
    n_promoted: torch.Tensor
    reproj_rms: torch.Tensor  # () float — RMS reprojection error of inliers (px)


_CANDIDATE_MODES = ("shi-mask", "harris-mask", "sift-mask", "sift-sift")


def check_supported(cfg: VOConfig) -> None:
    """Raise for settings the step does not know."""
    if cfg.find_new_candidates_method not in _CANDIDATE_MODES:
        raise ValueError(f"unknown find_new_candidates_method: {cfg.find_new_candidates_method!r}")
    if cfg.ba.enabled and cfg.ba.gauge not in ("oldest", "newest"):
        raise ValueError(f"unknown ba.gauge: {cfg.ba.gauge!r}")


def _sift_features(cfg: VOConfig, image: torch.Tensor, compute_desc: bool = True):
    """SIFT keypoints (and descriptors) of one frame at the config's settings."""
    det = cfg.detector
    return sift_mod.sift(
        image,
        max_keypoints=cfg.descriptor.max_keypoints,
        octaves=det.sift_octaves,
        scales_per_octave=det.sift_scales_per_octave,
        contrast_thresh=det.sift_contrast_thresh,
        edge_thresh=det.sift_edge_thresh,
        border=cfg.klt.border,
        compute_desc=compute_desc,
        desc_method=cfg.descriptor.method,
        patch_size=cfg.descriptor.patch_size,
    )


def _K_tensor(K, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(K, np.float32), device=device)


def make_process_frame(cfg: VOConfig, K, device="cuda"):
    """The per-frame step for a fixed config and intrinsics.

    ``process_frame(state, image, u, pnp_sampler=None)``: ``image`` (H, W) on the
    state's device, any dtype (uint8 frames are cast on the device); ``u`` (n_hyp, 3)
    the uniforms the PnP minimal sets are drawn from, those of the JAX package's step
    key (:func:`uniforms_fn`). ``pnp_sampler(valid) -> (H, 3)`` replaces that draw
    (tests inject minimal sets)."""
    dev = resolve_device(device)
    Kt = _K_tensor(K, dev)
    fx = float(np.asarray(K)[0, 0])
    kltc = cfg.klt
    tri = cfg.triangulation
    det = cfg.detector
    n_tracks = cfg.state.max_tracks
    alpha_rad = float(np.deg2rad(tri.alpha_deg))
    pnp_thresh_n = cfg.ransac.pnp_thresh_px / fx
    max_cand_age = tri.max_candidate_age
    pyr_dtype = getattr(torch, cfg.runtime.dtype)
    n_lvl = kltc.track_levels or kltc.levels
    mc = kltc.track_margin_coarse or kltc.track_margin
    margins = tuple(mc if l == n_lvl - 1 and n_lvl > 1 else kltc.track_margin
                    for l in range(n_lvl))
    mode = cfg.find_new_candidates_method

    def process_frame(state: st.VOState, image: torch.Tensor, u=None, pnp_sampler=None):
        with profiling.span("lcvo.pyramid"):
            image = image.to(torch.float32)
            pyr_new = build_pyramid(image.to(pyr_dtype), kltc.levels)
        with profiling.span("lcvo.klt"):
            tracks, cands, n_tracked = _track(state, pyr_new)
        with profiling.span("lcvo.pnp"):
            R, t, pose_ok, n_inl, tracks, rms = _localize(state, tracks, u, pnp_sampler)
        with profiling.span("lcvo.map"):
            tracks, cands, n_promoted = _update_map(tracks, cands, R, t)
        with profiling.span("lcvo.detect"):
            cands, new_desc, new_desc_valid = _detect(state, image, tracks, cands, R, t)

        health = torch.where(pose_ok, torch.zeros_like(state.health), state.health + 1)
        new_state = st.VOState(
            tracks=tracks, cands=cands, R=R, t=t, frame_idx=state.frame_idx + 1,
            prev_image=image, prev_pyramid=pyr_new, health=health,
            prev_desc=new_desc, prev_desc_valid=new_desc_valid,
            # this frame's predecessor pose: the next frame's velocity model
            prev_R=state.R, prev_t=state.t,
        )
        result = FrameResult(R=R, t=t, pose_ok=pose_ok, n_tracked=n_tracked,
                             n_inliers=n_inl, n_candidates=cands.count(),
                             n_promoted=n_promoted, reproj_rms=rms)
        return new_state, result

    def _track(state, pyr_new):
        # ------ 1. joint KLT over landmark tracks P and candidate tracks C ------
        # constant-velocity warm start: landmark tracks by reprojection under the
        # extrapolated pose, candidates by the rotation-only homography K R_rel K^-1
        R_rel = state.R @ state.prev_R.T
        t_rel = state.t - R_rel @ state.prev_t
        R_pred = R_rel @ state.R
        t_pred = R_rel @ state.t + t_rel
        uv_trk, z_trk = geo.project(Kt, R_pred, t_pred, state.tracks.X)
        d_trk = torch.where((z_trk > 0.1)[:, None], uv_trk - state.tracks.P, 0.0)
        C = state.cands.C
        xh = torch.cat([geo.normalize_points(C, Kt), torch.ones_like(C[:, :1])], dim=-1)
        xr = xh @ R_rel.T
        zr = torch.where(torch.abs(xr[:, 2]) > 1e-6, xr[:, 2], 1e-6)
        uv_cnd = torch.stack(
            [Kt[0, 0] * xr[:, 0] / zr + Kt[0, 2], Kt[1, 1] * xr[:, 1] / zr + Kt[1, 2]], dim=-1)
        d_cnd = torch.where((xr[:, 2] > 0.1)[:, None], uv_cnd - C, 0.0)
        init_d = torch.cat([d_trk, d_cnd], dim=0)
        init_d = torch.clamp(torch.nan_to_num(init_d), -kltc.max_displacement, kltc.max_displacement)

        pts = torch.cat([state.tracks.P, C], dim=0)
        new_pts, klt_ok, _ = pyramidal_klt(
            state.prev_pyramid[:n_lvl], pyr_new[:n_lvl], pts,
            window=kltc.window, iters=kltc.iters, max_residual=kltc.max_residual,
            max_displacement=kltc.max_displacement, border=kltc.border, eps=kltc.eps,
            iter_dtype=kltc.iter_dtype, margin=margins, init_d=init_d,
            iters_coarse=kltc.iters_coarse,
        )
        tracks = state.tracks._replace(P=new_pts[:n_tracks],
                                       valid=state.tracks.valid & klt_ok[:n_tracks])
        cands = state.cands._replace(C=new_pts[n_tracks:],
                                     valid=state.cands.valid & klt_ok[n_tracks:],
                                     age=state.cands.age + 1)
        return tracks, cands, tracks.count()

    def _localize(state, tracks, u, pnp_sampler):
        # ------ 2. PnP-RANSAC localization ------
        x_obs = geo.normalize_points(tracks.P, Kt)
        R, t, inl, n_inl = pnp.pnp_ransac(
            u, tracks.X, x_obs, tracks.valid, thresh=pnp_thresh_n,
            n_hyp=cfg.ransac.pnp_hypotheses, refine_iters=cfg.ransac.refine_iters,
            idx=None if pnp_sampler is None else pnp_sampler(tracks.valid),
        )
        pose_ok = n_inl >= cfg.ransac.min_pnp_inliers
        R = torch.where(pose_ok, R, state.R)
        t = torch.where(pose_ok, t, state.t)
        # filter to PnP inliers; on failure keep the tracks
        tracks = st.prune_tracks(tracks, torch.where(pose_ok, inl, tracks.valid))
        err_n = pnp.reproj_sq_error(R, t, tracks.X, x_obs)
        err_n = torch.where(tracks.valid & torch.isfinite(err_n), err_n, 0.0)
        rms = torch.sqrt(torch.sum(err_n) / torch.clamp(tracks.count(), min=1)) * fx
        return R, t, pose_ok, n_inl, tracks, rms

    def _update_map(tracks, cands, R, t):
        # ------ 2.5 anchor re-triangulation of young landmarks ------
        # (not gated on pose_ok, as in the JAX package: ROADMAP §C)
        if tri.track_refine:
            ang_now = geo.bearing_angle(tracks.R_f, tracks.t_f, R, t, tracks.F, tracks.P, Kt)
            x_a = geo.normalize_points(tracks.F, Kt)
            x_p = geo.normalize_points(tracks.P, Kt)
            X_ref = geo.triangulate_linear(tracks.R_f, tracks.t_f, R, t, x_a, x_p)
            z_ref = geo.se3_apply(R, t, X_ref)[:, 2]
            z_anc = geo.se3_apply(tracks.R_f, tracks.t_f, X_ref)[:, 2]
            uv_ref, _ = geo.project(Kt, R, t, X_ref)
            uv_anc, _ = geo.project(Kt, tracks.R_f, tracks.t_f, X_ref)
            re_ref = torch.sum((uv_ref - tracks.P) ** 2, dim=-1)
            re_anc = torch.sum((uv_anc - tracks.F) ** 2, dim=-1)
            ref_ok = (
                tracks.valid
                & (ang_now > tracks.ang * tri.refine_min_improve)
                & (z_ref > tri.min_depth)
                & (z_ref < tri.max_depth)
                & (z_anc > tri.min_depth)
                & (re_ref < tri.max_reproj_px ** 2)
                & (re_anc < tri.max_reproj_px ** 2)
            )
            tracks = tracks._replace(X=torch.where(ref_ok[:, None], X_ref, tracks.X),
                                     ang=torch.where(ref_ok, ang_now, tracks.ang))

        # ------ 3. candidate validation + batched triangulation + promotion ------
        ang = geo.bearing_angle(cands.R_f, cands.t_f, R, t, cands.F, cands.C, Kt)
        x_f = geo.normalize_points(cands.F, Kt)
        x_c = geo.normalize_points(cands.C, Kt)
        X_tri = geo.triangulate_linear(cands.R_f, cands.t_f, R, t, x_f, x_c)
        z_cur = geo.se3_apply(R, t, X_tri)[:, 2]
        z_first = geo.se3_apply(cands.R_f, cands.t_f, X_tri)[:, 2]
        uv_c, _ = geo.project(Kt, R, t, X_tri)
        re_c = torch.sum((uv_c - cands.C) ** 2, dim=-1)
        geom_ok = (
            (z_cur > tri.min_depth)
            & (z_cur < tri.max_depth)
            & (z_first > tri.min_depth)
            & (re_c < tri.max_reproj_px ** 2)
        )
        if tri.max_depth_baseline_ratio > 0:
            # depth/baseline gate against low-parallax, near-biased triangulations
            c_first = geo.camera_center(cands.R_f, cands.t_f)
            c_cur = geo.camera_center(R, t)
            baseline = torch.linalg.norm(c_first - c_cur[None, :], dim=-1)
            geom_ok = geom_ok & (z_cur < tri.max_depth_baseline_ratio * baseline)
        promote = cands.valid & (ang > alpha_rad) & geom_ok
        tracks = st.insert_into_tracks(
            tracks, cands.C, X_tri, promote,
            F_new=cands.F, R_f_new=cands.R_f, t_f_new=cands.t_f, ang_new=ang,
        )
        n_promoted = torch.sum(promote)
        cands = st.prune_candidates(cands, ~promote & (cands.age < max_cand_age))
        return tracks, cands, n_promoted

    def _detect(state, image, tracks, cands, R, t):
        # ------ 4. re-detection of new candidates, in the mode the config selects ------
        new_desc = new_desc_valid = None
        if mode in ("shi-mask", "harris-mask"):
            pts_det, _, det_ok = harris.detect_corners(
                image,
                max_corners=min(det.max_corners, cfg.state.max_new_per_frame),
                quality_level=det.quality_level, cells_y=det.grid_cells_y,
                cells_x=det.grid_cells_x, cells_topk=det.cells_topk,
                method=mode.split("-")[0],
                window=det.window, border=kltc.border, harris_k=det.harris_k,
            )
        else:
            with profiling.span("lcvo.detect.sift"):
                feats = _sift_features(cfg, image, compute_desc=(mode == "sift-sift"))
            pts_det, det_ok = feats.pts, feats.valid
            if mode == "sift-sift":
                # keypoints whose descriptor matches the previous frame are old
                # content: only unmatched ones become candidates
                with profiling.span("lcvo.detect.match"):
                    _, matched = knn_match_ratio(
                        feats.desc, feats.valid, state.prev_desc, state.prev_desc_valid,
                        ratio=cfg.descriptor.ratio_thresh)
                det_ok = det_ok & ~matched
                new_desc, new_desc_valid = feats.desc, feats.valid
        det_ok = harris.suppress_near_existing(pts_det, det_ok, tracks.P, tracks.valid,
                                               det.min_distance)
        det_ok = harris.suppress_near_existing(pts_det, det_ok, cands.C, cands.valid,
                                               det.min_distance)
        return st.insert_into_candidates(cands, pts_det, R, t, det_ok), new_desc, new_desc_valid

    return process_frame


# ---------------------------------------------------------------------------
# Two-view bootstrap
# ---------------------------------------------------------------------------


def make_bootstrap_fns(cfg: VOConfig, K, device="cuda"):
    """The pieces of the sequential-KLT two-view bootstrap: ``detect0(image)``,
    ``track_pair(pyr0, pyr1, pts, valid)`` and
    ``two_view_init(key, pts0, pts1, valid, e_idx=None)``: ``key`` the JAX package's
    bootstrap key as a (2,) int64 tensor on the device, whose uniforms the essential
    matrix's minimal sets are drawn from; ``e_idx`` injects the minimal sets instead
    (``key`` None)."""
    dev = resolve_device(device)
    Kt = _K_tensor(K, dev)
    fx = float(np.asarray(K)[0, 0])
    kltc = cfg.klt
    det = cfg.detector

    def detect0(image):
        pts, _, ok = harris.detect_corners(
            image,
            max_corners=min(det.max_corners, cfg.state.max_tracks),
            quality_level=det.quality_level, cells_y=det.grid_cells_y,
            cells_x=det.grid_cells_x, cells_topk=max(det.cells_topk, 8),
            method=det.method if det.method in ("shi", "harris") else "shi",
            window=det.window, border=kltc.border, harris_k=det.harris_k,
        )
        return pts, ok

    def track_pair(pyr0, pyr1, pts, valid):
        # bootstrap hops have no motion prior: full (zero-start) margin
        new_pts, ok, _ = pyramidal_klt(
            pyr0, pyr1, pts, window=kltc.window, iters=kltc.iters,
            max_residual=kltc.max_residual, max_displacement=kltc.max_displacement,
            border=kltc.border, eps=kltc.eps, iter_dtype=kltc.iter_dtype, margin=kltc.margin,
        )
        return new_pts, valid & ok

    def two_view_init(key, pts0, pts1, valid, e_idx=None):
        """E-RANSAC + cheirality + triangulation between the bootstrap endpoints.
        Returns (R, t (unit baseline), X (N,3) cam0-frame points, ok mask, n_inliers)."""
        x0 = geo.normalize_points(pts0, Kt)
        x1 = geo.normalize_points(pts1, Kt)
        u = None if key is None else jax_random.uniform(
            key, epipolar.draw_shape(cfg.ransac.e_hypotheses, cfg.ransac.e_solver))
        E, inl, n_inl = epipolar.essential_ransac(
            u, x0, x1, valid, thresh=cfg.ransac.e_thresh_px / fx,
            n_hyp=cfg.ransac.e_hypotheses, solver=cfg.ransac.e_solver, idx=e_idx,
        )
        R, t, _ = epipolar.recover_pose(E, x0, x1, inl)
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        X = geo.triangulate_linear(eye, torch.zeros(3, device=dev), R, t, x0, x1)
        z1 = geo.se3_apply(R, t, X)[:, 2]
        uv1_hat, _ = geo.project(Kt, R, t, X)
        re1 = torch.sum((uv1_hat - pts1) ** 2, dim=-1)
        ok = (
            inl
            & (X[:, 2] > cfg.triangulation.min_depth * 0.25)
            & (z1 > cfg.triangulation.min_depth * 0.25)
            & (re1 < cfg.ransac.e_thresh_px ** 2 * 16.0)
        )
        return R, t, X, ok, n_inl

    return detect0, track_pair, two_view_init


# ---------------------------------------------------------------------------
# Chunked step — the streaming path
# ---------------------------------------------------------------------------


def make_ba_step(cfg: VOConfig, K, device="cuda"):
    """The keyframe step of sliding-window BA for a fixed config and intrinsics.

    ``ba_step(state, window) -> (state', window', result)``: push the current frame as
    a keyframe and refine the window. The refined newest-keyframe pose re-anchors the
    live pose; refined landmarks flow back into the track table (masked to
    participants). Nothing is read back to the host."""
    dev = resolve_device(device)
    Kt = _K_tensor(K, dev)
    ba = cfg.ba
    huber_n = ba.huber_px / float(np.asarray(K)[0, 0])
    n_fix = min(2, ba.window - 1)

    def ba_step(state: st.VOState, window: win_mod.KeyframeWindow):
        with profiling.span("lcvo.ba"):
            window = win_mod.push(window, state.tracks, state.R, state.t)
            window, tracks, R, t, res = win_mod.refine_window(
                window, state.tracks, Kt, iters=ba.gn_iters, n_fix=n_fix, huber=huber_n,
                lam0=ba.damping, landmarks_only=ba.landmarks_only, gauge=ba.gauge,
            )
        return state._replace(tracks=tracks, R=R, t=t), window, res

    return ba_step


def keyframes_in(frame_idx: int, n: int, every: int) -> int:
    """How many of the ``n`` steps after a state with ``frame_idx`` end on a keyframe
    (the cadence is on the state AFTER the step: ``frame_idx % every == 0``)."""
    return (frame_idx + n) // every - frame_idx // every


def pnp_key(keys):
    """The key the JAX package's step draws its PnP minimal sets from, for each step key
    of ``keys (..., 2)``: ``k_pnp`` of its ``k_pnp, k_det = split(key)`` (``k_det`` is
    unused there too). Numpy keys stay on the host, tensors on their device."""
    return jax_random.split(keys)[..., 0, :]


def keys_to_device(keys, device) -> torch.Tensor:
    """Keys (..., 2) as int64 on ``device``, with no wait for the card: a host array
    goes through pinned memory, copied behind the work already queued."""
    dev = resolve_device(device)
    t = keys if torch.is_tensor(keys) else torch.from_numpy(np.asarray(keys).astype(np.int64))
    t = t.to(torch.int64)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def uniforms_fn(n_hyp: int, device, compile_kw: dict | None = None):
    """``uniforms(keys (..., 2)) -> (..., n_hyp, 3)`` float32 on ``device``: the uniforms
    of the JAX package's PnP draw for each of its step keys (:func:`pnp_key` on the
    keys' side, then ``uniform(k_pnp, (n_hyp, 3))`` on the device), all keys of a chunk
    at once. ``compile_kw``: compile the device part (``graphs.compile_step``'s
    arguments), as the host loops do; left out, it runs eagerly."""
    dev = resolve_device(device)

    def uniform(k):
        return jax_random.uniform(k, (n_hyp, 3))

    fn = uniform if compile_kw is None else graphs.compile_step(
        uniform, donate=False, name="pnp_uniforms", **compile_kw)

    def uniforms(keys):
        return fn(keys_to_device(pnp_key(keys), dev))

    uniforms.compiled = None if compile_kw is None else fn
    return uniforms


def draws_of(keys, uniforms, key_dims: int):
    """The draws of a step or chunk: the uniforms of ``keys`` (``key_dims`` dims, the
    last of 2), or ``keys`` as they are when they are a tensor of more dims: injected
    draws, uniforms (floating point) or PnP minimal sets (integer)."""
    if torch.is_tensor(keys) and keys.dim() > key_dims:
        return keys
    return uniforms(keys)


def frame_step(process):
    """``process_frame`` with its randomness as one argument: ``step(state, image, draw)``
    where ``draw`` (n_hyp, 3) is either the uniforms of the step's key (floating point)
    or injected PnP minimal sets (integer). The form a compiled step takes (a callable
    cannot be a graph's argument)."""
    def step(state, image, draw):
        if not torch.is_floating_point(draw):
            return process(state, image, None, pnp_sampler=lambda valid: draw)
        return process(state, image, draw)

    return step


def carry_step(ba_step):
    """``ba_step`` on the chunk carry: ``step((state, window)) -> ((state', window'),
    result)``, so that the state and the window are donated together."""
    def step(carry):
        state, window, res = ba_step(*carry)
        return (state, window), res

    return step


def chunk_loop(step, uniforms, keyframe_step=None, every: int = 1, on_refine=None):
    """The chunk step over a per-frame step (:func:`frame_step`'s form) and, with BA, a
    keyframe step (:func:`carry_step`'s form) on the cadence ``every``: the Python loop
    that stands for the JAX package's ``lax.scan`` with BA under ``lax.cond``.
    ``uniforms`` (:func:`uniforms_fn`) turns the chunk's keys into its frames' draws in
    one call. The steps may be eager or compiled (``utils/graphs.py``);
    :func:`make_chunk_fn` documents the signature."""
    def stack(outs):
        return (torch.stack([r.R for r in outs]), torch.stack([r.t for r in outs]),
                torch.stack([r.pose_ok for r in outs]),
                torch.stack([r.n_inliers for r in outs]))

    def chunk_fn(carry, frames, keys, frame_idx=None):
        ba = keyframe_step is not None
        state, window = carry if ba else (carry, None)
        if ba and frame_idx is None:
            frame_idx = int(state.frame_idx)
        draws = draws_of(keys, uniforms, 2)
        outs = []
        for j in range(frames.shape[0]):
            state, res = step(state, frames[j], draws[j])
            outs.append(res)
            if ba and (frame_idx + j + 1) % every == 0:
                (state, window), ba_res = keyframe_step((state, window))
                if on_refine is not None:
                    on_refine(ba_res)
        return ((state, window) if ba else state), stack(outs)

    return chunk_fn


def make_chunk_fn(cfg: VOConfig, K, device="cuda", on_refine=None):
    """``chunk_fn(carry, frames (chunk,H,W), keys (chunk,2), frame_idx=None) -> (carry',
    (R (chunk,3,3), t (chunk,3), pose_ok (chunk,), n_inliers (chunk,)))``:
    ``process_frame`` over a chunk of frames, a Python loop in place of ``lax.scan``,
    with ``carry = state`` (no BA) or ``(state, window)`` (BA), frame j drawing from
    ``keys[j]`` as the JAX package's does (numpy uint32 or an integer tensor). Nothing is
    read back. ``keys`` may also be a tensor (chunk, n_hyp, 3) of each frame's draw:
    uniforms (floating point) or PnP minimal sets (integer), injected frame by frame
    (tests feed the same samples to the batched step).

    With BA the keyframe push and window refine run inside the loop, on the cadence of
    the per-frame path, and the recorded pose is the one before the refine. The
    cadence is decided on the host: ``frame_idx`` is ``state.frame_idx`` at the start
    of the chunk as a Python int (the caller's mirror of it); left out, it is read
    from the device once, which waits for it. ``on_refine(result)`` receives each
    refine's :class:`BAResult` (tensors on the device). The steps run eagerly, as the
    JAX package's ``make_chunk_fn`` returns an unjitted function:
    :meth:`VisualOdometry.make_chunk_step` is the compiled chunk step."""
    step = frame_step(make_process_frame(cfg, K, device))
    uniforms = uniforms_fn(cfg.ransac.pnp_hypotheses, device)
    if not cfg.ba.enabled:
        return chunk_loop(step, uniforms)
    return chunk_loop(step, uniforms, carry_step(make_ba_step(cfg, K, device)),
                      cfg.ba.keyframe_every, on_refine)


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


# step keys whose uniforms :meth:`VisualOdometry.step` makes at once (a chunk's worth)
DRAWS_AHEAD = 16


class VisualOdometry:
    """Host-side loop: owns the compiled steps, the bootstrap state machine and failure
    recovery. ``device`` defaults to CUDA; the CPU runs only when asked for.

    On the card the per-frame step, the keyframe step and the bootstrap's pieces are CUDA
    graphs (:func:`lcvo_tpu_torch.utils.graphs.compile_step`, where the JAX package
    applies ``jax.jit``), captured at their first call and replayed after it, the step's
    state donated when ``cfg.runtime.donate_state`` is set; ``graphs.disable_graphs()``
    runs them eagerly. The state and the window are then the graphs' buffers: every bootstrap,
    :meth:`set_chunk_carry` and :meth:`resume` write into them and never rebind them, so
    a re-bootstrap mid-run replays the same graphs. On the CPU the steps run eagerly.

    Each ``step``, chunk and ``bootstrap`` is a call of the flight recorder
    (``utils/profiling.py``), with its spans and the run ordinal of the ``run`` or
    ``run_chunked`` it belongs to (0 for the object's first)."""

    def __init__(self, cfg: VOConfig, K: np.ndarray, device="cuda"):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.K = np.asarray(K, np.float64)
        self.state: st.VOState | None = None
        # the JAX package's key chain, on the host: (2,) uint32
        self._key = jax_random.PRNGKey(cfg.seed)
        # uniforms of the chain's next step keys, made ahead (see _step_uniforms)
        self._ahead: dict = {}
        self.trajectory: list[np.ndarray] = []  # camera centers (world)
        self.poses: list[np.ndarray] = []       # (4,4) cam→world, one per trajectory entry
        self.pose_ok_flags: list[bool] = []     # per-entry health (False: held/weak pose)
        self.results: list = []
        self.n_rebootstraps = 0
        # matrices whose SVD failed (NaN) in the last bootstrap, by ops/svd.py's record
        self.last_bootstrap_svd_failures = 0
        # host mirror of state.frame_idx: process_frame adds 1 without condition and
        # every bootstrap starts again at 0, so the BA cadence is decided here and the
        # device is never asked (checked against it once per chunk)
        self._frame_idx = 0
        self._runs = 0                          # run / run_chunked calls begun
        # sliding-window BA
        self.window: win_mod.KeyframeWindow | None = None
        self.n_keyframes = 0                    # keyframes pushed, counted on the host
        if cfg.ba.enabled:
            self.window = win_mod.make_window(cfg.ba.window, cfg.state.max_tracks, self.device)
            # [refines run, refines whose cost is not <= the cost they started from],
            # kept on the device and read only when ba_refine_stats() is asked
            self._ba_stats = torch.zeros((2,), dtype=torch.int32, device=self.device)
        profiling.watch_gc()
        self._compile_steps()

    def _compile_steps(self, capture=None):
        """The per-frame step (``frame_step`` form) and, with BA, the keyframe step on
        the ``(state, window)`` carry, compiled, the state donated as
        ``cfg.runtime.donate_state`` says; and the bootstrap's pieces as the JAX package
        jits them, nothing donated: ``detect0``, ``track_pair`` (one graph per hop, so a
        burst of any length replays the same graph), ``two_view_init``, the pyramid of
        one frame and, where the bootstrap describes frames, the SIFT features of one
        frame and (SIFT init) ``mutual_match``. One memory pool for all of them: they
        never run at the same time. The randomness is an argument: ``two_view_init``
        takes its key, the per-frame step its uniforms, which ``_uniforms`` (compiled
        too) makes for all the frames of a chunk at once. ``capture`` is the CPU tests'
        stand-in for the CUDA capture (``utils/graphs.py``)."""
        cfg = self.cfg
        pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        kw = dict(donate=cfg.runtime.donate_state, pool=pool, capture=capture)
        self._process = graphs.compile_step(
            frame_step(make_process_frame(cfg, self.K, self.device)),
            name="process_frame", **kw)
        self._uniforms = uniforms_fn(cfg.ransac.pnp_hypotheses, self.device,
                                     dict(pool=pool, capture=capture))
        self._ba = None
        if self.window is not None:
            self._ba = graphs.compile_step(
                carry_step(make_ba_step(cfg, self.K, self.device)), name="ba_step", **kw)

        boot = dict(donate=False, pool=pool, capture=capture)
        detect0, track_pair, two_view_init = make_bootstrap_fns(cfg, self.K, self.device)
        self._detect0 = graphs.compile_step(detect0, name="detect0", **boot)
        self._track_pair = graphs.compile_step(track_pair, name="track_pair", **boot)
        self._two_view = graphs.compile_step(two_view_init, name="two_view_init", **boot)
        pyr_dtype = getattr(torch, cfg.runtime.dtype)

        def pyramid(image):
            return build_pyramid(image.to(pyr_dtype), cfg.klt.levels)

        def sift_features(image):
            return _sift_features(cfg, image)

        def match(desc_a, valid_a, desc_b, valid_b):
            return mutual_match(desc_a, valid_a, desc_b, valid_b,
                                ratio=cfg.descriptor.ratio_thresh)

        self._pyramid = graphs.compile_step(pyramid, name="build_pyramid", **boot)
        sift_init = cfg.bootstrap.init_method == "sift"
        self._sift = self._match = None
        if sift_init or cfg.find_new_candidates_method == "sift-sift":
            self._sift = graphs.compile_step(sift_features, name="sift_features", **boot)
        if sift_init:
            self._match = graphs.compile_step(match, name="mutual_match", **boot)

    def _compiled(self) -> list:
        """Every compiled step of this host loop."""
        return [c for c in (self._process, self._uniforms.compiled, self._ba, self._pyramid,
                            self._detect0, self._track_pair, self._two_view, self._sift,
                            self._match)
                if c is not None]

    def graph_stats(self) -> dict:
        """The compiled steps' graphs, the bootstrap's among them (warm-up, capture and
        instantiation seconds, nodes, replays, launches per replay), and the bytes of
        their shared memory pool."""
        steps = self._compiled()
        return {"graphs": [g for c in steps for g in c.stats()],
                "pool_bytes": max((c.pool_bytes() for c in steps), default=0)}

    def _next_key(self) -> np.ndarray:
        """The next key of the chain, as the JAX package's ``_next_key`` splits it."""
        self._key, k = jax_random.split(self._key)
        return k

    def _step_uniforms(self, key: np.ndarray) -> torch.Tensor:
        """The uniforms of the step key ``key`` for :meth:`step`. They are made for the
        next ``DRAWS_AHEAD`` keys the chain would hand out, in one replay, and kept by key:
        per frame one replay of a batch of 16 costs the card about what one of a single
        key does. A bootstrap in between takes a key, so the kept ones are not asked for
        again and the next step makes a new batch."""
        u = self._ahead.pop(key.tobytes(), None)
        if u is not None:
            return u
        keys, chain = [key], self._key
        for _ in range(DRAWS_AHEAD - 1):
            chain, k = jax_random.split(chain)
            keys.append(k)
        draws = self._uniforms(np.stack(keys))
        self._ahead = {k.tobytes(): draws[i] for i, k in enumerate(keys[1:], 1)}
        return draws[0]

    def _next_uniforms(self) -> torch.Tensor:
        """The uniforms of the next step key."""
        return self._step_uniforms(self._next_key())

    def _frame(self, f) -> torch.Tensor:
        """A frame on the device in its own dtype (uint8 stays uint8; the step casts)."""
        return torch.as_tensor(np.asarray(f)).to(self.device)

    # -- bootstrap ---------------------------------------------------------
    def bootstrap(self, frames: list, R0: np.ndarray | None = None,
                  t0: np.ndarray | None = None, scale: float | None = None) -> int:
        """Initialize from a short frame burst (length = bootstrap gap + 1).

        Optional (R0, t0) anchors the first bootstrap camera at a known world pose
        (re-bootstrap keeps the map in one frame); optional ``scale`` sets the metric
        length of the two-view baseline. Returns the essential-matrix inlier count.

        On the card the pieces replay their graphs (``_compile_steps``); what follows
        ``two_view_init`` (anchoring, the track table, the state) runs eagerly, as in the
        JAX package, and writes into the step's buffers. One read-back, after the state
        is assembled and before it is written: the camera centers, the inlier count and
        the SVDs' failure record, whose count goes to ``last_bootstrap_svd_failures``.

        An SVD that fails gives NaN in its matrix and nothing raises, as in the JAX
        package: a NaN hypothesis can win the MSAC argmin, and the bootstrap then
        returns 0 inliers with a NaN pose, which the host loops treat as a weak
        bootstrap (they extend or slide the window)."""
        return profiling.call("bootstrap", len(self.trajectory), self._runs - 1,
                              self._bootstrap, frames, R0, t0, scale)

    def _bootstrap(self, frames, R0, t0, scale) -> int:
        cfg = self.cfg
        dev = self.device
        svd_mod.reset(dev)
        imgs = [self._frame(f).to(torch.float32) for f in frames]
        pyrs = [self._pyramid(im) for im in imgs]
        f1 = None
        if cfg.bootstrap.init_method == "sift":
            # reference init: SIFT detect+describe both endpoint frames, mutual
            # nearest-neighbour match with Lowe's ratio
            f0 = self._sift(imgs[0])
            f1 = self._sift(imgs[-1])
            idx, ok = self._match(f0.desc, f0.valid, f1.desc, f1.valid)
            pts0 = f0.pts
            pts = f1.pts[idx]
        else:
            pts0, ok = self._detect0(imgs[0])
            pts = pts0
            for i in range(len(imgs) - 1):
                pts, ok = self._track_pair(pyrs[i], pyrs[i + 1], pts, ok)
        R, t, X, good, n_inl = self._two_view(keys_to_device(self._next_key(), dev), pts0,
                                              pts, ok)
        if scale is not None and np.isfinite(scale) and scale > 1e-6:
            # uniform scaling of the two-view geometry preserves all observations
            t = t * float(scale)
            X = X * float(scale)

        # anchor into the world frame: cam0 pose = (R0, t0) (identity on first bootstrap)
        if R0 is None:
            R0, t0 = np.eye(3), np.zeros(3)
        R0t = torch.as_tensor(np.asarray(R0, np.float32), device=dev)
        t0t = torch.as_tensor(np.asarray(t0, np.float32), device=dev)
        R_last, t_last = geo.se3_compose(R, t, R0t, t0t)
        Ri, ti = geo.se3_inverse(R0t, t0t)
        X_w = geo.se3_apply(Ri, ti, X)

        state = st.make_vo_state(cfg, tuple(imgs[0].shape), dev)
        Kt = _K_tensor(self.K, dev)
        boot_ang = geo.bearing_angle(R0t, t0t, R_last, t_last, pts0, pts, Kt)
        tracks = st.insert_into_tracks(state.tracks, pts, X_w, good,
                                       F_new=pts0, R_f_new=R0t, t_f_new=t0t, ang_new=boot_ang)
        # the one read-back (f64 holds the f32 centers and the counts exactly)
        back = [geo.camera_center(R_last, t_last), geo.camera_center(R0t, t0t),
                n_inl.reshape(1), svd_mod.record(dev).reshape(-1)]
        with profiling.span("vo.readback"):
            host = torch.cat([x.to(torch.float64) for x in back]).cpu().numpy()
        self.last_bootstrap_svd_failures = sum(svd_mod.failures(host[7:]).values())
        c_last, c0, n = host[0:3].astype(np.float32), host[3:6].astype(np.float32), int(host[6])
        # seed the constant-velocity model with the bootstrap window's mean per-frame
        # translation
        c_prev = c_last - (c_last - c0) / max(len(imgs) - 1, 1)
        prev_t = -(R_last @ torch.as_tensor(c_prev.astype(np.float32), device=dev))
        state = state._replace(
            tracks=tracks, R=R_last, t=t_last, prev_R=R_last.clone(), prev_t=prev_t,
            prev_image=imgs[-1], prev_pyramid=pyrs[-1],
        )
        mode = cfg.find_new_candidates_method
        if mode.startswith("sift"):
            # the step's SIFT constants (band matrices, sample grids) go to the device
            # now, not inside the first process_frame
            sift_mod.prepare(*imgs[0].shape, dev, octaves=cfg.detector.sift_octaves,
                             scales_per_octave=cfg.detector.sift_scales_per_octave,
                             patch_size=cfg.descriptor.patch_size)
        if mode == "sift-sift":
            # seed the previous-frame descriptor table with the last bootstrap frame so
            # the first step filters already-seen keypoints instead of flooding the
            # candidate set
            if f1 is None:
                f1 = self._sift(imgs[-1])
            state = state._replace(prev_desc=f1.desc, prev_desc_valid=f1.valid)
        self._frame_idx = 0
        if self.window is not None:
            # stale keyframes must not constrain the re-initialized map
            self.window = graphs.place(
                self.window, win_mod.make_window(cfg.ba.window, cfg.state.max_tracks, dev))
        # into the graphs' buffers: a re-bootstrap replays the same graphs
        self.state = graphs.place(self.state, state)
        if n < cfg.bootstrap.min_matches:
            warnings.warn(
                f"weak bootstrap: {n} essential-matrix inliers < "
                f"bootstrap.min_matches={cfg.bootstrap.min_matches}",
                stacklevel=2,
            )
        return n

    # -- per-frame ---------------------------------------------------------
    def step(self, image) -> FrameResult:
        assert self.state is not None, "call bootstrap() first"
        return profiling.call("step", self._frame_idx, self._runs - 1, self._step, image)

    def _step(self, image) -> FrameResult:
        u = profiling.lap("vo.keys", self._next_uniforms)
        frame = profiling.lap("vo.upload", self._frame, image)
        self.state, res = self._process(self.state, frame, u)
        self._frame_idx += 1
        if self.window is not None and self._frame_idx % self.cfg.ba.keyframe_every == 0:
            self._ba_step()
        return res

    def _ba_step(self):
        """Push the current frame as a keyframe and refine the window."""
        (self.state, self.window), res = self._ba((self.state, self.window))
        self.n_keyframes += 1
        self._note_refine(res)

    def _note_refine(self, res):
        bad = ~(res.cost <= res.cost0)      # a NaN cost counts as not improved
        self._ba_stats = self._ba_stats + torch.stack(
            [torch.ones_like(bad), bad]).to(torch.int32)

    def ba_refine_stats(self) -> tuple[int, int]:
        """(refines run, refines that ended with a cost above the one they started
        from) since this object was made; one read-back."""
        if self.window is None:
            return 0, 0
        n, bad = self._ba_stats.cpu().tolist()
        return n, bad

    def record(self, res: FrameResult):
        self._append_pose(res.R.cpu().numpy(), res.t.cpu().numpy(), ok=bool(res.pose_ok))
        self.results.append(res)

    def _emit(self, res: FrameResult, on_frame):
        """Record a pose and its metrics row; every trajectory entry gets one."""
        self.record(res)
        if on_frame is not None:
            on_frame(len(self.trajectory) - 1, res)

    def _append_pose(self, R: np.ndarray, t: np.ndarray, ok: bool = True):
        """Append one world→camera pose as a camera center (``trajectory``) and a 4x4
        cam→world matrix (``poses``); ``ok=False`` marks held/weak poses."""
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        self.trajectory.append(T[:3, 3].copy())
        self.poses.append(T)
        self.pose_ok_flags.append(bool(ok))

    def _recent_step_scale(self, k: int = 16) -> float | None:
        """Median per-frame translation over the last ``k`` healthy steps: the
        pre-failure velocity that carries metric scale through a re-bootstrap."""
        if len(self.trajectory) < 3:
            return None
        pts = np.asarray(self.trajectory[-(k + 1):])
        flags = np.asarray(self.pose_ok_flags[-(k + 1):], bool)
        d = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        good = flags[:-1] & flags[1:] & (d > 1e-9)
        if int(np.sum(good)) < 2:
            return None
        return float(np.median(d[good]))

    def _chunk_emit(self, on_chunk, Rs, ts, oks, ninl=None):
        """Append host-synthesized poses in chunked mode with their metrics rows;
        ``ninl=None`` emits the -1 "not measured" sentinel."""
        if on_chunk is not None:
            on_chunk(len(self.trajectory), np.asarray(Rs), np.asarray(ts),
                     np.asarray(oks, bool),
                     np.full(len(oks), -1, np.int32) if ninl is None else np.asarray(ninl))
        for R, t, ok in zip(Rs, ts, oks):
            self._append_pose(np.asarray(R), np.asarray(t), ok=bool(ok))

    def _pose_result(self, R, t, pose_ok: bool) -> FrameResult:
        """A host-synthesized FrameResult (bootstrap end pose, or a held pose)."""
        dev = self.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return FrameResult(
            R=torch.as_tensor(np.asarray(R, np.float32), device=dev),
            t=torch.as_tensor(np.asarray(t, np.float32), device=dev),
            pose_ok=torch.tensor(pose_ok, device=dev),
            n_tracked=self.state.tracks.count(), n_inliers=zero,
            n_candidates=zero, n_promoted=zero,
            reproj_rms=torch.zeros((), device=dev),
        )

    def _host_pose(self):
        # copies: on the CPU ``.numpy()`` would share the state's buffers, which the next
        # bootstrap writes into
        return self.state.R.cpu().numpy().copy(), self.state.t.cpu().numpy().copy()

    # -- chunked throughput mode -------------------------------------------
    def make_chunk_step(self, chunk: int):
        """The chunk step the host loop runs (the JAX package jits it): a Python loop
        that replays this instance's compiled per-frame step and, on the cadence of the
        host mirror, its compiled keyframe step, with BA refines counted into
        :meth:`ba_refine_stats`. Returns ``chunk_fn(carry, frames (chunk, H, W), keys
        (chunk, 2), frame_idx=None) -> (carry', (R (chunk,3,3), t (chunk,3), pose_ok, n_inliers))``
        as :func:`make_chunk_fn`; the carry is :meth:`chunk_carry` (donated: with
        ``runtime.donate_state`` the carry that comes back is the same buffers),
        ``frame_idx`` the host mirror ``self._frame_idx``, and the caller hands the carry
        back with :meth:`set_chunk_carry`. ``chunk`` is kept for the JAX package's
        signature: the step takes any number of frames."""
        if self.window is None:
            return chunk_loop(self._process, self._uniforms)
        return chunk_loop(self._process, self._uniforms, self._ba, self.cfg.ba.keyframe_every,
                          self._note_refine)

    def chunk_carry(self):
        """Carry for :func:`make_chunk_fn`'s step: the VO state, plus the BA window
        when BA is enabled."""
        return self.state if self.window is None else (self.state, self.window)

    def set_chunk_carry(self, carry, n_frames: int | None = None):
        """Take a chunk step's carry back. ``n_frames``: how many frames that step
        processed, which advances the host's mirror of ``frame_idx`` and its keyframe
        count; left out, the mirror is read from the device (which waits for it)."""
        state, window = (carry, None) if self.window is None else carry
        # into the graphs' buffers (nothing moves when the carry is those buffers)
        self.state = graphs.place(self.state, state)
        if window is not None:
            self.window = graphs.place(self.window, window)
        if n_frames is None:
            self._frame_idx = int(self.state.frame_idx)
        else:
            if self.window is not None:
                self.n_keyframes += keyframes_in(self._frame_idx, n_frames,
                                                 self.cfg.ba.keyframe_every)
            self._frame_idx += n_frames

    def run_chunked(self, frames, chunk: int = 16, n_frames: int | None = None,
                    checkpoint_every: int = 0, checkpoint_path: str | None = None,
                    on_chunk=None):
        """Replay a whole sequence in chunks (bootstrap first).

        ``frames``: a (T, H, W) array or any iterable of (H, W) frames. One pose per
        frame from frame ``gap`` onward, the bootstrap-end pose first, so ground truth
        aligns as ``gt[gap : gap + len(traj)]``. Tail frames that don't fill a chunk
        run through the per-frame path.

        ``checkpoint_every=N`` saves a resumable checkpoint to ``checkpoint_path`` at
        the first chunk boundary past every N processed frames; resume with
        :meth:`resume` + :meth:`run_chunked_continue`. ``on_chunk(start, Rs, ts, ok,
        ninl)`` receives each chunk's per-frame outputs."""
        gap = self.cfg.bootstrap.frame_gap
        self._runs += 1
        if n_frames is None and hasattr(frames, "__len__"):
            n_frames = len(frames)
        it = iter(frames)
        boot = [f for _, f in zip(range(gap + 1), it)]
        if len(boot) < gap + 1:
            raise ValueError(
                f"stream ended after {len(boot)} frame(s); the two-view bootstrap "
                f"needs at least bootstrap.frame_gap + 1 = {gap + 1}"
            )
        n_boot_inl = self.bootstrap(boot)
        R, t = self._host_pose()
        self._chunk_emit(on_chunk, [R], [t], [True], ninl=[n_boot_inl])
        return self.run_chunked_continue(
            it, produced=gap + 1, chunk=chunk, n_frames=n_frames,
            checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
            on_chunk=on_chunk)

    def run_chunked_continue(self, frame_iter, produced: int, chunk: int = 16,
                             n_frames: int | None = None, checkpoint_every: int = 0,
                             checkpoint_path: str | None = None, on_chunk=None):
        """Chunked streaming loop from an initialized state (after the bootstrap, or
        after :meth:`resume`); ``frame_iter`` yields frames ``produced, produced+1, …``.
        If a chunk ends with tracking collapsed (``health >= 2``), the loop
        re-bootstraps over the next ``rebootstrap_skip + 1`` frames, anchored at the
        held pose and at the pre-failure metric scale, recording the held pose for
        those frames."""
        skip = max(self.cfg.bootstrap.rebootstrap_skip, 1)
        it = iter(frame_iter)
        chunk_fn = self.make_chunk_step(chunk)
        last_ckpt = produced
        lookahead: list = []   # frames pulled from the stream but not yet processed
        pulled = produced

        def pull(k):
            nonlocal pulled
            out = []
            while len(out) < k and (n_frames is None or pulled < n_frames):
                try:
                    out.append(next(it))
                except StopIteration:
                    break
                pulled += 1
            return out

        def take(k):
            out = []
            while len(out) < k and lookahead:
                out.append(lookahead.pop(0))
            if len(out) < k:
                out.extend(pull(k - len(out)))
            return out

        def one_chunk(buf) -> tuple[int, bool]:
            """One chunk through ``chunk_fn``, its poses emitted and, where tracking
            collapsed inside it, the re-bootstrap after it: the poses it produced, and
            whether the sequence ended inside the re-bootstrap's burst."""
            with profiling.span("vo.keys"):
                keys = jax_random.split(self._next_key(), chunk)
            with profiling.span("vo.upload"):
                batch = torch.from_numpy(np.stack([np.asarray(f) for f in buf])).to(self.device)
            carry, (Rs, ts, ok, ninl) = chunk_fn(self.chunk_carry(), batch, keys,
                                                 frame_idx=self._frame_idx)
            self.set_chunk_carry(carry, chunk)
            # the chunk is queued on the device: pull the next frames meanwhile
            if len(lookahead) < chunk:
                lookahead.extend(pull(chunk - len(lookahead)))
            # one read-back for everything the host needs from this chunk
            packed = torch.cat([Rs.reshape(chunk, 9), ts, ok[:, None].float(),
                                ninl[:, None].float(),
                                self.state.health.float().expand(chunk)[:, None],
                                self.state.frame_idx.float().expand(chunk)[:, None]], dim=1)
            with profiling.span("vo.readback"):
                packed = packed.cpu().numpy()
            Rs_h = packed[:, :9].reshape(chunk, 3, 3)
            ts_h, ok_h = packed[:, 9:12], packed[:, 12] > 0.5
            ninl_h, health = packed[:, 13].astype(np.int64), int(packed[0, 14])
            if int(packed[0, 15]) != self._frame_idx:
                raise RuntimeError(
                    f"the host's mirror of frame_idx ({self._frame_idx}) left the device's "
                    f"({int(packed[0, 15])}): the state was replaced without set_chunk_carry")
            with profiling.span("vo.emit"):
                if on_chunk is not None:
                    on_chunk(len(self.trajectory), Rs_h, ts_h, ok_h, ninl_h)
                for j in range(chunk):
                    self._append_pose(Rs_h[j], ts_h[j], ok=bool(ok_h[j]))
            if health < 2:
                return chunk, False
            # tracking collapsed inside the chunk: re-bootstrap anchored at the held last
            # pose, at the pre-failure metric scale
            with profiling.span("vo.rebootstrap"):
                self.n_rebootstraps += 1
                R0, t0 = self._host_pose()
                speed = self._recent_step_scale()
                burst = take(skip + 1)
                if len(burst) == skip + 1:
                    scale = speed * (len(burst) - 1) if speed else None
                    n_rb_inl = self.bootstrap(burst, R0=R0, t0=t0, scale=scale)
                    R1, t1 = self._host_pose()
                    self._chunk_emit(on_chunk, [R0] * skip + [R1], [t0] * skip + [t1],
                                     [False] * skip + [True], ninl=[-1] * skip + [n_rb_inl])
                    return chunk + skip + 1, False
                # the sequence ended inside the burst: hold the anchor
                if burst:
                    self._chunk_emit(on_chunk, [R0] * len(burst), [t0] * len(burst),
                                     [False] * len(burst))
                return chunk + len(burst), True

        buf = take(chunk)
        while len(buf) == chunk:
            n, ended = profiling.call("chunk", len(self.trajectory), self._runs - 1,
                                      one_chunk, buf)
            produced += n
            if ended:
                buf = []
                break
            if checkpoint_every and checkpoint_path and produced - last_ckpt >= checkpoint_every:
                self.save(checkpoint_path, produced)
                last_ckpt = produced
            buf = take(chunk)
        for img in buf:  # tail frames that don't fill a chunk: per-frame path
            res = self.step(img)
            self._chunk_emit(on_chunk, [res.R.cpu().numpy()], [res.t.cpu().numpy()],
                             [bool(res.pose_ok)], [int(res.n_inliers)])
            produced += 1
        return self.trajectory

    # -- full-sequence convenience ------------------------------------------
    def run(self, frame_iter, n_frames: int, bootstrap_gap: int | None = None, on_frame=None,
            checkpoint_every: int = 0, checkpoint_path: str | None = None):
        """Bootstrap + continuous operation over an iterable of frames, one pose per
        frame from frame ``gap`` onward (index-exact across failure recovery). While
        the two-view init is weak (fewer than ``bootstrap.min_matches`` inliers) the
        window grows one frame at a time, bounded. ``checkpoint_every=N`` saves a
        resumable checkpoint to ``checkpoint_path`` every N processed frames (at
        healthy frames only)."""
        cfg = self.cfg
        gap = bootstrap_gap or cfg.bootstrap.frame_gap
        min_m = cfg.bootstrap.min_matches
        max_extend = 4
        self._runs += 1
        it = iter(frame_iter)
        frames = [f for _, f in zip(range(gap + 1), it)]
        if len(frames) < gap + 1:
            raise ValueError(
                f"stream ended after {len(frames)} frame(s); the two-view bootstrap "
                f"needs at least bootstrap.frame_gap + 1 = {gap + 1}"
            )
        n_inl = self.bootstrap(frames)
        produced = gap + 1
        extends = 0
        while n_inl < min_m and extends < max_extend and produced < n_frames:
            try:
                img = next(it)
            except StopIteration:
                break
            self._emit(self._pose_result(*self._host_pose(), False), on_frame)
            frames.append(img)
            produced += 1
            extends += 1
            n_inl = self.bootstrap(frames)
        self._emit(self._pose_result(*self._host_pose(), True), on_frame)
        return self.run_continue(it, n_frames, produced, on_frame=on_frame,
                                 checkpoint_every=checkpoint_every,
                                 checkpoint_path=checkpoint_path)

    def run_continue(self, frame_iter, n_frames: int, produced: int, on_frame=None,
                     checkpoint_every: int = 0, checkpoint_path: str | None = None):
        """Per-frame loop from an initialized state (after the bootstrap, or after
        :meth:`resume`); ``frame_iter`` yields frames ``produced, produced+1, ...``.
        Inlier starvation triggers a re-bootstrap over the next ``rebootstrap_skip + 1``
        frames (held anchor pose meanwhile); a weak burst extends at its end, and a burst
        broken from its start slides forward."""
        cfg = self.cfg
        skip = max(cfg.bootstrap.rebootstrap_skip, 1)
        min_m = cfg.bootstrap.min_matches
        max_extend = 4
        it = iter(frame_iter)
        rebootstrap_buf: list = []
        anchor: tuple | None = None  # (R, t, pre-failure speed)
        slides = 0
        while produced < n_frames:
            try:
                img = next(it)
            except StopIteration:
                break
            produced += 1
            if rebootstrap_buf:
                rebootstrap_buf.append(img)
                if len(rebootstrap_buf) < skip + 1:
                    self._emit(self._pose_result(anchor[0], anchor[1], False), on_frame)
                    continue
                scale = anchor[2] * (len(rebootstrap_buf) - 1) if anchor[2] else None
                n_inl = self.bootstrap(rebootstrap_buf, R0=anchor[0], t0=anchor[1], scale=scale)
                if n_inl >= min_m:
                    rebootstrap_buf = []
                    self._emit(self._pose_result(*self._host_pose(), True), on_frame)
                    continue
                if n_inl < max(min_m // 4, 4) and slides < 30:
                    # broken from the window start: slide the window forward one frame
                    rebootstrap_buf.pop(0)
                    slides += 1
                    self._emit(self._pose_result(anchor[0], anchor[1], False), on_frame)
                    continue
                if len(rebootstrap_buf) < skip + 1 + max_extend:
                    # weak but live geometry: extend the window end, hold the anchor
                    self._emit(self._pose_result(anchor[0], anchor[1], False), on_frame)
                    continue
                # best effort: accept the weak init rather than stall
                rebootstrap_buf = []
                self._emit(self._pose_result(*self._host_pose(), False), on_frame)
                continue
            res = self.step(img)
            self._emit(res, on_frame)
            if profiling.within("vo.health", int, self.state.health) >= 2:
                self.n_rebootstraps += 1
                rebootstrap_buf = [img]
                slides = 0
                anchor = (*self._host_pose(), self._recent_step_scale())
            elif checkpoint_every and checkpoint_path and produced % checkpoint_every == 0:
                self.save(checkpoint_path, produced)
        return self.trajectory

    # -- checkpoint / resume --------------------------------------------------
    def save(self, path: str, produced: int):
        """Checkpoint the full host-loop state (VO state, BA window, trajectory, the
        PRNG key, frame counter) so a long replay resumes bit-exactly, in either package."""
        ckpt.save_checkpoint(
            path, self.state, window=self.window, trajectory=self.trajectory,
            frame_idx=produced, rng_key=self._key, poses=self.poses,
            pose_ok_flags=self.pose_ok_flags,
            extras={"n_rebootstraps": self.n_rebootstraps},
        )

    def resume(self, path: str, prev_frame=None) -> int:
        """Restore a :meth:`save` checkpoint; returns the absolute frame index to
        continue from (feed ``frames[produced:]`` to :meth:`run_continue` or
        :meth:`run_chunked_continue`). A checkpoint of the JAX package resumes here with
        the JAX package's next draws: the state, the window and the key chain.

        A file without its image leaves (``utils/checkpoint.py::strip_checkpoint``)
        needs ``prev_frame``, the last frame the writer consumed (``frames[produced -
        1]``): its float32 copy and pyramid are made here, as the step makes them."""
        cfg = self.cfg
        state_tmpl = st.make_vo_state(cfg, (cfg.image_height, cfg.image_width), self.device)
        rebuild = not ckpt.has_image_leaves(path)
        if rebuild and prev_frame is None:
            raise ValueError(f"checkpoint {path} has no image leaves: pass prev_frame, the "
                             f"last frame its writer consumed")
        state, window, traj, produced, key, poses, flags, extras = ckpt.load_checkpoint(
            path, state_tmpl, self.window)
        if produced is None:
            raise ValueError(f"checkpoint {path} has no frame counter: not a checkpoint of "
                             f"the host loop")
        if rebuild:
            image = self._frame(prev_frame).to(torch.float32)
            state = state._replace(prev_image=image, prev_pyramid=self._pyramid(image))
        if key is not None:
            self._key = key
        self.n_rebootstraps = int(extras.get("n_rebootstraps", 0))
        self.state = graphs.place(self.state, state)
        # the BA cadence follows the mirror: bring it back with the state
        self._frame_idx = int(state.frame_idx)
        if window is not None:
            self.window = graphs.place(self.window, window)
        self.trajectory = list(traj)
        if poses is not None:
            self.poses = list(poses)
        else:  # positions only: synthesize identity-rotation poses
            self.poses = []
            for p in self.trajectory:
                T = np.eye(4)
                T[:3, 3] = p
                self.poses.append(T)
        self.pose_ok_flags = list(flags) if flags is not None else [True] * len(self.trajectory)
        return produced

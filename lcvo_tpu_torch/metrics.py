"""Trajectory accuracy metrics (ATE / RPE / KITTI drift / per-segment scale) and the
per-frame metrics logger (port of ``lcvo_tpu/metrics.py``). Host-side numpy in float64
throughout; only ``MetricsLogger.log_frame`` touches tensors, and it reads them with
``.item()`` outside the step. Monocular VO has a free global scale, so ATE uses a Sim(3)
(Umeyama) alignment before the RMSE.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning est → gt.

    est, gt: (N, 3). Returns (s, R, t) with gt ≈ s * R @ est + t."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (xe**2).sum() / len(est)
    s = float(np.trace(np.diag(d) @ S) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned positions), meters."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def lockstep(centers, pose_ok, n_inliers, ref_centers, ref_pose_ok, ref_n_inliers) -> dict:
    """How far a run stays from a reference run of the same frames, configuration and
    seed (the JAX package's, drawing the same RANSAC samples): per trajectory entry the
    camera-center distance unaligned (both runs fix the scale at the same bootstrap) and
    after a Sim(3) alignment of the run onto the reference; the shares of entries with
    equal pose_ok and with equal PnP inlier count; and the first entry where pose_ok or
    the inlier count part (None if none does). Runs of another length compare nothing
    but their lengths."""
    c, r = np.asarray(centers, np.float64), np.asarray(ref_centers, np.float64)
    out = {"entries": len(c), "reference_entries": len(r)}
    if c.shape != r.shape:
        return out
    d = np.linalg.norm(c - r, axis=1)
    s, R, t = umeyama_alignment(c, r)
    da = np.linalg.norm((s * (R @ c.T)).T + t - r, axis=1)
    ok = np.asarray(pose_ok, bool) == np.asarray(ref_pose_ok, bool)
    ninl = np.asarray(n_inliers) == np.asarray(ref_n_inliers)
    parted = np.flatnonzero(~(ok & ninl))
    out.update({
        "distance_m_max": float(d.max()), "distance_m_median": float(np.median(d)),
        "distance_sim3_m_max": float(da.max()),
        "pose_ok_equal_share": float(ok.mean()), "inliers_equal_share": float(ninl.mean()),
        "first_parted": int(parted[0]) if len(parted) else None,
    })
    return out


def rpe_stats(est_positions: np.ndarray, gt_positions: np.ndarray, delta: int = 1, with_scale: bool = True):
    """Translation-drift statistic over ``delta``-frame intervals (NOT the standard
    RPE — per-interval translation deltas after one global Sim(3) alignment; kept
    as a cheap trend metric). For the conventional metric see :func:`rpe_pose`
    (per-interval relative pose, rotation included) and
    :func:`kitti_odometry_error`.

    Returns (rmse, median) of per-interval translation error, meters.
    """
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    s, R, t = umeyama_alignment(est, gt, with_scale)
    est_a = (s * (R @ est.T)).T + t
    d_est = est_a[delta:] - est_a[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt(np.mean(err**2))), float(np.median(err))


def segment_scale_stats(est_positions: np.ndarray, gt_positions: np.ndarray,
                        seg: int = 50, pose_ok=None) -> dict:
    """Per-segment metric-scale trace: the early-warning signal for the monocular
    scale-decay spiral (the turn-replay collapse signature is per-segment scale
    0.51 → 0.05 long before ATE explodes).

    For each consecutive ``seg``-frame window, the ratio of estimated to
    ground-truth path length, normalized by the GLOBAL ratio (monocular scale is
    free, so only drift of the per-segment scale around the global fit matters;
    a scale-stable trajectory shows all segments ≈ 1.0). Position-only — works
    with GPS ground truth (Malaga) as well as full poses.

    ``pose_ok``: optional per-frame health flags; steps touching a held/weak pose
    (zero displacement during recovery bursts) are excluded from both sums.

    Returns {"seg_scales": [...], "seg_scale_min", "seg_scale_max",
    "seg_scale_worst" (max |log2 s| deviation), "n_segments"} — empty dict when
    the trajectory is too short (< 2 segments).
    """
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    d_est = np.linalg.norm(np.diff(est, axis=0), axis=1)
    d_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    good = d_gt > 1e-9
    if pose_ok is not None:
        f = np.asarray(pose_ok, bool)[:n]
        good = good & f[:-1] & f[1:]
    scales = []
    for s0 in range(0, n - 1, seg):
        m = good[s0 : s0 + seg]
        ge, gg = d_est[s0 : s0 + seg][m].sum(), d_gt[s0 : s0 + seg][m].sum()
        if m.sum() >= seg // 2 and gg > 1e-9:
            scales.append(ge / gg)
    if len(scales) < 2:
        return {}
    s_global = float(np.median(scales))
    if s_global <= 1e-12:
        return {}
    rel = np.asarray(scales) / s_global
    return {
        "seg_scales": [round(float(x), 4) for x in rel],
        "seg_scale_min": round(float(rel.min()), 4),
        "seg_scale_max": round(float(rel.max()), 4),
        "seg_scale_worst": round(float(np.max(np.abs(np.log2(rel)))), 4),
        "n_segments": len(scales),
    }


def kitti_t_err_pct_pos(est_positions: np.ndarray, gt_positions: np.ndarray,
                        lengths=(100, 200, 300, 400, 500, 600, 700, 800),
                        step: int = 10):
    """Position-only KITTI-style translation drift, for GPS ground truth with no
    rotations (Malaga — reference ``src/main.py:31-47`` uses GPS columns as GT).

    The standard metric (:func:`kitti_odometry_error`) re-anchors each segment by
    its starting POSE; without GT rotations the segment is instead rigidly
    Umeyama-aligned (rotation+translation; scale fixed by ONE global Sim(3) fit so
    per-segment scale drift stays visible) and the drift is the endpoint error per
    meter of segment length. This quantifies exactly the reference's qualitative
    "locally consistent" criterion (statement §1.3.1) on positions alone.

    Returns (t_err_pct, n_segments); (None, 0) when too short.
    """
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    s, _, _ = umeyama_alignment(est, gt)
    est = est * s  # global monocular scale only; per-segment alignment is rigid
    d = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(d)])
    errs = []
    for first in range(0, len(est), step):
        for L in lengths:
            ends = np.searchsorted(dist, dist[first] + L)
            if ends >= len(est):
                break
            seg_e, seg_g = est[first : ends + 1], gt[first : ends + 1]
            _, R, t = umeyama_alignment(seg_e, seg_g, with_scale=False)
            end_aligned = R @ seg_e[-1] + t
            errs.append(np.linalg.norm(end_aligned - seg_g[-1]) / L)
    if not errs:
        return None, 0
    return float(np.mean(errs) * 100.0), len(errs)


def _rot_angle_deg(R: np.ndarray) -> np.ndarray:
    """Rotation angle(s) of (…, 3, 3) rotation matrices, degrees."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    c = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(c))


def _scale_corrected(est_T: np.ndarray, gt_T: np.ndarray) -> np.ndarray:
    """Monocular scale correction: multiply est translations by the Sim(3)
    (Umeyama) scale fitted on positions. Rotations are untouched."""
    s, _, _ = umeyama_alignment(est_T[:, :3, 3], gt_T[:, :3, 3])
    out = est_T.copy()
    out[:, :3, 3] *= s
    return out


def rpe_pose(est_T: np.ndarray, gt_T: np.ndarray, delta: int = 1, with_scale: bool = True) -> dict:
    """Standard relative pose error (TUM convention) over ``delta``-frame intervals.

    ``est_T``, ``gt_T``: (N, 4, 4) cam→world poses. Per interval i the error motion
    is ``E_i = (Q_i^-1 Q_{i+Δ})^-1 (P_i^-1 P_{i+Δ})`` with Q = gt, P = est — each
    interval aligned by its own starting pose (unlike :func:`rpe_stats`'s single
    global alignment). Monocular scale is corrected globally first (Sim(3) scale on
    positions; rotations untouched).

    Returns dict with translation RMSE/median (m per interval) and rotation
    RMSE/median (deg per interval).
    """
    est = np.asarray(est_T, np.float64)
    gt = np.asarray(gt_T, np.float64)
    assert est.shape == gt.shape and est.ndim == 3, (est.shape, gt.shape)
    if with_scale:
        est = _scale_corrected(est, gt)
    rel = lambda T: np.linalg.inv(T[:-delta]) @ T[delta:]
    E = np.linalg.inv(rel(gt)) @ rel(est)
    t_err = np.linalg.norm(E[:, :3, 3], axis=1)
    r_err = _rot_angle_deg(E[:, :3, :3])
    return {
        "trans_rmse_m": float(np.sqrt(np.mean(t_err**2))),
        "trans_median_m": float(np.median(t_err)),
        "rot_rmse_deg": float(np.sqrt(np.mean(r_err**2))),
        "rot_median_deg": float(np.median(r_err)),
    }


def kitti_odometry_error(est_T: np.ndarray, gt_T: np.ndarray,
                         lengths=(100, 200, 300, 400, 500, 600, 700, 800),
                         step: int = 10, with_scale: bool = True):
    """KITTI odometry benchmark metric: translation % and rotation deg/m, averaged
    over all subsequences of the given path lengths (meters), sampled every
    ``step`` frames. Returns (t_err_pct, r_err_deg_per_m, n_segments); (None,
    None, 0) when the trajectory is shorter than the smallest segment length.
    """
    est = np.asarray(est_T, np.float64)
    gt = np.asarray(gt_T, np.float64)
    if with_scale:
        est = _scale_corrected(est, gt)
    # cumulative ground-truth path length per frame
    d = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(d)])
    t_errs, r_errs = [], []
    for first in range(0, len(est), step):
        for L in lengths:
            # first frame whose gt path length from `first` reaches L
            ends = np.searchsorted(dist, dist[first] + L)
            if ends >= len(est):
                break
            rel_gt = np.linalg.inv(gt[first]) @ gt[ends]
            rel_est = np.linalg.inv(est[first]) @ est[ends]
            E = np.linalg.inv(rel_gt) @ rel_est
            t_errs.append(np.linalg.norm(E[:3, 3]) / L)
            r_errs.append(_rot_angle_deg(E[:3, :3]) / L)
    if not t_errs:
        return None, None, 0
    return (float(np.mean(t_errs) * 100.0), float(np.mean(r_errs)), len(t_errs))


class MetricsLogger:
    """Structured per-frame metrics emission (JSONL), replacing the reference's
    print-based observability (``src/main.py:214,231-237``,
    ``src/vo_pipeline.py:267-272``). One dict per frame; cheap host-side."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.rows: list[dict] = []
        self._fh = open(path, "w") if path else None

    def log_frame(self, frame_idx: int, result) -> dict:
        # 0-d tensors of the step's FrameResult (or plain numbers): one .item() each,
        # on the host side of the loop, never inside process_frame
        val = lambda x: x.item() if hasattr(x, "item") else x
        row = {
            "frame": int(frame_idx),
            "pose_ok": bool(val(result.pose_ok)),
            "tracked": int(val(result.n_tracked)),
            "inliers": int(val(result.n_inliers)),
            "candidates": int(val(result.n_candidates)),
            "promoted": int(val(result.n_promoted)),
            "reproj_rms_px": float(val(result.reproj_rms)),
        }
        self.rows.append(row)
        if self._fh:
            import json

            self._fh.write(json.dumps(row) + "\n")
        return row

    def log_chunk_frame(self, frame_idx: int, pose_ok: bool, inliers: int) -> dict:
        """Reduced per-frame row for throughput (chunked-scan) mode, where only
        (R, t, pose_ok, n_inliers) come back from the device per frame. Rows
        carry a MONOTONIC timestamp (NTP steps during a multi-hour replay must
        not skew rate computation) so steady-state frames/s can be computed
        excluding the one-time compile (all frames of one chunk share it).

        ``inliers < 0`` is the host loop's "not measured" sentinel (held anchor
        poses during recovery have no PnP solve) and is logged as null so inlier
        analysis can't mistake synthesized rows for real zero-inlier frames."""
        import time

        row = {"frame": int(frame_idx), "pose_ok": bool(pose_ok),
               "inliers": int(inliers) if inliers >= 0 else None,
               "t": round(time.monotonic(), 3)}
        self.rows.append(row)
        if self._fh:
            import json

            self._fh.write(json.dumps(row) + "\n")
        return row

    def log_seg_scales(self, seg_scales: list) -> None:
        """Append the per-segment metric-scale trace (one row per 50-frame
        segment, normalized to the trajectory's median scale — see
        :func:`segment_scale_stats`) to the JSONL stream. These are end-of-run
        rows, not per-frame rows, so they are NOT appended to ``self.rows``
        (summary statistics stay per-frame)."""
        if self._fh:
            import json

            for i, s in enumerate(seg_scales):
                self._fh.write(json.dumps({"seg": i, "seg_scale": s}) + "\n")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def summary(self) -> dict:
        if not self.rows:
            return {}
        import statistics

        inl = [r["inliers"] for r in self.rows if r.get("inliers") is not None]
        out = {
            # per-frame metric rows (continuous-operation steps only — bootstrap
            # and held recovery poses have no metrics row); named distinctly so
            # it can't clobber the CLI's trajectory-length "frames"
            "metric_rows": len(self.rows),
            "pose_ok_rate": sum(r["pose_ok"] for r in self.rows) / len(self.rows),
            # excludes "not measured" (null) rows — held recovery anchors
            "mean_inliers": statistics.fmean(inl) if inl else None,
        }
        # full rows only (chunked-scan rows are reduced to pose_ok/inliers)
        full = [r for r in self.rows if "tracked" in r]
        if full:
            out["mean_tracked"] = statistics.fmean(r["tracked"] for r in full)
            out["mean_reproj_rms_px"] = statistics.fmean(r["reproj_rms_px"] for r in full)
        return out

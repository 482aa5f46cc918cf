#!/usr/bin/env python3
"""Window-by-window lock-step of the port against the JAX package, every window started
from the JAX package's own state.

A whole-run comparison of a long sequence tells little: the first near-tied MSAC winner
that the two packages' SVDs round apart splits the runs, and they drift apart from there.
Here the JAX package (``lcvo_tpu``, on the CPU) runs the sequence once, uninterrupted, and
saves its checkpoint at every window start; the port resumes each of those files
(``VisualOdometry.resume``: the state, the BA window, the host lists and the key chain, so
the same draws) and runs the window's frames. Every window starts from one state in both
packages, so no divergence carries from one window to the next, and the windows' drifts
pair up.

    # the JAX side: the states and the uninterrupted continuation of every window
    python tools/port_segment_lockstep.py jax --data-root DIR --config configs/turn_robust.yaml \\
        --seed 1 --window 96 --out runs/segments
    # states without their image leaves, host lists cut (what goes to a card)
    python tools/port_segment_lockstep.py strip --segments runs/segments --out runs/segments_up
    # the port from each state: on the CPU from the same files, or on the card
    python tools/port_segment_lockstep.py port --segments runs/segments --data-root DIR \\
        --device cpu --out runs/segments/port_cpu.json
    python tools/port_segment_lockstep.py port --segments runs/segments_up \\
        --render kitti-turn --device cuda --out chiprun_out/port_cuda.json
    # the two best PnP MSAC scores, from one JAX state, where the runs first part
    python tools/port_segment_lockstep.py probe --segments runs/segments --data-root DIR \\
        --port runs/segments/port_cpu.json --out runs/segments/probe.json
    # the per-window table, JAX / port CPU / port card, and its summary
    python tools/port_segment_lockstep.py table --segments runs/segments \\
        --port port_cpu=runs/segments/port_cpu.json port_cuda=chiprun_out/port_cuda.json \\
        --probe runs/segments/probe.json --out lcvo_tpu_torch/data/segments_kitti_turn_2760.json
    # the drift tests over the windows of several tables (seeds)
    python tools/port_segment_lockstep.py pool --tables A.json B.json

Windows start at chunk boundaries (``--window`` frames apart, the JAX package's own
``checkpoint_every`` rule) or at the ``produced`` counts given with ``--starts``, and end
where the next one starts (the last at the end of the sequence). Per window the report
gives the unaligned camera-center distance to the JAX run at the window's end and its
largest value, the share of entries with equal pose_ok, the first frame whose pose_ok or
PnP inlier count differs, and each run's drift against ground truth: scale as
``log2(s_end / s_start)`` with ``s = |dc| / |dgt|`` over the window's first and last
``DRIFT_SPAN`` entries, and rotation as the angle between the estimated and the true
rotation over the window. The summary: the median and largest distance, a paired sign
test (``scipy.stats.binomtest``) of |scale drift|, port against JAX, and the paired
difference of the signed scale drift (t-test, Wilcoxon).

``jax`` and ``probe`` import the JAX package (on the CPU); ``port`` and ``table`` do not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from lcvo_tpu_torch.utils.segments import (  # noqa: E402
    SEGMENTS, Frames, compare_window, dataset_frames, entries_of, render_frames,
    replay_config, rounded, run_port_window)

CHUNK = 16
DRIFT_SPAN = 16          # entries at each end of a window that give its scale
NEAR_TIE_REL = 1e-3      # two best MSAC scores this close (relative) are a near-tie


def load_configs(config: str | None, seed: int, H: int, W: int, gap: int, jax_side: bool):
    """(the port's, the JAX package's or None) configuration of a replay as the CLIs load
    it: the file, the frames' size and the dataset's bootstrap gap, and ``seed``."""
    path = os.path.join(ROOT, config) if config and not os.path.isabs(config) else config
    tcfg = replay_config(path, seed, H, W, gap)
    if not jax_side:
        return tcfg, None
    from lcvo_tpu.config import load_config as jload

    return tcfg, jload(path, overrides={"image_height": H, "image_width": W, "seed": seed,
                                        "bootstrap": {"frame_gap": gap}})


# -- the JAX side ------------------------------------------------------------------------

def run_jax(vo, frames: Frames, loop: str, out_dir: str, window: int | None = None,
            starts=None, chunk: int = CHUNK) -> dict:
    """Run the JAX package's host loop ``vo`` over ``frames`` uninterrupted (``loop``:
    "chunked" = ``run_chunked``, "run" = the per-frame loop), saving its checkpoint into
    ``out_dir`` at each window start: every chunk boundary ``window`` frames past the
    last (the package's ``checkpoint_every``), or each ``produced`` count in ``starts``
    where the package offers a save there (chunk boundaries; healthy frames of ``run``).
    Returns the segments record (also written to ``out_dir/segments.json``): the
    windows, each with its state file and the JAX run's entries over it."""
    os.makedirs(out_dir, exist_ok=True)
    want = None if starts is None else set(int(s) for s in starts)
    saved: list[tuple[int, int, str]] = []    # (produced, entries, file)
    cls_save = type(vo).save

    def save(path, produced):
        if want is None or produced in want:
            name = f"state_{produced:05d}.npz"
            cls_save(vo, os.path.join(out_dir, name), produced)
            saved.append((produced, len(vo.trajectory), name))

    vo.save = save
    ninl: list[int] = []
    every = window if want is None else 1
    t0 = time.perf_counter()
    if loop == "chunked":
        vo.run_chunked(frames.range(0, frames.n), chunk=chunk, n_frames=frames.n,
                       checkpoint_every=every, checkpoint_path="(windows)",
                       on_chunk=lambda s, R, t, ok, n: ninl.extend(int(x) for x in n))
    elif loop == "run":
        vo.run(frames.range(0, frames.n), frames.n, checkpoint_every=every,
               checkpoint_path="(windows)",
               on_frame=lambda i, r: ninl.append(int(np.asarray(r.n_inliers))))
    else:
        raise ValueError(loop)
    wall = time.perf_counter() - t0
    del vo.save
    if want is not None and {p for p, _, _ in saved} != want:
        raise RuntimeError(f"the JAX run offered no save at {sorted(want - {p for p, _, _ in saved})}")
    gap = vo.cfg.bootstrap.frame_gap
    run = entries_of(vo.poses, vo.pose_ok_flags, ninl)
    windows = []
    for j, (start, e0, name) in enumerate(saved):
        end = saved[j + 1][0] if j + 1 < len(saved) else frames.n
        e1 = saved[j + 1][1] if j + 1 < len(saved) else len(run["pose_ok"])
        w = {"start": start, "end": end, "entry0": e0, "state": name,
             "jax": {k: v[e0:e1] for k, v in run.items()},
             "anchor": {k: v[e0 - 1] for k, v in run.items() if k in ("centers", "rotations")}}
        if frames.gt_T is not None:
            T = frames.gt_T[gap + e0 - 1: gap + e1]
            w["gt"] = {"centers": rounded(T[:, :3, 3]),
                       "rotations": rounded(T[:, :3, :3].reshape(-1, 9))}
        windows.append(w)
    whole = {}
    if frames.gt_T is not None:
        from lcvo_tpu_torch.metrics import ate_rmse

        est = np.asarray(run["centers"])
        whole["jax_ate_m"] = float(ate_rmse(est, frames.gt_T[gap: gap + len(est), :3, 3]))
    rec = {**whole, "loop": loop, "chunk": chunk, "gap": gap, "n_frames": frames.n, "window": window,
           "starts": sorted(want) if want is not None else None, "seed": vo.cfg.seed,
           "source": frames.describe, "jax_wall_s": wall, "jax_entries": len(run["pose_ok"]),
           "jax_rebootstraps": int(vo.n_rebootstraps), "windows": windows}
    with open(os.path.join(out_dir, SEGMENTS), "w") as fh:
        json.dump(rec, fh, separators=(",", ":"))
    return rec


# -- states for a card -------------------------------------------------------------------

def strip_segments(src_dir: str, dst_dir: str, keep_gt: bool = True) -> dict:
    """Copy a segments directory with every state stripped
    (``utils/checkpoint.py::strip_checkpoint``: no image leaves, host lists cut to what a
    resumed loop reads), and without the windows' ground truth unless ``keep_gt``.
    Returns the bytes written."""
    from lcvo_tpu_torch.utils.checkpoint import strip_checkpoint

    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(src_dir, SEGMENTS)) as fh:
        rec = json.load(fh)
    total = 0
    for w in rec["windows"]:
        strip_checkpoint(os.path.join(src_dir, w["state"]), os.path.join(dst_dir, w["state"]))
        total += os.path.getsize(os.path.join(dst_dir, w["state"]))
        if not keep_gt:
            w.pop("gt", None)
    path = os.path.join(dst_dir, SEGMENTS)
    with open(path, "w") as fh:
        json.dump(rec, fh, separators=(",", ":"))
    return {"states_bytes": total, "segments_json_bytes": os.path.getsize(path)}


# -- the port side -----------------------------------------------------------------------

def run_port(cfg, seg_dir: str, frames: Frames, device: str, starts=None) -> dict:
    """Every window of ``seg_dir`` (those starting at ``starts`` if given) through the
    port: one host loop resumed window after window."""
    from lcvo_tpu_torch.pipeline import VisualOdometry

    with open(os.path.join(seg_dir, SEGMENTS)) as fh:
        rec = json.load(fh)
    vo = VisualOdometry(cfg, frames.K, device=device)
    return {"device": device, "windows": [
        {"start": w["start"], **run_port_window(vo, seg_dir, rec, w, frames)}
        for w in rec["windows"] if starts is None or w["start"] in starts]}


# -- comparison --------------------------------------------------------------------------

def _angle_deg(R: np.ndarray) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def drift(centers, rotations, gt_centers, gt_rotations, span: int = DRIFT_SPAN) -> dict:
    """A window's drift against ground truth, from its anchor entry (the state it started
    from, first) to its last: scale as ``log2(s_end / s_start)``, ``s = |dc| / |dgt|``
    over the first and the last ``span`` steps, and rotation as the angle (degrees)
    between the estimated and the true rotation from the anchor to the last entry."""
    c, g = np.asarray(centers, np.float64), np.asarray(gt_centers, np.float64)
    R = np.asarray(rotations, np.float64).reshape(-1, 3, 3)
    G = np.asarray(gt_rotations, np.float64).reshape(-1, 3, 3)
    k = min(span, len(c) - 1)
    if k < 1:
        return {"scale_log2": None, "rot_deg": None}

    def s(a, b):
        dg = np.linalg.norm(g[b] - g[a])
        return np.linalg.norm(c[b] - c[a]) / dg if dg > 0 else np.nan

    s0, s1 = s(0, k), s(len(c) - 1 - k, len(c) - 1)
    scale = float(np.log2(s1 / s0)) if s0 > 0 and s1 > 0 and np.isfinite(s0 / s1) else None
    rel_est = R[0].T @ R[-1]
    rel_gt = G[0].T @ G[-1]
    return {"scale_log2": scale, "rot_deg": _angle_deg(rel_est.T @ rel_gt)}


def window_drift(w: dict, entries: dict) -> dict | None:
    if "gt" not in w:
        return None
    c = [w["anchor"]["centers"]] + list(entries["centers"])
    R = [w["anchor"]["rotations"]] + list(entries["rotations"])
    return drift(c, R, w["gt"]["centers"], w["gt"]["rotations"])


def sign_test(port_abs, jax_abs) -> dict:
    """Paired sign test of |drift|: windows where the port drifts more against those
    where JAX does (ties dropped); two-sided p, and the one-sided p of "the port drifts
    more"."""
    from scipy.stats import binomtest

    pairs = [(p, j) for p, j in zip(port_abs, jax_abs) if p is not None and j is not None]
    worse = sum(p > j for p, j in pairs)
    better = sum(p < j for p, j in pairs)
    n = worse + better
    if n == 0:
        return {"port_worse": 0, "port_better": 0, "ties": len(pairs), "p_two_sided": 1.0,
                "p_port_worse": 1.0}
    return {"port_worse": worse, "port_better": better, "ties": len(pairs) - n,
            "p_two_sided": float(binomtest(worse, n, 0.5).pvalue),
            "p_port_worse": float(binomtest(worse, n, 0.5, alternative="greater").pvalue)}


def summarise(rows: list, key: str) -> dict:
    d = [r[key]["distance_m_max"] for r in rows if r.get(key) and "distance_m_max" in r[key]]
    e = [r[key]["distance_m_end"] for r in rows if r.get(key) and "distance_m_end" in r[key]]
    if not d:
        return {}
    return {"windows": len(d), "distance_m_max_median": float(np.median(d)),
            "distance_m_max_max": float(np.max(d)), "distance_m_end_median": float(np.median(e)),
            "pose_ok_equal_all": all(r[key]["pose_ok_equal_share"] == 1.0 for r in rows
                                     if r.get(key) and "pose_ok_equal_share" in r[key]),
            "parted_windows": sum(r[key].get("first_parted_frame") is not None for r in rows
                                  if r.get(key)),
            "apart_windows": sum(r[key].get("first_frame") is not None for r in rows
                                 if r.get(key))}


def summarise_probes(probes: list) -> dict:
    """How the probed windows part: near-ties, the same winner in both packages, the same
    inlier count from one state, and on the JAX step's own PnP inputs whether the port's
    ``pnp_ransac`` is nearer the JAX package's op-by-op run than the JAX package's
    compiled run is (the parting is XLA's compilation) and whether all three agree."""
    done = [p for p in probes if p.get("probed")]
    pnp = [p["pnp_on_the_jax_steps_inputs"] for p in done]
    return {"probed": len(done), "not_probed": len(probes) - len(done),
            "near_tie": sum(p["near_tie"] for p in done),
            "same_winner": sum(p["same_winner"] for p in done),
            "same_inliers_from_one_state": sum(p["same_inliers_from_one_state"] for p in done),
            "pnp_port_nearer_jax_op_by_op_than_jax_is": sum(
                x["port_vs_jax_op_by_op"]["t_max"] < x["jax_op_by_op_vs_jax"]["t_max"] for x in pnp),
            # on the JAX step's own PnP inputs: windows where a run's MSAC winner is not
            # the JAX package's compiled one, and the JAX package's top-two gap there
            **{f"pnp_winner_{k}_differs_from_jax": [
                {"frame": p["frame"], "jax_gap_rel": x["winner"]["jax"]["gap_rel"],
                 "gap_rel": x["winner"][k]["gap_rel"]}
                for p, x in zip(done, pnp)
                if "winner" in x and x["winner"][k]["best"] != x["winner"]["jax"]["best"]]
               for k in ("jax_op_by_op", "port")},
            "pnp_all_three_within_1e-5": sum(
                max(x["port_vs_jax"]["t_max"], x["jax_op_by_op_vs_jax"]["t_max"]) < 1e-5
                for x in pnp),
            # over every probed draw: P3P hypotheses whose validity flag parts, and the
            # median of the draws' 99th percentile of |dR|, for each pair of runs
            "p3p_hypotheses": sum(x["p3p"]["hypotheses"] for x in pnp),
            **{f"p3p_{k}": {
                "valid_flags_differ": sum(x["p3p"][k]["valid_flags_differ"] for x in pnp),
                "R_diff_q99_median": float(np.median([x["p3p"][k]["R_diff_q50_q99_max"][1]
                                                      for x in pnp])) if pnp else None}
               for k in ("jax_op_by_op_vs_jax", "port_vs_jax", "port_vs_jax_op_by_op")}}


def build_table(rec: dict, runs: dict, probe: dict | None = None) -> dict:
    """The per-window table: for each run of ``runs`` (name -> the ``port`` command's
    output) its comparison with the JAX run and its drift, each pair of runs compared,
    the probes, and the summary with the sign test of every run against JAX."""
    names = list(runs)
    by_start = {n: {w["start"]: w for w in runs[n]["windows"]} for n in names}
    rows = []
    for w in rec["windows"]:
        s = w["start"]
        row = {"start": s, "end": w["end"], "drift": {"jax": window_drift(w, w["jax"])}}
        for n in names:
            got = by_start[n].get(s)
            if got is None:
                continue
            row[f"{n}_vs_jax"] = compare_window(w["jax"], got, s, w["anchor"]["centers"])
            row["drift"][n] = window_drift(w, got)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                if s in by_start[a] and s in by_start[b]:
                    row[f"{b}_vs_{a}"] = compare_window(by_start[a][s], by_start[b][s], s,
                                                        w["anchor"]["centers"])
        if probe and str(s) in probe:
            row["probe"] = probe[str(s)]
        rows.append(row)
    summary = {}
    keys = [f"{n}_vs_jax" for n in names] + [f"{b}_vs_{a}" for i, a in enumerate(names)
                                               for b in names[i + 1:]]
    for key in keys:
        summary[key] = summarise(rows, key)
    if probe:
        summary["probes"] = summarise_probes(list(probe.values()))
    summary.update(drift_tests(rows, names))
    return {"windows": rows, "summary": summary}


def _drifts(rows: list, name: str, key: str) -> list:
    return [r["drift"][name][key] if r["drift"].get(name) else None for r in rows]


def paired_difference(a: list, b: list) -> dict:
    """``a - b`` over the windows where both are known: mean, median, and the p of a
    paired t-test and of a Wilcoxon signed-rank test (both two-sided)."""
    from scipy.stats import ttest_rel, wilcoxon

    pairs = np.asarray([(x, y) for x, y in zip(a, b) if x is not None and y is not None])
    d = pairs[:, 0] - pairs[:, 1]
    return {"windows": len(d), "mean": float(d.mean()), "median": float(np.median(d)),
            "t_test_p": float(ttest_rel(pairs[:, 0], pairs[:, 1]).pvalue),
            "wilcoxon_p": float(wilcoxon(pairs[:, 0], pairs[:, 1]).pvalue)}


def drift_tests(rows: list, names: list) -> dict:
    """Each run of ``names`` against the JAX run, window by window: sign tests of |scale
    drift| and of rotation drift, and the paired difference of the signed scale drift;
    each pair of ``names`` (the port against itself on two devices): that difference."""
    out = {}
    jax_scale, jax_rot = _drifts(rows, "jax", "scale_log2"), _drifts(rows, "jax", "rot_deg")
    for n in names:
        scale = _drifts(rows, n, "scale_log2")
        out[f"{n}_sign_test_abs_scale_drift"] = sign_test(
            [None if p is None else abs(p) for p in scale],
            [None if j is None else abs(j) for j in jax_scale])
        out[f"{n}_sign_test_rot_drift"] = sign_test(_drifts(rows, n, "rot_deg"), jax_rot)
        out[f"{n}_minus_jax_scale_drift"] = paired_difference(scale, jax_scale)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            out[f"{b}_minus_{a}_scale_drift"] = paired_difference(
                _drifts(rows, b, "scale_log2"), _drifts(rows, a, "scale_log2"))
    return out


# -- the probe: the two best PnP scores from one JAX state -------------------------------

def _top2(score: np.ndarray) -> dict:
    s = np.asarray(score, np.float64).reshape(-1)
    order = np.argsort(np.where(np.isnan(s), -np.inf, s), kind="stable")
    a, b = float(s[order[0]]), float(s[order[1]])
    return {"best": int(order[0]), "scores": [a, b],
            "gap_rel": (b - a) / abs(a) if a not in (0.0,) and np.isfinite(a) else None}


def step_diff(jstate, tstate) -> dict:
    """Where two states after one step from the same state differ: the tracks' pixels
    (after KLT, kept by PnP) and landmarks where both are valid, the valid counts, the
    candidates' pixels where both are valid and their counts, the pose."""
    def np_(x):
        return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)

    def pair(a, b, va, vb):
        both = np_(va).astype(bool) & np_(vb).astype(bool)
        d = np.abs(np_(a)[both] - np_(b)[both])
        return {"max": float(d.max()) if d.size else 0.0,
                "median": float(np.median(d)) if d.size else 0.0,
                "valid": [int(np_(va).sum()), int(np_(vb).sum())], "both": int(both.sum())}

    jt, tt = jstate.tracks, tstate.tracks
    jc, tc = jstate.cands, tstate.cands
    return {"tracks_px": pair(jt.P, tt.P, jt.valid, tt.valid),
            "landmarks": pair(jt.X, tt.X, jt.valid, tt.valid),
            "candidates_px": pair(jc.C, tc.C, jc.valid, tc.valid),
            "R_max": float(np.abs(np_(jstate.R) - np_(tstate.R)).max()),
            "t_max": float(np.abs(np_(jstate.t) - np_(tstate.t)).max())}


def pnp_same_inputs(jcfg, K, key, X, x_obs, valid) -> dict:
    """``pnp_ransac`` of both packages on the very inputs of the JAX package's compiled
    step (its key, landmarks, observations, valid mask): the JAX package's compiled,
    the JAX package's op by op and the port's pose and inlier count, and how far apart."""
    import jax
    import jax.numpy as jnp
    import torch

    import lcvo_tpu.ops.pnp as jpnp
    from lcvo_tpu_torch.ops import pnp as tpnp
    from lcvo_tpu_torch.utils import jax_random

    import lcvo_tpu.ops.ransac as jransac
    from lcvo_tpu_torch.ops import ransac as transac

    thresh = jcfg.ransac.pnp_thresh_px / float(np.asarray(K)[0, 0])
    args = (jnp.asarray(key), jnp.asarray(X), jnp.asarray(x_obs), jnp.asarray(valid))
    kw = dict(thresh=thresh, n_hyp=jcfg.ransac.pnp_hypotheses,
              refine_iters=jcfg.ransac.refine_iters)
    out, scores = {}, {}
    out["jax"], scores["jax"] = _with_scores(jransac, lambda: jpnp.pnp_ransac(*args, **kw),
                                             jpnp.pnp_ransac)
    with jax.disable_jit():
        out["jax_op_by_op"], scores["jax_op_by_op"] = _with_scores(
            jransac, lambda: jpnp.pnp_ransac(*args, **kw), jpnp.pnp_ransac)
    # ``key`` is already the PnP key: its uniforms are the port's draw
    u = torch.from_numpy(jax_random.uniform(np.asarray(key, np.uint32),
                                            (jcfg.ransac.pnp_hypotheses, 3)))
    out["port"], scores["port"] = _with_scores(transac, lambda: tpnp.pnp_ransac(
        u, *(torch.from_numpy(np.array(a)) for a in (X, x_obs, valid)),
        thresh, jcfg.ransac.pnp_hypotheses, jcfg.ransac.refine_iters))
    pose = {k: (np.asarray(v[0], np.float64), np.asarray(v[1], np.float64), int(v[3]))
            for k, v in out.items()}

    def diff(a, b):
        return {"R_max": float(np.abs(pose[a][0] - pose[b][0]).max()),
                "t_max": float(np.abs(pose[a][1] - pose[b][1]).max())}

    return {"n_inliers": {k: p[2] for k, p in pose.items()},
            "winner": {k: _top2(v) for k, v in scores.items()},
            "port_vs_jax": diff("port", "jax"), "jax_op_by_op_vs_jax": diff("jax_op_by_op", "jax"),
            "port_vs_jax_op_by_op": diff("port", "jax_op_by_op"),
            "p3p": p3p_same_inputs(jcfg, key, X, x_obs, valid)}


def _with_scores(module, call, jitted=None):
    """``call()`` with ``module.best_hypothesis`` recording the MSAC scores it is given
    (a JAX callback in a JAX trace; ``jitted``'s cached trace is dropped before and after,
    so that the recorder is traced in and then out): the result and the last scores."""
    import jax

    seen, orig = [], module.best_hypothesis

    def best(score):
        if hasattr(score, "detach"):
            seen.append(score.detach().cpu().numpy())
        else:
            jax.debug.callback(lambda s: seen.append(np.asarray(s)), score)
        return orig(score)

    module.best_hypothesis = best
    if jitted is not None:
        jitted.clear_cache()
    try:
        res = call()
        if jitted is not None:
            jax.block_until_ready(res)
        jax.effects_barrier()
    finally:
        module.best_hypothesis = orig
        if jitted is not None:
            jitted.clear_cache()
    return res, seen[-1]


def p3p_same_inputs(jcfg, key, X, x_obs, valid) -> dict:
    """Every P3P hypothesis of one PnP draw (the same minimal sets and bearings) from the
    JAX package compiled and op by op and from the port: how many validity flags and how
    far the rotations of hypotheses valid in both part, for each pair. A float32
    Durand-Kerner on a quartic with clustered roots rounds apart in any two runs."""
    import jax
    import jax.numpy as jnp
    import torch

    import lcvo_tpu.ops.pnp as jpnp
    import lcvo_tpu.ops.ransac as jransac
    from lcvo_tpu_torch.ops import pnp as tpnp

    idx = np.asarray(jransac.sample_minimal_sets(jnp.asarray(key), len(X), jnp.asarray(valid),
                                                 jcfg.ransac.pnp_hypotheses, 3))
    Pw, xo = np.asarray(X)[idx], np.asarray(x_obs)[idx]
    f = jnp.concatenate([jnp.asarray(xo), jnp.ones(xo.shape[:-1] + (1,), jnp.float32)], -1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)
    out = {"jax": jax.jit(jpnp.p3p_grunert)(jnp.asarray(Pw), f)}
    with jax.disable_jit():
        out["jax_op_by_op"] = jpnp.p3p_grunert(jnp.asarray(Pw), f)
    out["port"] = tpnp.p3p_grunert(torch.from_numpy(Pw), torch.from_numpy(np.array(f)))
    hyp = {k: (np.asarray(R).reshape(-1, 9), np.asarray(ok).reshape(-1))
           for k, (R, _, ok) in out.items()}

    def pair(a, b):
        (Ra, oa), (Rb, ob) = hyp[a], hyp[b]
        both = oa & ob
        d = np.abs(Ra - Rb)[both].max(axis=1)
        return {"valid_flags_differ": int((oa != ob).sum()),
                "R_diff_q50_q99_max": [float(q) for q in np.quantile(d, [0.5, 0.99, 1.0])]}

    return {"hypotheses": int(hyp["jax"][1].size), "jax_op_by_op_vs_jax": pair("jax_op_by_op", "jax"),
            "port_vs_jax": pair("port", "jax"), "port_vs_jax_op_by_op": pair("port", "jax_op_by_op")}


_PROBES: dict = {}      # (id(jcfg), id(K)): the JAX host loop and its recording step
_SEEN: list = []        # MSAC scores, as the recording argmins see them
_PNP_IN: list = []      # the JAX step's pnp_ransac inputs


def _jax_probe_step(jcfg, K):
    """A JAX host loop to resume into and the JAX step compiled with two recorders: its
    MSAC argmin's scores go to ``_SEEN``, its ``pnp_ransac`` inputs to ``_PNP_IN``. Made
    once per configuration: the recorders are traced into the step at its first call."""
    import jax
    import jax.numpy as jnp

    import lcvo_tpu.ops.pnp as jpnp
    import lcvo_tpu.ops.ransac as jransac
    from lcvo_tpu.pipeline import VisualOdometry as JVO
    from lcvo_tpu.pipeline import make_process_frame as jmake

    key = (id(jcfg), id(K))
    if key in _PROBES:
        return _PROBES[key]
    orig_best, orig_pnp = jransac.best_hypothesis, jpnp.pnp_ransac

    def best(score):
        jax.debug.callback(lambda s: _SEEN.append(np.asarray(s)), score)
        return orig_best(score)

    def pnp(k, X, x, v, **kw):
        jax.debug.callback(lambda *a: _PNP_IN.append([np.asarray(b) for b in a]), k, X, x, v)
        return orig_pnp(k, X, x, v, **kw)

    fn = jax.jit(jmake(jcfg, jnp.asarray(K, jnp.float32)))

    def step(state, image, k):
        # pnp_ransac is jitted on its own: its cached trace is dropped so that the step's
        # first trace takes the recorders, and again after, so later traces do not
        jransac.best_hypothesis, jpnp.pnp_ransac = best, pnp
        orig_pnp.clear_cache()
        try:
            out = fn(state, image, k)
            jax.block_until_ready(out)
            jax.effects_barrier()
        finally:
            jransac.best_hypothesis, jpnp.pnp_ransac = orig_best, orig_pnp
            orig_pnp.clear_cache()
        return out

    _PROBES[key] = (JVO(jcfg, K), step)
    return _PROBES[key]


def probe_frame(jcfg, tcfg, K, seg_dir: str, w: dict, frames: Frames, frame: int,
                chunk: int = CHUNK) -> dict:
    """From the JAX package's state just before ``frame`` (its checkpoint at the window
    start, then its steps with the chunk keys the run used), the step at ``frame`` in
    both packages: each one's two best PnP MSAC scores, its winner and its inlier count,
    where the states after the step differ (``step_diff``), and ``pnp_same_inputs`` on
    the JAX step's PnP inputs. The JAX steps run one at a time (``_process`` and, on the
    cadence, ``_ba_step``), which is the chunk's scan body. Windows with a re-bootstrap
    before ``frame`` are not probed."""
    import jax
    import jax.numpy as jnp
    import torch

    from lcvo_tpu_torch.ops import ransac as transac
    from lcvo_tpu_torch.pipeline import VisualOdometry, make_process_frame, uniforms_fn

    start = w["start"]
    k = frame - start
    if any(n < 0 for n in w["jax"]["n_inliers"][:k + 1]):
        return {"frame": frame, "probed": False, "why": "a re-bootstrap before the frame"}
    jvo, jstep = _jax_probe_step(jcfg, K)
    jvo.resume(os.path.join(seg_dir, w["state"]))
    full = (w["end"] - start) // chunk * chunk
    for i in range(k + 1):
        if i < full:
            if i % chunk == 0:
                keys = jax.random.split(jvo._next_key(), chunk)
            key = keys[i % chunk]
        else:                     # tail frames: the per-frame path's key
            key = jvo._next_key()
        if i == k:
            break
        jvo.state, _ = jvo._process(jvo.state, jnp.asarray(frames.frame(start + i)), key)
        if jvo.window is not None and int(jvo.state.frame_idx) % jcfg.ba.keyframe_every == 0:
            jvo._ba_step()
    state_path = os.path.join(seg_dir, f"probe_{frame:05d}.npz")
    jvo.save(state_path, frame)
    img = frames.frame(frame)
    _SEEN.clear()
    _PNP_IN.clear()
    jnew, jres = jstep(jvo.state, jnp.asarray(img), key)
    jax_scores, pnp_in = _SEEN.pop(), _PNP_IN.pop()

    orig = transac.best_hypothesis

    def best(score):
        _SEEN.append(score.detach().cpu().numpy())
        return orig(score)

    tvo = VisualOdometry(tcfg, K, device="cpu")
    tvo.resume(state_path)
    os.remove(state_path)
    u = uniforms_fn(tcfg.ransac.pnp_hypotheses, "cpu")(np.asarray(key)[None])[0]
    transac.best_hypothesis = best
    try:
        tnew, tres = make_process_frame(tcfg, K, "cpu")(tvo.state, torch.from_numpy(np.array(img)), u)
    finally:
        transac.best_hypothesis = orig
    port_scores = _SEEN.pop()
    jbest = _top2(jax_scores)["best"]

    def res(scores, r):
        t = _top2(scores)
        t["score_of_jax_best"] = float(np.asarray(scores).reshape(-1)[jbest])
        return {**t, "n_inliers": int(r.n_inliers), "pose_ok": bool(r.pose_ok)}

    jt, pt = res(jax_scores, jres), res(port_scores, tres)
    return {"frame": frame, "probed": True,
            "pnp_on_the_jax_steps_inputs": pnp_same_inputs(jcfg, K, *pnp_in),
            "jax": jt, "port": pt, "port_vs_jax": step_diff(jnew, tnew),
            "same_winner": jt["best"] == pt["best"],
            "same_inliers_from_one_state": jt["n_inliers"] == pt["n_inliers"],
            "near_tie": all(t["gap_rel"] is not None and t["gap_rel"] < NEAR_TIE_REL
                            for t in (jt, pt))}


# -- command line ------------------------------------------------------------------------

def _digits(x, n: int = 7):
    """``x`` with every float cut to ``n`` significant digits."""
    if isinstance(x, float):
        return float(f"{x:.{n}g}")
    if isinstance(x, dict):
        return {k: _digits(v, n) for k, v in x.items()}
    if isinstance(x, list):
        return [_digits(v, n) for v in x]
    return x


def _source(args, device="cpu") -> Frames:
    if getattr(args, "render", None):
        return render_frames(args.render, args.frames, device)
    first = getattr(args, "first_frame", 0)
    src = dataset_frames(args.data_root, args.layout, args.frames and args.frames - first)
    if not first:
        return src

    def frame(i):   # the directory holds frames first.. of the sequence
        if i < first:
            raise IndexError(f"frame {i} is before the slice's first, {first}")
        return src.frame(i - first)

    return Frames(frame, first + src.n, src.K, src.gt_T, {**src.describe, "first_frame": first})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def frames_args(p, render: bool = False):
        p.add_argument("--data-root", default=None)
        p.add_argument("--layout", default="kitti")
        p.add_argument("--frames", type=int, default=None)
        if render:
            p.add_argument("--render", default=None, choices=("kitti-turn",),
                           help="render the frames on --device instead of reading files")

    pj = sub.add_parser("jax", help="the JAX package's run and window states (CPU)")
    frames_args(pj)
    pj.add_argument("--config", default=os.path.join("configs", "turn_robust.yaml"))
    pj.add_argument("--seed", type=int, default=1)
    pj.add_argument("--loop", default="chunked", choices=("chunked", "run"))
    pj.add_argument("--window", type=int, default=6 * CHUNK)
    pj.add_argument("--starts", type=int, nargs="*", default=None)
    pj.add_argument("--out", required=True)
    ps = sub.add_parser("strip", help="states without image leaves, for a card")
    ps.add_argument("--segments", required=True)
    ps.add_argument("--out", required=True)
    pp = sub.add_parser("port", help="the port from every window's JAX state")
    frames_args(pp, render=True)
    pp.add_argument("--segments", required=True)
    pp.add_argument("--config", default=os.path.join("configs", "turn_robust.yaml"))
    pp.add_argument("--device", required=True, help="cpu or cuda (no default)")
    pp.add_argument("--starts", type=int, nargs="*", default=None,
                    help="run only the windows that start here")
    pp.add_argument("--first-frame", type=int, default=0,
                    help="the data root holds the sequence from this frame on (a slice)")
    pp.add_argument("--out", required=True)
    pr = sub.add_parser("probe", help="the two best PnP scores where the runs part (CPU)")
    frames_args(pr)
    pr.add_argument("--segments", required=True)
    pr.add_argument("--config", default=os.path.join("configs", "turn_robust.yaml"))
    pr.add_argument("--port", required=True, help="the port command's output (CPU)")
    pr.add_argument("--out", required=True)
    pl = sub.add_parser("pool", help="the drift tests over the windows of several tables")
    pl.add_argument("--tables", nargs="+", required=True)
    pt = sub.add_parser("table", help="the per-window table and its summary")
    pt.add_argument("--segments", required=True)
    pt.add_argument("--port", nargs="+", required=True,
                    help="NAME=FILE[,FILE...] of port outputs (a run's windows in parts)")
    pt.add_argument("--probe", default=None)
    pt.add_argument("--extra", default=None, help="a JSON object kept under 'about'")
    pt.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    if args.cmd in ("jax", "probe"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.cmd == "jax":
        from lcvo_tpu.pipeline import VisualOdometry as JVO

        src = _source(args)
        H, W = np.asarray(src.frame(0)).shape
        _, jcfg = load_configs(args.config, args.seed, H, W, src.describe.get("gap", 6), True)
        rec = run_jax(JVO(jcfg, src.K), src, args.loop, args.out, window=args.window,
                      starts=args.starts)
        out = {k: v for k, v in rec.items() if k != "windows"}
        out["windows"] = [(w["start"], w["end"]) for w in rec["windows"]]
    elif args.cmd == "strip":
        out = strip_segments(args.segments, args.out)
    elif args.cmd == "port":
        with open(os.path.join(args.segments, SEGMENTS)) as fh:
            rec = json.load(fh)
        if args.frames is None:
            args.frames = rec["n_frames"]
        src = _source(args, args.device)
        H, W = np.asarray(src.frame(args.first_frame)).shape
        tcfg, _ = load_configs(args.config, rec["seed"], H, W, rec["gap"], False)
        out = run_port(tcfg, args.segments, src, args.device, args.starts)
        if args.device.startswith("cuda"):
            import subprocess

            out["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, separators=(",", ":"))
        out = {"device": args.device, "windows": len(out["windows"]),
               "seconds": sum(w["seconds"] for w in out["windows"])}
    elif args.cmd == "probe":
        with open(os.path.join(args.segments, SEGMENTS)) as fh:
            rec = json.load(fh)
        with open(args.port) as fh:
            port = {w["start"]: w for w in json.load(fh)["windows"]}
        if args.frames is None:
            args.frames = rec["n_frames"]
        src = _source(args)
        H, W = np.asarray(src.frame(0)).shape
        tcfg, jcfg = load_configs(args.config, rec["seed"], H, W, rec["gap"], True)
        out = {}
        for w in rec["windows"]:
            cmp = compare_window(w["jax"], port[w["start"]], w["start"], w["anchor"]["centers"])
            f = cmp.get("first_frame")
            if f is not None:
                out[str(w["start"])] = probe_frame(jcfg, tcfg, src.K, args.segments, w, src, f,
                                                   rec["chunk"])
                print(json.dumps({"window": w["start"], **out[str(w["start"])]}), flush=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    elif args.cmd == "pool":
        rows, names = [], None
        for path in args.tables:
            with open(path) as fh:
                table = json.load(fh)
            rows += table["windows"]
            names = [n for n in table["about"]["cards"] if names is None or n in names]
        out = {"tables": args.tables, **drift_tests(rows, names)}
    else:
        with open(os.path.join(args.segments, SEGMENTS)) as fh:
            rec = json.load(fh)
        runs = {}
        for item in args.port:      # NAME=FILE[,FILE...]: the windows of every file
            name, paths = item.split("=", 1)
            parts = []
            for path in paths.split(","):
                with open(path) as fh:
                    parts.append(json.load(fh))
            runs[name] = {**parts[0], "windows": [w for p in parts for w in p["windows"]]}
        probe = None
        if args.probe:
            with open(args.probe) as fh:
                probe = json.load(fh)
        table = build_table(rec, runs, probe)
        table["about"] = {"loop": rec["loop"], "chunk": rec["chunk"], "gap": rec["gap"],
                          "n_frames": rec["n_frames"], "seed": rec["seed"],
                          "source": rec["source"], "jax_entries": rec["jax_entries"],
                          "jax_ate_m": rec.get("jax_ate_m"),
                          "jax_rebootstraps": rec["jax_rebootstraps"],
                          "cards": {n: r.get("card") for n, r in runs.items()},
                          "made_by": "tools/port_segment_lockstep.py table",
                          **(json.loads(args.extra) if args.extra else {})}
        with open(args.out, "w") as fh:    # a window a line, 7 significant digits
            rows = ",\n".join(json.dumps(_digits(r), separators=(",", ":"))
                              for r in table["windows"])
            fh.write(f'{{"about":{json.dumps(table["about"])},\n"summary":'
                     f'{json.dumps(table["summary"])},\n"windows":[\n{rows}]}}\n')
        out = table["summary"]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Command-line runner: run the VO pipeline on a dataset (port of ``lcvo_tpu/cli/run.py``).

``python -m lcvo_tpu_torch.cli.run [--config config.yaml] [--dataset kitti] ...`` —
explicit flags override the YAML, which overrides the typed defaults. The flags, the
outputs and the summary's keys and rounding are the reference's. Two differences:
``--device`` (``cuda`` unless the caller names another, as every entry point of this
package has it), and no persistent compile cache: eager PyTorch compiles nothing per
run, so the reference's XLA cache directory has no counterpart here.

``--profile-frames N`` shows where a frame's time goes: ``N`` frames of the run, from
the ``PROFILE_AFTER``-th pose on (past the first graph captures), run under
``utils/profiling.trace``, which writes ``trace.json`` under ``--out``: the program's
spans (``vo.*``, ``graph.*``, ``host.gc``) beside the card's kernels, for Perfetto or
``chrome://tracing``. ``utils/profiling.STAGES`` names the stage of each kernel of a
graph replay.

Outputs (under ``--out``): trajectory ``.npz``, per-frame metrics ``.jsonl``,
trajectory plot ``.png``, ATE/RPE summary printed as one JSON line.

``main`` is :func:`run_and_summarise` (everything up to the files that need no plotting
library), :func:`plot_outputs`, then the summary line. :func:`summarise_only` is ``main``
without the plots, for a machine that has no matplotlib: a caller chooses it knowingly
and says so; the command line itself always plots.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

# poses before --profile-frames starts its trace: the first chunks' graph captures
PROFILE_AFTER = 48


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lcvo_tpu_torch visual odometry runner")
    p.add_argument("--config", default=None, help="YAML config file")
    p.add_argument("--dataset", default=None, help="kitti | malaga | parking | synthetic")
    p.add_argument("--data-root", default=None, help="directory holding the dataset folders")
    p.add_argument("--frames", type=int, default=None, help="limit frame count")
    p.add_argument("--mode", default=None, help="find_new_candidates_method override")
    p.add_argument("--ba", action="store_true", help="enable sliding-window bundle adjustment")
    p.add_argument("--ba-landmarks-only", action="store_true",
                   help="window refinement with ALL keyframe poses frozen: multi-view "
                        "structure correction without pose feedback (the turn-robust mode)")
    p.add_argument("--chunked", action="store_true", help="throughput mode: scan frames in device-resident chunks")
    p.add_argument("--out", default="runs/latest", help="output directory")
    p.add_argument("--viz-every", type=int, default=0, help="dump a dashboard frame every N frames (0 = off)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a resumable checkpoint every N frames (0 = off)")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="resume from a checkpoint saved by --checkpoint-every")
    p.add_argument("--export-video", action="store_true",
                   help="stitch dumped dashboard frames into an mp4 at the end")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises where there is none, pass cpu to run there)")
    p.add_argument("--profile-frames", type=int, default=0, metavar="N",
                   help="write OUT/trace.json: N frames of the run under torch.profiler, the "
                        "program's spans beside the kernels (0 = off)")
    return p


class ProfiledFrames:
    """``utils/profiling.trace(out)`` over ``n`` poses of a run, from its
    ``PROFILE_AFTER``-th pose on (or to the run's end): :meth:`count` is told each pose
    the run emits."""

    def __init__(self, out: str, n: int):
        self.out, self.n = out, n
        self.seen = self.first = 0
        self.stack = contextlib.ExitStack()
        self.on = self.done = False

    def count(self, poses: int) -> None:
        self.seen += poses
        if self.n > 0 and not (self.on or self.done) and self.seen >= PROFILE_AFTER:
            from lcvo_tpu_torch.utils import profiling

            self.stack.enter_context(profiling.trace(self.out))
            self.on, self.first = True, self.seen
        elif self.on and self.seen - self.first >= self.n:
            self.close()

    def close(self) -> None:
        if self.on:
            self.stack.close()
            self.on, self.done = False, True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def summary(self) -> dict:
        """The summary's entries for the trace: its path and the poses it covers."""
        if not self.done:
            return {}
        return {"trace": os.path.join(self.out, "trace.json"),
                "profiled_frames": min(self.seen - self.first, self.n)}


def run_and_summarise(args) -> tuple[dict, dict]:
    """Load the configuration and the dataset, run the odometry, compute the summary and
    write ``metrics.jsonl`` and ``trajectory.npz``. Returns the summary and what
    :func:`plot_outputs` draws from."""
    import numpy as np

    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.datasets import Prefetcher, load_dataset
    from lcvo_tpu_torch.metrics import MetricsLogger, ate_rmse, rpe_stats
    from lcvo_tpu_torch.pipeline import VisualOdometry

    overrides: dict = {}
    if args.dataset:
        overrides["dataset"] = args.dataset
    if args.data_root:
        overrides["data_root"] = args.data_root
    if args.mode:
        overrides["find_new_candidates_method"] = args.mode
    if args.ba or args.ba_landmarks_only:
        overrides["ba"] = {"enabled": True, "landmarks_only": args.ba_landmarks_only}
    cfg = load_config(args.config, overrides)

    ds = load_dataset(cfg.dataset, cfg.data_root)
    n_frames = min(args.frames or ds.n_frames, ds.n_frames)
    first = ds.frame(0)
    H, W = first.shape
    cfg = load_config(args.config, {**overrides, "image_height": H, "image_width": W,
                                    "bootstrap": {"frame_gap": ds.bootstrap_pair[1]}})

    os.makedirs(args.out, exist_ok=True)
    vo = VisualOdometry(cfg, ds.K, device=args.device)
    metrics = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    # cfg.animation: live per-frame dashboard; --viz-every dumps PNGs
    viz_every = args.viz_every or (1 if cfg.animation else 0)
    dash = None
    if viz_every:
        from lcvo_tpu_torch.viz import Dashboard

        dash = Dashboard(ds.K)
    ckpt_path = os.path.join(args.out, "checkpoint.npz")
    profiled = ProfiledFrames(args.out, args.profile_frames)

    with profiled:
        t0 = time.perf_counter()
        if args.chunked:
            # streaming throughput mode: decode-ahead Prefetcher feeds the chunk step
            # chunk by chunk — O(chunk) host memory at any sequence length
            def on_chunk(start, Rs, ts, ok, ninl):
                for j in range(len(ok)):
                    metrics.log_chunk_frame(start + j, bool(ok[j]), int(ninl[j]))
                profiled.count(len(ok))

            if args.resume:
                start = vo.resume(args.resume)
                pf = Prefetcher(ds, start=start, depth=cfg.runtime.prefetch_depth)
                vo.run_chunked_continue(pf, produced=start, n_frames=n_frames,
                                        checkpoint_every=args.checkpoint_every,
                                        checkpoint_path=ckpt_path, on_chunk=on_chunk)
            else:
                pf = Prefetcher(ds, depth=cfg.runtime.prefetch_depth)
                vo.run_chunked(pf, n_frames=n_frames,
                               checkpoint_every=args.checkpoint_every,
                               checkpoint_path=ckpt_path, on_chunk=on_chunk)
            pf.close()
        else:
            def on_frame(i, res):
                metrics.log_frame(i, res)
                profiled.count(1)
                if cfg.debug:
                    print(f"---------- frame {i} ---------- tracked={int(res.n_tracked)} "
                          f"inliers={int(res.n_inliers)} cands={int(res.n_candidates)} "
                          f"promoted={int(res.n_promoted)} rms={float(res.reproj_rms):.2f}")
                if dash is not None and i % viz_every == 0:
                    dash.update(vo.state.prev_image, vo.state, res)
                    dash.render(os.path.join(args.out, f"dash_{i:06d}.png"), show=cfg.animation)
                if cfg.visualization and i and i % 200 == 0:
                    # periodic trajectory plot; trajectory[0] is frame gap's pose →
                    # align GT from gap
                    from lcvo_tpu_torch.viz import plot_trajectory

                    gt_p = ds.gt_positions()
                    if gt_p is not None:
                        gt_p = gt_p[cfg.bootstrap.frame_gap :]
                    plot_trajectory(np.asarray(vo.trajectory), gt_p,
                                    os.path.join(args.out, f"trajectory_{i:06d}.png"),
                                    title=f"{cfg.dataset} @ frame {i}")

            if args.resume:
                start = vo.resume(args.resume)
                vo.run_continue((ds.frame(i) for i in range(start, n_frames)), n_frames, start,
                                on_frame=on_frame, checkpoint_every=args.checkpoint_every,
                                checkpoint_path=ckpt_path)
            else:
                pf = Prefetcher(ds, depth=cfg.runtime.prefetch_depth)
                vo.run(pf, n_frames,
                       on_frame=on_frame, checkpoint_every=args.checkpoint_every,
                       checkpoint_path=ckpt_path)
                pf.close()
        wall = time.perf_counter() - t0
    trace = profiled.summary()

    est = np.asarray(vo.trajectory)

    summary: dict = {
        "dataset": cfg.dataset,
        "frames": len(est),
        "wall_s": round(wall, 2),
        "frames_per_s": round(len(est) / wall, 2) if wall > 0 else None,
        # failure-recovery events this run (survives --resume via the checkpoint);
        # pose_ok_rate below counts the recovery frames as not-ok rows
        "n_rebootstraps": vo.n_rebootstraps,
        **metrics.summary(),
        **trace,
    }
    seg_scales = None
    gt_al = None
    gt = ds.gt_positions()
    if gt is not None and len(est) > 10:
        from lcvo_tpu_torch.metrics import segment_scale_stats

        gap = cfg.bootstrap.frame_gap
        gt_al = gt[gap : gap + len(est)]
        n = min(len(gt_al), len(est))
        summary["ate_rmse_m"] = round(ate_rmse(est[:n], gt_al[:n]), 4)
        rmse, med = rpe_stats(est[:n], gt_al[:n])
        summary["rpe_rmse_m"] = round(rmse, 4)
        summary["rpe_median_m"] = round(med, 4)
        # per-segment metric-scale trace: the scale-decay spiral's early-warning
        # signal; worst-segment deviation surfaces in the summary, the full
        # per-segment trace goes into trajectory.npz + metrics.jsonl
        seg = segment_scale_stats(est[:n], gt_al[:n],
                                  pose_ok=vo.pose_ok_flags[:n])
        if seg:
            seg_scales = seg.pop("seg_scales")
            summary.update(seg)
            metrics.log_seg_scales(seg_scales)
        # standard RPE (per-interval relative pose, rotation included) when the
        # dataset carries full GT poses; GPS-only GT (Malaga) gets the
        # position-based equivalents + explicit n/a rotation fields instead
        gt_T = ds.gt_poses()
        if gt_T is not None and len(vo.poses) >= n:
            from lcvo_tpu_torch.metrics import kitti_odometry_error, rpe_pose

            est_T = np.asarray(vo.poses[:n])
            gt_T_al = gt_T[gap : gap + n]
            if len(gt_T_al) == n:
                rp = rpe_pose(est_T, gt_T_al)
                summary["rpe_trans_rmse_m"] = round(rp["trans_rmse_m"], 4)
                summary["rpe_rot_rmse_deg"] = round(rp["rot_rmse_deg"], 4)
                t_pct, r_dpm, nseg = kitti_odometry_error(est_T, gt_T_al)
                if nseg:
                    summary["kitti_t_err_pct"] = round(t_pct, 3)
                    summary["kitti_r_err_deg_per_m"] = round(r_dpm, 5)
        else:
            from lcvo_tpu_torch.metrics import kitti_t_err_pct_pos

            summary["gt_type"] = "positions_only"  # e.g. Malaga GPS GT
            summary["rpe_rot_rmse_deg"] = "n/a (GPS GT: no rotations)"
            summary["kitti_r_err_deg_per_m"] = "n/a (GPS GT: no rotations)"
            t_pct, nseg = kitti_t_err_pct_pos(est[:n], gt_al[:n])
            if nseg:
                # position-only KITTI-style drift (rigid per-segment alignment,
                # global monocular scale — metrics.kitti_t_err_pct_pos)
                summary["kitti_t_err_pct_pos"] = round(t_pct, 3)

    np.savez(os.path.join(args.out, "trajectory.npz"), positions=est,
             **({"seg_scales": np.asarray(seg_scales)} if seg_scales else {}))
    metrics.close()
    return summary, {"est": est, "gt": gt_al, "dataset": cfg.dataset, "dash": dash}


def plot_outputs(args, summary: dict, run: dict) -> None:
    """``trajectory.png`` (always, as the reference's CLI ends) and, when asked for and
    dashboard frames were dumped, the video, whose path goes into the summary."""
    from lcvo_tpu_torch.viz import export_video, plot_trajectory

    if run["gt"] is not None:
        plot_trajectory(run["est"], run["gt"], os.path.join(args.out, "trajectory.png"),
                        title=f"{run['dataset']}: ATE {summary.get('ate_rmse_m')} m")
    else:
        plot_trajectory(run["est"], None, os.path.join(args.out, "trajectory.png"),
                        title=run["dataset"])
    if args.export_video and run["dash"] is not None and any(
        n.startswith("dash_") for n in os.listdir(args.out)
    ):
        summary["video"] = str(export_video(args.out, os.path.join(args.out, "run.mp4")))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    summary, run = run_and_summarise(args)
    plot_outputs(args, summary, run)
    print(json.dumps(summary))
    return summary


def summarise_only(argv=None) -> dict:
    """:func:`main` without :func:`plot_outputs`: the same run, files and summary line,
    no ``trajectory.png``."""
    args = build_parser().parse_args(argv)
    summary, _ = run_and_summarise(args)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

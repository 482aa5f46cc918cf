"""Replay harness of the PyTorch port: an on-disk dataset through the port's CLI
(counterpart of ``benchmarks/run_replay.py``).

Drives ``python -m lcvo_tpu_torch.cli.run --chunked`` as a subprocess over a dataset from
``tools/port_make_replay_dataset.py``, with periodic checkpoints, while sampling the
child's RSS (the streaming ingest must hold O(chunk) frames — staging 2,760 KITTI-size
frames would be ~1.3 GB as uint8).

``--kill-resume`` additionally rehearses failure recovery at scale: a second run is
KILLED mid-replay (SIGKILL, no cleanup) once its first checkpoint is on disk and resumed
from it; the resumed trajectory must equal the uninterrupted one (same chunk boundaries
+ the checkpointed generator state -> the same continuation).

Prints the report as one JSON line and writes it to ``chiprun_out/replay_<tag>.json``; the
run outputs go under ``runs/port_replay_<tag>_{a,b}``. Where matplotlib is not installed
the child runs the CLI's ``summarise_only`` (the same run without ``trajectory.png``) and
the report says so.

Run (on the card):
    python tools/port_make_replay_dataset.py --dataset kitti-turn --out datasets/turn
    python tools/port_run_replay.py --data-root datasets/turn --tag kitti_turn \\
        --config configs/turn_robust.yaml --kill-resume
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT_EVERY = 512

_NO_PLOTS = ("import sys; from lcvo_tpu_torch.cli.run import summarise_only; "
             "summarise_only(sys.argv[1:])")


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _cli_args(out, frames, dataset="kitti", data_root=None, mode=None, ba=None,
              config=None, device="cuda", extra=()):
    entry = ("-m", "lcvo_tpu_torch.cli.run") if have_matplotlib() else ("-c", _NO_PLOTS)
    return [
        sys.executable, "-u", *entry,
        "--dataset", dataset, "--data-root", data_root or os.path.join(REPO, "datasets"),
        *(("--mode", mode) if mode else ()), *(("--ba",) if ba else ()), "--chunked",
        *(("--config", config) if config else ()),
        "--frames", str(frames),
        "--checkpoint-every", str(CHECKPOINT_EVERY),
        "--device", device,
        "--out", out,
        *extra,
    ]


def _rss_mb(pid):
    try:
        with open(f"/proc/{pid}/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (FileNotFoundError, ProcessLookupError):
        pass
    return None


def run_sampled(args, kill_after_ckpt=None):
    """Run a CLI subprocess, sampling RSS. ``kill_after_ckpt=(ckpt_path, s)`` sends
    SIGKILL ``s`` seconds after ``ckpt_path`` first appears — tied to the checkpoint
    rather than wall time, so the kill always lands mid-replay with a resumable
    checkpoint on disk. Returns (rc, peak_rss_mb, wall_s, stdout_lines)."""
    t0 = time.perf_counter()
    p = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, cwd=REPO)
    peak = 0.0
    killed = False
    ckpt_seen_at = None
    out_lines = []

    def drain():
        for line in p.stdout:
            out_lines.append(line.rstrip())

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    try:
        while p.poll() is None:
            rss = _rss_mb(p.pid)
            if rss:
                peak = max(peak, rss)
            if kill_after_ckpt and not killed:
                ckpt, delay = kill_after_ckpt
                if ckpt_seen_at is None and os.path.exists(ckpt):
                    ckpt_seen_at = time.perf_counter()
                if ckpt_seen_at is not None and time.perf_counter() - ckpt_seen_at > delay:
                    p.send_signal(signal.SIGKILL)
                    killed = True
            time.sleep(0.25)
    finally:
        if p.poll() is None:  # never leave the child behind
            p.kill()
            p.wait()
    th.join(timeout=5)
    return p.returncode, peak, time.perf_counter() - t0, out_lines


def steady_fps(metrics_path):
    """Frames/s excluding start-up (library loading, the bootstrap, the first chunk's
    warm-up): rate over the metric rows from the first chunk's completion timestamp
    onward (rows carry monotonic timestamps; rows within one chunk share the stamp
    written when that chunk COMPLETED — so frames counted are those strictly after
    ts[0], over the elapsed time from ts[0] to the last stamp)."""
    try:
        with open(metrics_path) as fh:
            rows = [json.loads(l) for l in fh]
        ts = [r["t"] for r in rows if "t" in r]
        if len(ts) < 32:
            return None
        first = next(i for i, t in enumerate(ts) if t > ts[0])
        dt = ts[-1] - ts[0]
        return round((len(ts) - first) / dt, 2) if dt > 0 else None
    except (OSError, StopIteration, ValueError):
        return None


def _card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2760)
    ap.add_argument("--dataset", default="kitti", choices=("kitti", "malaga", "parking"))
    ap.add_argument("--data-root", default=None,
                    help="data_root holding the dataset folder (default: <repo>/datasets)")
    ap.add_argument("--mode", default=None,
                    help="find_new_candidates_method passed to the CLI (default: the config's)")
    ap.add_argument("--config", default=None,
                    help="YAML preset passed through to the CLI (e.g. "
                         "configs/turn_robust.yaml); --mode/--no-ba override it")
    ap.add_argument("--no-ba", action="store_true",
                    help="disable sliding-window BA (a copy of --config with ba.enabled "
                         "false is written beside the runs and passed instead)")
    ap.add_argument("--tag", default=None, help="name of the runs and the report (default: dataset name)")
    ap.add_argument("--kill-resume", action="store_true",
                    help="also rehearse SIGKILL mid-replay + --resume (runs the replay twice more)")
    ap.add_argument("--kill-after", type=float, default=5.0,
                    help="seconds after run B's first checkpoint appears to SIGKILL")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tag = args.tag or args.dataset
    runs = os.path.join(REPO, "runs")
    os.makedirs(runs, exist_ok=True)
    out_a = os.path.join(runs, f"port_replay_{tag}_a")
    out_b = os.path.join(runs, f"port_replay_{tag}_b")
    # a leftover checkpoint from a prior invocation would start run B's kill timer
    # immediately and make the resume restore STALE state — always start clean (the
    # directories carry the port's own prefix: runs/replay_* are the JAX harness's)
    shutil.rmtree(out_a, ignore_errors=True)
    shutil.rmtree(out_b, ignore_errors=True)

    config = args.config
    ba = None
    if args.no_ba:
        if config:
            import yaml

            with open(config) as fh:
                doc = yaml.safe_load(fh) or {}
            doc.setdefault("ba", {})["enabled"] = False
            config = os.path.join(runs, f"port_replay_{tag}_no_ba.yaml")
            with open(config, "w") as fh:
                yaml.safe_dump(doc, fh)
    elif not config:
        ba = True   # the reference harness's default: sift-sift + BA
    mode = args.mode or (None if args.config else "sift-sift")

    def cli(out, extra=()):
        return _cli_args(out, args.frames, dataset=args.dataset, data_root=args.data_root,
                         mode=mode, ba=ba, config=config, device=args.device, extra=extra)

    # --- run A: uninterrupted full replay, RSS-sampled ---
    rc, peak_a, wall_a, lines = run_sampled(cli(out_a))
    if rc != 0:
        print("\n".join(lines[-30:]))
        raise SystemExit(f"replay A failed rc={rc}")
    summary = json.loads(lines[-1])

    report = {
        "metric": f"replay_{tag}",
        "frames": args.frames,
        "mode": (mode or "config's mode") + ("" if args.no_ba else "+ba")
                + (f" [{os.path.basename(args.config)}]" if args.config else "")
                + f", chunked streaming, checkpoint-every {CHECKPOINT_EVERY}",
        "dataset": args.dataset,
        "data_root": args.data_root,
        "device": args.device,
        "card": _card() if args.device.startswith("cuda") else None,
        "plots": "trajectory.png written" if have_matplotlib()
                 else "matplotlib is not installed on this machine",
        "wall_s": round(wall_a, 1),
        "frames_per_s": round(summary.get("frames", 0) / wall_a, 2),
        "frames_per_s_steady": steady_fps(os.path.join(out_a, "metrics.jsonl")),
        "ate_rmse_m": summary.get("ate_rmse_m"),
        # GPS-only GT (Malaga) carries no rotations: the CLI emits the position-based
        # equivalents + explicit "n/a (GPS GT)" rotation fields instead of nulls
        "rpe_trans_rmse_m": summary.get(
            "rpe_trans_rmse_m",
            f"position-based rpe_rmse_m={summary.get('rpe_rmse_m')} (GPS GT)"),
        "rpe_rot_rmse_deg": summary.get("rpe_rot_rmse_deg"),
        "kitti_t_err_pct": summary.get(
            "kitti_t_err_pct",
            f"position-based kitti_t_err_pct_pos={summary.get('kitti_t_err_pct_pos')}"),
        "kitti_r_err_deg_per_m": summary.get("kitti_r_err_deg_per_m"),
        # worst per-50-frame segment scale deviation: the scale-decay spiral's signature
        "seg_scale_min": summary.get("seg_scale_min"),
        "seg_scale_max": summary.get("seg_scale_max"),
        "seg_scale_worst_log2": summary.get("seg_scale_worst"),
        "pose_ok_rate": summary.get("pose_ok_rate"),
        "n_rebootstraps": summary.get("n_rebootstraps"),
        # the whole child: the interpreter, PyTorch and the CUDA context besides the
        # O(chunk) frames the pipeline stages
        "peak_rss_mb": round(peak_a, 1),
        "cli_summary": summary,
    }

    # --- optional: kill mid-replay (after its first checkpoint lands), resume ---
    if args.kill_resume:
        ck = os.path.join(out_b, "checkpoint.npz")
        rc_b, peak_b, wall_b, lines_b = run_sampled(
            cli(out_b), kill_after_ckpt=(ck, args.kill_after)
        )
        resumed = False
        resume_match = None
        max_diff = None
        if os.path.exists(ck):
            rc_r, peak_r, wall_r, lines_r = run_sampled(
                cli(out_b, extra=("--resume", ck))
            )
            if rc_r == 0:
                resumed = True
                tr_a = np.load(os.path.join(out_a, "trajectory.npz"))["positions"]
                tr_b = np.load(os.path.join(out_b, "trajectory.npz"))["positions"]
                if tr_a.shape == tr_b.shape:
                    max_diff = float(np.max(np.abs(tr_a - tr_b)))
                resume_match = bool(tr_a.shape == tr_b.shape and np.array_equal(tr_a, tr_b))
                peak_b = max(peak_b, peak_r)
            else:
                print("\n".join(lines_r[-30:]))
        report["kill_resume"] = {
            "killed_s_after_first_checkpoint": args.kill_after,
            "killed_rc": rc_b,
            "resumed": resumed,
            "trajectory_equals_uninterrupted": resume_match,
            "max_abs_diff_m": max_diff,
            "peak_rss_mb": round(peak_b, 1),
        }

    path = os.path.join(REPO, "chiprun_out", f"replay_{tag}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

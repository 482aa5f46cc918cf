#!/usr/bin/env python3
"""Reference trajectories of the JAX package on the CPU for the lock-step checks of
``chip_smoke.py`` (``[lockstep:<path>]``): every path the script drives, on that path's
own frames, image size, configuration and seed.

    python tools/port_jax_reference.py [--paths default reference ...] [--jobs 3]
        [--out lcvo_tpu_torch/data/jax_lockstep.json] [--work runs/jax_reference]
    python tools/port_jax_reference.py --segments [--paths replay:kitti_turn ...] [--jobs 4]

Since the port draws the JAX package's random stream (``lcvo_tpu_torch/utils/
jax_random.py``), one seed gives both packages the same RANSAC samples, and a run of the
port should retrace the JAX package's trajectory up to rounding. For each path this runs
the JAX package (``lcvo_tpu``, on the CPU) as ``chip_smoke.py`` runs the port and writes,
into one JSON file the port reads without JAX: the camera centers, pose_ok and PnP
inlier count of every trajectory entry (-1 where the host loop held a pose without a PnP
solve), the ATE, the re-bootstraps, the SHA-256 of the uint8 frames it ran on and the
command that made the entry. The file is merged: paths not asked for keep their entries.
Each path runs in a process of its own (``--jobs`` at once); a 1240x376 path takes one to
a few minutes, the 400-frame replay about ten (its frames are rendered on the CPU first).

With ``--segments`` it writes instead, for ``chip_smoke.py``'s ``[segments:<path>]``, the
JAX package's states at the window starts of ``SEGMENT_STARTS`` with each window's
continuation (``tools/port_segment_lockstep.py``), the states stripped of their image
leaves, into ``lcvo_tpu_torch/data/jax_segments/<path>/``.

Frames: the corridor of ``data/synthetic.py`` at 1240x376 rendered on the host as the
script renders it (so the card's run sees the same bytes), the stress scenes of
``tests/test_stress.py``, and the replays' files written by
``tools/port_make_replay_dataset.py --device cpu`` (the script writes them on the card,
which differs by a grey level on a few pixels in a million: the frames' hash tells).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

OUT = os.path.join(ROOT, "lcvo_tpu_torch", "data", "jax_lockstep.json")
FULL = (1240, 376)
SMALL = (416, 160)
CORRIDOR_RENDER = 90      # chip_smoke renders BA_FRAMES + CHUNK corridor frames
CHUNK = 16
TURN = "configs/turn_robust.yaml"


def _corridor(n):
    return {"scene": "corridor", "frames": n, "size": FULL}


# chip_smoke.py's paths: the configuration (file, overrides, seed), the frames and the
# host loop. "chunked" = run_chunked(chunk=16), "run" = the per-frame loop, "streams" =
# the single-stream bootstrap then the batched chunk step at S = 1, "cli" = the CLI.
PATHS = {
    "default": {**_corridor(42), "loop": "chunked"},
    "reference": {**_corridor(42), "loop": "chunked", "config": "configs/reference.yaml"},
    "throughput": {**_corridor(74), "loop": "chunked", "config": "configs/throughput.yaml"},
    "turn_robust": {**_corridor(74), "loop": "chunked", "config": TURN, "seed": 1},
    "sift-mask": {**_corridor(42), "loop": "chunked",
                  "overrides": {"find_new_candidates_method": "sift-mask"}},
    "harris-mask": {**_corridor(42), "loop": "chunked",
                    "overrides": {"find_new_candidates_method": "harris-mask"}},
    "shi-mask+ba": {**_corridor(74), "loop": "chunked",
                    "overrides": {"find_new_candidates_method": "shi-mask",
                                  "ba": {"enabled": True}}},
    "recovery": {**_corridor(64), "loop": "chunked", "burst": (28, 31)},
    "recovery:run": {**_corridor(64), "loop": "run", "burst": (28, 31)},
    "recovery:ba": {**_corridor(64), "loop": "chunked", "burst": (28, 31), "config": TURN,
                    "seed": 1},
    "stress:sharp_turn_416x160": {"scene": "turn", "frames": 60, "size": SMALL, "loop": "run"},
    "stress:sharp_turn": {"scene": "turn", "frames": 60, "size": FULL, "loop": "run"},
    "stress:textureless_occluder": {"scene": "textureless", "frames": 60, "size": FULL,
                                    "loop": "run"},
    "stress:arena_corner_416x160": {"scene": "arena", "frames": 70, "size": SMALL,
                                    "loop": "run"},
    "stress:arena_corner": {"scene": "arena", "frames": 70, "size": FULL, "loop": "run"},
    "streams:S1": {**_corridor(7 + 4 * CHUNK), "loop": "streams", "config": TURN, "seed": 1},
    "replay:kitti_turn": {"scene": "kitti-turn", "frames": 400, "size": FULL, "loop": "cli",
                          "config": TURN, "seed": 1,
                          "cli": ["--chunked", "--checkpoint-every", "128"]},
    "replay:malaga": {"scene": "malaga", "frames": 120, "size": (800, 600), "loop": "cli",
                      "cli": ["--frames", "120", "--chunked"]},
    "replay:parking": {"scene": "parking", "frames": 120, "size": (640, 480), "loop": "cli",
                       "cli": ["--frames", "120", "--chunked"]},
}


# ``--segments``: the JAX package's states at window starts on four of these paths, for
# chip_smoke.py's [segments:<path>] (tools/port_segment_lockstep.py resumes them in the
# port). Each window starts at a ``produced`` count where the path's loop offers a save
# (a chunk boundary; a healthy frame of ``run``) and ends where the next starts.
SEGMENT_STARTS = {
    "replay:kitti_turn": (103, 199, 295),   # 7 + 96k: six chunks of 16 a window
    "stress:sharp_turn": (15, 20),          # frames 15-19 tracked; from 20 on, track lost
    "stress:arena_corner": (13, 25),        # frames 13-24 tracked; from 25 on, track lost
    "shi-mask+ba": (23,),                   # three chunks of 16 and the three tail frames
}


def frames_sha256(frames: np.ndarray) -> str:
    """The hash ``chip_smoke.py`` compares: of the uint8 frames' bytes, in order."""
    return hashlib.sha256(np.ascontiguousarray(frames, dtype=np.uint8).tobytes()).hexdigest()


def _render(seq, n):
    return np.clip(np.rint(np.stack([seq.frame(i) for i in range(n)])), 0, 255).astype(np.uint8)


def scene_frames(spec: dict):
    """(frames (n, H, W) uint8, K, ground-truth positions) of an in-memory path."""
    from lcvo_tpu_torch.data.render import FastArenaRenderer
    from lcvo_tpu_torch.data.synthetic import (SyntheticSequence, noise_burst,
                                               trajectory_loop, trajectory_turn)

    n, (W, H) = spec["frames"], spec["size"]
    if spec["scene"] == "corridor":
        seq = SyntheticSequence(n_frames=CORRIDOR_RENDER, width=W, height=H)
        frames = _render(seq, n)
    elif spec["scene"] == "turn":
        seq = SyntheticSequence(n_frames=n, width=W, height=H, trajectory=trajectory_turn(
            n, speed=0.3, turn_start=20, turn_frames=15, turn_deg=60))
        frames = _render(seq, n)
    elif spec["scene"] == "textureless":
        seq = SyntheticSequence(n_frames=n, width=W, height=H, speed=0.3,
                                textureless_span=(10.0, 18.0), occluder=True)
        frames = _render(seq, n)
    elif spec["scene"] == "arena":
        seq = FastArenaRenderer(trajectory_loop(n, speed=0.3, straight_frames=25,
                                                turn_frames=30), W, H, margin=6.0, device="cpu")
        frames = seq.frames_device(0, n).cpu().numpy()
    else:
        raise ValueError(f"no in-memory scene {spec['scene']!r}")
    if spec.get("burst"):
        frames = noise_burst(frames, *spec["burst"], seed=0)
    return frames, seq.K, seq.gt_positions()


def _config(spec: dict, size=None):
    from lcvo_tpu.config import load_config

    over = dict(spec.get("overrides", {}))
    if size is not None:
        over.update(image_width=size[0], image_height=size[1])
    over["seed"] = spec.get("seed", 0)
    cfg_path = os.path.join(ROOT, spec["config"]) if spec.get("config") else None
    return load_config(cfg_path, overrides=over)


def _entries(centers, ok, ninl) -> dict:
    return {"centers": np.asarray(centers, np.float64).round(9).tolist(),
            "pose_ok": [bool(x) for x in ok], "n_inliers": [int(x) for x in ninl]}


def run_in_memory(spec: dict) -> dict:
    """The JAX package's host loop on the path's frames."""
    import jax
    import jax.numpy as jnp

    from lcvo_tpu.metrics import ate_rmse
    from lcvo_tpu.pipeline import VisualOdometry

    frames, K, gt = scene_frames(spec)
    cfg = _config(spec, spec["size"])
    gap = cfg.bootstrap.frame_gap
    vo = VisualOdometry(cfg, K)
    ninl: list[int] = []
    t0 = time.perf_counter()
    if spec["loop"] == "chunked":
        vo.run_chunked(frames, chunk=CHUNK,
                       on_chunk=lambda s, R, t, ok, ni: ninl.extend(int(x) for x in ni))
        centers, ok = np.asarray(vo.trajectory), vo.pose_ok_flags
    elif spec["loop"] == "run":
        vo.run(iter(frames), len(frames),
               on_frame=lambda i, r: ninl.append(int(np.asarray(r.n_inliers))))
        centers, ok = np.asarray(vo.trajectory), vo.pose_ok_flags
    elif spec["loop"] == "streams":
        from lcvo_tpu.parallel.streams import make_multistream_chunk_step

        vo.bootstrap(list(frames[: gap + 1]))
        step = make_multistream_chunk_step(cfg, K)
        carry = jax.tree_util.tree_map(lambda x: x[None], vo.chunk_carry())
        keys = jax.random.split(jax.random.PRNGKey(cfg.seed), 1)
        Rs, ts, oks = [], [], []
        for c in range((len(frames) - gap - 1) // CHUNK):
            nxt = jax.vmap(jax.random.split)(keys)
            keys, sub = nxt[:, 0], nxt[:, 1]
            ck = jax.vmap(lambda k: jax.random.split(k, CHUNK))(sub)
            fr = jnp.asarray(frames[None, gap + 1 + c * CHUNK: gap + 1 + (c + 1) * CHUNK])
            carry, (R, t, o, n) = step(carry, fr, ck)
            Rs.append(np.asarray(R[0]))
            ts.append(np.asarray(t[0]))
            oks.append(np.asarray(o[0]))
            ninl.extend(int(x) for x in np.asarray(n[0]))
        R, t = np.concatenate(Rs), np.concatenate(ts)
        centers = -np.einsum("nji,nj->ni", R, t)
        ok = np.concatenate(oks)
        gt = gt[gap + 1: gap + 1 + len(centers)]
    else:
        raise ValueError(spec["loop"])
    wall = time.perf_counter() - t0
    if spec["loop"] != "streams":
        gt = gt[gap: gap + len(centers)]
    return {**_entries(centers, ok, ninl), "ate_m": float(ate_rmse(centers, gt)),
            "rebootstraps": int(vo.n_rebootstraps), "frames_sha256": frames_sha256(frames),
            "wall_s": wall}


def run_cli(spec: dict, work: str) -> dict:
    """The JAX package's CLI on files the dataset tool writes on the CPU."""
    import yaml

    import port_make_replay_dataset
    from lcvo_tpu.cli import run as cli_run
    from lcvo_tpu_torch.data.datasets import load_dataset

    dataset = spec["scene"]
    data = os.path.join(work, dataset.replace("-", "_"), "data")
    made = port_make_replay_dataset.make_dataset(dataset, frames=spec["frames"], out=data,
                                                 device="cpu")
    layout = "kitti" if dataset == "kitti-turn" else dataset
    ds = load_dataset(layout, data)
    frames = np.stack([ds.frame(i) for i in range(spec["frames"])]).astype(np.uint8)
    argv = ["--dataset", layout, "--data-root", data]
    if spec.get("config"):
        with open(os.path.join(ROOT, spec["config"])) as fh:
            doc = yaml.safe_load(fh)
        doc["seed"] = spec.get("seed", 0)
        cfg_path = os.path.join(work, dataset.replace("-", "_"), "config.yaml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(doc, fh)
        argv = ["--config", cfg_path] + argv
    out = os.path.join(work, dataset.replace("-", "_"), "run")
    argv += spec["cli"] + ["--out", out]
    t0 = time.perf_counter()
    summary = cli_run.main(argv)
    wall = time.perf_counter() - t0
    centers = np.load(os.path.join(out, "trajectory.npz"))["positions"]
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    rows = [r for r in rows if "pose_ok" in r]
    ninl = [-1 if r.get("inliers") is None else r["inliers"] for r in rows]
    return {**_entries(centers, [r["pose_ok"] for r in rows], ninl),
            "ate_m": float(summary["ate_rmse_m"]), "rebootstraps": int(summary["n_rebootstraps"]),
            "frames_sha256": frames_sha256(frames), "wall_s": wall}


def run_segments(name: str, work: str) -> dict:
    """The JAX package's run of path ``name`` saving its state at ``SEGMENT_STARTS``;
    the states stripped (no image leaves, host lists cut) into ``segments_dir(name)``."""
    import shutil

    import port_make_replay_dataset
    import port_segment_lockstep as psl
    from lcvo_tpu.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils import segments as segs

    spec = PATHS[name]
    if spec["loop"] == "cli":
        data = os.path.join(work, spec["scene"].replace("-", "_"), "data")
        port_make_replay_dataset.make_dataset(spec["scene"], frames=spec["frames"], out=data,
                                              device="cpu")
        src = segs.dataset_frames(data, "kitti", spec["frames"])
        frames = np.stack([src.frame(i) for i in range(src.n)])
        _, cfg = psl.load_configs(spec.get("config"), spec.get("seed", 0), *frames.shape[1:],
                              src.describe["gap"], True)
        loop = "chunked"
    else:
        frames, K, _ = scene_frames(spec)
        src = segs.array_frames(frames, K)
        cfg = _config(spec, spec["size"])
        loop = spec["loop"]
    full = os.path.join(work, "segments", name.replace(":", "_"))
    shutil.rmtree(full, ignore_errors=True)
    rec = psl.run_jax(VisualOdometry(cfg, src.K), src, loop, full, starts=SEGMENT_STARTS[name])
    dst = segs.segments_dir(name)
    shutil.rmtree(dst, ignore_errors=True)
    size = psl.strip_segments(full, dst, keep_gt=False)
    with open(os.path.join(dst, segs.SEGMENTS)) as fh:
        doc = json.load(fh)
    doc.update(path=name, frames_sha256=frames_sha256(frames),
               command=f"python tools/port_jax_reference.py --segments --paths {name}")
    with open(os.path.join(dst, segs.SEGMENTS), "w") as fh:
        json.dump(doc, fh, separators=(",", ":"))
    return {"path": name, "windows": [(w["start"], w["end"]) for w in rec["windows"]],
            "jax_rebootstraps": rec["jax_rebootstraps"], **size,
            "bytes": sum(os.path.getsize(os.path.join(dst, f)) for f in os.listdir(dst))}


def one(name: str, work: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    spec = PATHS[name]
    entry = run_cli(spec, work) if spec["loop"] == "cli" else run_in_memory(spec)
    return {**entry, "spec": {k: v for k, v in spec.items()},
            "command": f"python tools/port_jax_reference.py --paths {name}",
            "jax_version": jax.__version__}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", nargs="+", default=None, choices=list(PATHS))
    ap.add_argument("--jobs", type=int, default=1, help="paths run at once, a process each")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--work", default=os.path.join(ROOT, "runs", "jax_reference"),
                    help="where the replays' files and runs go")
    ap.add_argument("--segments", action="store_true",
                    help="write the window states of SEGMENT_STARTS' paths (all of them "
                         "unless --paths) into lcvo_tpu_torch/data/jax_segments/")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.one:
        if args.segments:
            import jax

            jax.config.update("jax_platforms", "cpu")
            print("RESULT " + json.dumps(run_segments(args.one, args.work)), flush=True)
        else:
            print("RESULT " + json.dumps(one(args.one, args.work)), flush=True)
        return
    args.paths = args.paths or list(SEGMENT_STARTS if args.segments else PATHS)
    if args.segments and set(args.paths) - set(SEGMENT_STARTS):
        raise SystemExit(f"no segments for {sorted(set(args.paths) - set(SEGMENT_STARTS))}")

    def start(name):
        log = open(os.path.join(args.work, f"{name.replace(':', '_')}.log"), "w")
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--one", name,
                                 "--work", args.work] + (["--segments"] if args.segments else []),
                                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log

    os.makedirs(args.work, exist_ok=True)
    todo, running, done = list(args.paths), {}, {}
    while todo or running:
        while todo and len(running) < args.jobs:
            name = todo.pop(0)
            running[name] = start(name)
        time.sleep(2)
        for name, (proc, log) in list(running.items()):
            if proc.poll() is None:
                continue
            log.close()
            del running[name]
            with open(log.name) as fh:
                lines = [ln for ln in fh if ln.startswith("RESULT ")]
            if proc.returncode != 0 or not lines:
                raise SystemExit(f"{name} failed ({proc.returncode}): see {log.name}")
            done[name] = json.loads(lines[-1][len("RESULT "):])
            print(json.dumps({"path": name, **{k: done[name][k] for k in
                                               ("ate_m", "wall_s", "windows", "bytes")
                                               if k in done[name]}}), flush=True)
    if args.segments:
        return
    ref = {"paths": {}}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            ref = json.load(fh)
    ref["about"] = ("The JAX package on the CPU on chip_smoke.py's paths: camera centers, "
                    "pose_ok and PnP inliers per trajectory entry; made by "
                    "tools/port_jax_reference.py")
    ref["paths"].update(done)
    ref["paths"] = dict(sorted(ref["paths"].items()))
    with open(args.out, "w") as fh:
        json.dump(ref, fh, separators=(",", ":"))
        fh.write("\n")


if __name__ == "__main__":
    main()

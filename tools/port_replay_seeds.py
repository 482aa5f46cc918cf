#!/usr/bin/env python3
"""One replay through either package's CLI over several seeds, and the spread of its
accuracy: what tells a fault of the port from a draw of RANSAC.

    python3 tools/port_replay_seeds.py --package port|jax --data-root DIR
        [--config configs/turn_robust.yaml] [--seeds 1 2 3 4 5] [--device cuda]
        [--jobs 1] [--out replay_seeds_port.json]

For each seed the YAML is copied with ``seed: <k>`` and the package's CLI replays the
``kitti`` layout under ``--data-root`` (``--chunked --checkpoint-every 128``, as
``chip_smoke.py``'s replay phase) in a process of its own: the port's
``lcvo_tpu_torch.cli.run.summarise_only`` on ``--device``, or the JAX package's
``lcvo_tpu.cli.run.main`` on the CPU. ``--jobs`` runs that many seeds at once. Prints,
and writes to ``--out``, one JSON object: each seed's ATE, KITTI t-err, re-bootstraps,
per-segment scale range (min, max, worst) and seconds, and the minimum, median and
maximum of the first two.

Files for it: ``python tools/port_make_replay_dataset.py --dataset kitti-turn --frames
400 --out DIR --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNERS = {
    "port": "import sys; from lcvo_tpu_torch.cli.run import summarise_only; "
            "summarise_only(sys.argv[1:])",
    "jax": "import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
           "from lcvo_tpu.cli.run import main; main(sys.argv[1:])",
}
KEYS = ("ate_rmse_m", "kitti_t_err_pct", "n_rebootstraps", "frames", "pose_ok_rate",
        "seg_scale_min", "seg_scale_max", "seg_scale_worst", "n_segments")


def run_seed(package: str, config: str, seed: int, data_root: str, work: str,
             device: str) -> dict:
    """One CLI run at ``seed``; the summary's accuracy keys and the seconds it took."""
    import yaml

    with open(config) as f:
        doc = yaml.safe_load(f)
    doc["seed"] = seed
    cfg_path = os.path.join(work, f"seed{seed}.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(doc, f)
    argv = ["--config", cfg_path, "--dataset", "kitti", "--data-root", data_root, "--chunked",
            "--checkpoint-every", "128", "--out", os.path.join(work, f"seed{seed}")]
    if package == "port":
        argv += ["--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", RUNNERS[package], *argv], cwd=ROOT, env=env,
                       capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if p.returncode:
        raise RuntimeError(f"{package} seed {seed}: rc {p.returncode}\n{p.stdout[-2000:]}\n"
                           f"{p.stderr[-3000:]}")
    summary = json.loads([ln for ln in p.stdout.splitlines() if ln.startswith("{")][-1])
    return {"seed": seed, "seconds": round(seconds, 1),
            **{k: summary[k] for k in KEYS if k in summary}}


def spread(rows: list, key: str) -> dict:
    vals = [r[key] for r in rows if isinstance(r.get(key), (int, float))]
    if not vals:
        return {}
    return {"min": min(vals), "median": statistics.median(vals), "max": max(vals)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", required=True, choices=sorted(RUNNERS))
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--config", default=os.path.join("configs", "turn_robust.yaml"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    config = os.path.join(ROOT, args.config) if not os.path.isabs(args.config) else args.config
    data_root = os.path.abspath(args.data_root)
    with tempfile.TemporaryDirectory(prefix="replay_seeds_") as work:
        with ThreadPoolExecutor(args.jobs) as pool:
            futs = [pool.submit(run_seed, args.package, config, s, data_root, work, args.device)
                    for s in args.seeds]
            rows = [f.result() for f in futs]
    rep = {"package": args.package, "config": args.config,
           "device": args.device if args.package == "port" else "cpu",
           "data_root": args.data_root, "seeds": rows,
           "ate_rmse_m": spread(rows, "ate_rmse_m"),
           "kitti_t_err_pct": spread(rows, "kitti_t_err_pct")}
    if args.package == "port" and args.device.startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        rep["card"] = smi.stdout.strip()
    line = json.dumps(rep)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rep


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run one BA configuration of the PyTorch port on the GPU over several seeds, with BA on
and with ``ba.enabled`` off, on the same synthetic frames, and print one JSON line per
run: ATE (Sim(3)-aligned), pose_ok rate, re-bootstraps, the bootstrap's essential-matrix
inliers, the fewest PnP inliers of any step, and how the estimated step length drifts
against the ground truth's over the run (quantiles of the ratio, normalized to its first
five steps).

    python3 tools/port_ba_seed_scan.py --config configs/turn_robust.yaml --seeds 0 1 2 3
    python3 tools/port_ba_seed_scan.py --config configs/turn_robust.yaml --seeds 0 \
        --override '{"klt": {"eps": 0.01}}'
    python3 tools/port_ba_seed_scan.py --config configs/throughput.yaml --bootstrap-only 40

One seed is one draw of RANSAC: the seed changes the minimal sets of the bootstrap's
essential-matrix RANSAC and of every PnP, nothing else (detection and tracking are
deterministic). A bootstrap with few inliers is a wrong two-view init, and the whole
trajectory inherits it, with BA or without. ``--bootstrap-only N`` runs only the two-view
bootstrap for seeds 0..N-1 and prints each one's inliers and the angle between its
translation and the true motion, then how many had fewer than ``--weak`` inliers: how
often the card draws a weak bootstrap. Needs one CUDA device; about 8 s per run at
1240x376 and 74 frames, a quarter of a second per bootstrap.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join("configs", "turn_robust.yaml"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--frames", type=int, default=74)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--override", default=None, metavar="JSON",
                    help="overrides on top of the file, as a JSON object")
    ap.add_argument("--bootstrap-only", type=int, default=0, metavar="N",
                    help="run only the bootstrap, for seeds 0..N-1")
    ap.add_argument("--weak", type=int, default=500,
                    help="a bootstrap with fewer essential-matrix inliers counts as weak")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_ba_seed_scan.py: no CUDA device", file=sys.stderr)
        return 2

    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    over = json.loads(args.override) if args.override else {}
    base = load_config(args.config, overrides=over)
    seq = SyntheticSequence(n_frames=args.frames, width=base.image_width,
                            height=base.image_height)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        frames = list(ex.map(seq.frame, range(args.frames)))
    frames = np.clip(np.rint(np.stack(frames)), 0, 255).astype(np.uint8)
    gt = seq.gt_positions()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi, "config": args.config, "override": over,
                      "frames": args.frames, "chunk": args.chunk}), flush=True)

    if args.bootstrap_only:
        gap = base.bootstrap.frame_gap
        d_gt = gt[gap] - gt[0]
        d_gt = d_gt / np.linalg.norm(d_gt)
        rows = []
        for seed in range(args.bootstrap_only):
            vo = VisualOdometry(dataclasses.replace(base, seed=seed), seq.K, device="cuda")
            n_inl = vo.bootstrap(list(frames[: gap + 1]))
            R, t = vo.state.R.cpu().numpy().astype(np.float64), vo.state.t.cpu().numpy()
            c = -R.T @ t
            ang = float(np.degrees(np.arccos(np.clip(c / np.linalg.norm(c) @ d_gt, -1, 1))))
            rows.append((seed, n_inl, ang))
            print(json.dumps({"seed": seed, "bootstrap_inliers": n_inl,
                              "translation_angle_deg": round(ang, 3)}), flush=True)
        weak = [r[0] for r in rows if r[1] < args.weak]
        print(json.dumps({"seeds": len(rows), "weak_threshold": args.weak, "weak_seeds": weak,
                          "inliers_median": float(np.median([r[1] for r in rows])),
                          "angle_deg_max": max(r[2] for r in rows)}), flush=True)
        return 0

    for seed in args.seeds:
        for ba_on in (True, False):
            cfg = dataclasses.replace(base, seed=seed,
                                      ba=dataclasses.replace(base.ba, enabled=ba_on))
            vo = VisualOdometry(cfg, seq.K, device="cuda")
            inliers: list[int] = []
            vo.run_chunked(frames, chunk=args.chunk,
                           on_chunk=lambda s, R, t, ok, ninl: inliers.extend(int(n) for n in ninl))
            est = np.asarray(vo.trajectory)
            gap = cfg.bootstrap.frame_gap
            g = gt[gap: gap + len(est)]
            ratio = (np.linalg.norm(np.diff(est, axis=0), axis=1)
                     / np.linalg.norm(np.diff(g, axis=0), axis=1))
            ratio = ratio / np.median(ratio[:5])
            out = {"seed": seed, "ba": ba_on, "ate_m": float(ate_rmse(est, g)),
                   "pose_ok_rate": float(np.mean(vo.pose_ok_flags)),
                   "rebootstraps": vo.n_rebootstraps, "bootstrap_inliers": inliers[0],
                   "min_pnp_inliers": min(inliers[1:]),
                   "step_ratio_quantiles": [round(float(q), 4) for q in
                                            np.quantile(ratio, [0, 0.25, 0.5, 0.75, 1])]}
            if ba_on:
                out["refines"], out["refines_cost_up"] = vo.ba_refine_stats()
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the two-view bootstrap of the JAX package and of the PyTorch port on the CPU for
many random seeds, on the same synthetic frames, and print one JSON line per seed and a
summary: the angle between each side's bootstrap translation and the true motion, and
its essential-matrix inlier count.

    python tools/port_bootstrap_scan_cpu.py --width 1240 --height 376 --seeds 40

Detection and tracking are deterministic, so only the RANSAC draws change from seed to
seed. A bootstrap whose translation is off by more than ``--fail-deg`` degrees picks a
wrong motion, and tracking collapses right after it. Both packages draw the JAX
package's random stream, so a seed gives both the same samples: the scan compares seed
by seed (a seed that fails in one package and not in the other is a rounding flip of the
MSAC winner, not another draw).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _angle_deg(R, t, d_gt: np.ndarray) -> float:
    c = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
    c = c / np.linalg.norm(c)
    return float(np.degrees(np.arccos(np.clip(c @ d_gt, -1.0, 1.0))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1240)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--seeds", type=int, default=40, help="seeds 0 .. N-1")
    ap.add_argument("--fail-deg", type=float, default=20.0)
    args = ap.parse_args()

    from lcvo_tpu.config import load_config as jload_config
    from lcvo_tpu.pipeline import VisualOdometry as JVO
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.utils import jax_random
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence
    from lcvo_tpu_torch.pipeline import VisualOdometry as TVO

    over = {"image_width": args.width, "image_height": args.height}
    jcfg, tcfg = jload_config(overrides=over), load_config(overrides=over)
    gap = tcfg.bootstrap.frame_gap
    seq = SyntheticSequence(n_frames=gap + 1, width=args.width, height=args.height)
    frames = np.stack([seq.frame(i) for i in range(gap + 1)])
    frames = list(np.clip(np.rint(frames), 0, 255).astype(np.uint8))
    gt = seq.gt_positions()
    d_gt = (gt[gap] - gt[0]) / np.linalg.norm(gt[gap] - gt[0])

    # one instance per side (compiled once); each seed re-seeds its random stream
    jvo, tvo = JVO(jcfg, seq.K), TVO(tcfg, seq.K, device="cpu")
    angles: dict[str, list[float]] = {"jax": [], "torch": []}
    for s in range(args.seeds):
        jvo._key = jax.random.PRNGKey(s)
        j_inl = jvo.bootstrap(frames)
        tvo._key = jax_random.PRNGKey(s)
        t_inl = tvo.bootstrap(frames)
        row = {"seed": s,
               "jax": {"deg": _angle_deg(jvo.state.R, jvo.state.t, d_gt), "inliers": int(j_inl)},
               "torch": {"deg": _angle_deg(tvo.state.R.numpy(), tvo.state.t.numpy(), d_gt),
                         "inliers": int(t_inl)}}
        for k in angles:
            angles[k].append(row[k]["deg"])
        print(json.dumps(row), flush=True)
    summary = {"width": args.width, "height": args.height, "seeds": args.seeds,
               "fail_deg": args.fail_deg}
    for k, a in angles.items():
        a = np.asarray(a)
        summary[k] = {"failed": int(np.sum(a > args.fail_deg)),
                      "failed_seeds": [int(i) for i in np.flatnonzero(a > args.fail_deg)],
                      "median_deg": float(np.median(a))}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

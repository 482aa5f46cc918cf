#!/usr/bin/env python3
"""The forced track drop of ``tests/test_fault_injection.py`` in either package on the
CPU, at a given track-table size: bootstrap and step a synthetic corridor to frame 20,
keep only the first 8 valid tracks, step 20 more frames and print, per seed, one JSON
line with the tracks before the drop, ``n_tracked`` after each of the 20 frames and the
health at the end. The test asks for more than 24 tracks after the 20th frame.

    python tools/port_track_drop.py --package jax --tracks 256 --seeds 0 1 2
    python tools/port_track_drop.py --package torch --tracks 512

Sizes are those of the port's CPU twin (``tests/test_torch_fault_injection.py``):
320x128, a 15 px KLT window on 3 levels, 256 RANSAC hypotheses, ``frame_gap`` 4; 256
tracks come with 256 candidates and 96 new per frame, any other table with 768 and 128
(``tests/test_pipeline.py``'s small configuration).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

W, H = 320, 128


def overrides(tracks: int, seed: int) -> dict:
    cands, new = (256, 96) if tracks == 256 else (768, 128)
    return {"image_width": W, "image_height": H, "seed": seed,
            "state": {"max_tracks": tracks, "max_candidates": cands, "max_new_per_frame": new},
            "klt": {"window": 15, "iters": 8, "levels": 3},
            "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
            "bootstrap": {"frame_gap": 4}}


def run(package: str, tracks: int, seed: int) -> dict:
    if package == "jax":
        import jax.numpy as jnp

        from lcvo_tpu.config import load_config
        from lcvo_tpu.data.synthetic import SyntheticSequence
        from lcvo_tpu.pipeline import VisualOdometry

        kw, as_mask = {}, jnp.asarray
    else:
        import torch

        from lcvo_tpu_torch.config import load_config
        from lcvo_tpu_torch.data.synthetic import SyntheticSequence
        from lcvo_tpu_torch.pipeline import VisualOdometry

        kw, as_mask = {"device": "cpu"}, torch.from_numpy
    cfg = load_config(overrides=overrides(tracks, seed))
    seq = SyntheticSequence(n_frames=60, width=W, height=H)
    vo = VisualOdometry(cfg, seq.K, **kw)
    n_boot = cfg.bootstrap.frame_gap + 1
    vo.bootstrap([seq.frame(i) for i in range(n_boot)])
    for i in range(n_boot, 20):
        vo.step(seq.frame(i))
    before = int(vo.state.tracks.count())
    valid = np.asarray(vo.state.tracks.valid)
    keep = np.zeros_like(valid)
    keep[np.flatnonzero(valid)[:8]] = True
    vo.state = vo.state._replace(tracks=vo.state.tracks._replace(valid=as_mask(keep)))
    counts = [int(vo.step(seq.frame(i)).n_tracked) for i in range(20, 40)]
    return {"package": package, "tracks": tracks, "seed": seed, "before": before,
            "n_tracked": counts, "health": int(vo.state.health), "refilled": counts[-1] > 24}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--tracks", type=int, default=256)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    if args.package == "torch":
        import torch

        torch.set_num_threads(1)
    for seed in args.seeds:
        print(json.dumps(run(args.package, args.tracks, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

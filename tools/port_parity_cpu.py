#!/usr/bin/env python3
"""Run the JAX package and the PyTorch port on the CPU on the same synthetic frames and
print one JSON line: each side's ATE (Sim(3)-aligned, against the exact ground truth),
pose_ok rate, re-bootstrap count and wall time, and the two trajectories' distance.

    python tools/port_parity_cpu.py --width 416 --height 160 --frames 42 --chunk 16 --seed 0
    python tools/port_parity_cpu.py --config configs/reference.yaml --width 1240 --height 376
    python tools/port_parity_cpu.py --config configs/turn_robust.yaml --width 1240 --height 376 --frames 74

Both run ``run_chunked`` with the default ``VOConfig``, or with the YAML file given by
``--config``, at the given image size and ``cfg.seed = --seed``, on uint8 frames of the
synthetic corridor. The random streams
differ (JAX PRNG vs a torch.Generator), so the trajectories agree to a tolerance, not
bit for bit; ``traj_distance_m`` is unaligned, so it includes the monocular scale each
run fixes at bootstrap. With a BA configuration (``configs/throughput.yaml``,
``configs/turn_robust.yaml``) each side also reports how many slots of its keyframe ring
are filled and where its head stands. One run at 1240x376 takes a few minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--frames", type=int, default=42)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0, help="cfg.seed of both packages")
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="YAML file both packages load (default: the VOConfig defaults)")
    ap.add_argument("--no-ba", action="store_true",
                    help="turn ba.enabled off in both packages (what BA moves, on the same frames)")
    args = ap.parse_args()

    from lcvo_tpu.config import load_config as jload_config
    from lcvo_tpu.metrics import ate_rmse
    from lcvo_tpu.pipeline import VisualOdometry as JVO
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence
    from lcvo_tpu_torch.pipeline import VisualOdometry as TVO

    seq = SyntheticSequence(n_frames=args.frames, width=args.width, height=args.height)
    frames = np.stack([seq.frame(i) for i in range(args.frames)])
    frames = np.clip(np.rint(frames), 0, 255).astype(np.uint8)
    over = {"image_width": args.width, "image_height": args.height, "seed": args.seed}
    if args.no_ba:
        over["ba"] = {"enabled": False}
    out = {"width": args.width, "height": args.height, "frames": args.frames,
           "chunk": args.chunk, "seed": args.seed, "config": args.config, "no_ba": args.no_ba, "device": "cpu"}
    trajs = {}
    for name, vo in (("jax", JVO(jload_config(args.config, overrides=over), seq.K)),
                     ("torch", TVO(load_config(args.config, overrides=over), seq.K, device="cpu"))):
        t0 = time.perf_counter()
        traj = np.asarray(vo.run_chunked(frames, chunk=args.chunk))
        gap = vo.cfg.bootstrap.frame_gap
        trajs[name] = traj
        out[name] = {
            "ate_m": ate_rmse(traj, seq.gt_positions()[gap: gap + len(traj)]),
            "pose_ok_rate": float(np.mean(vo.pose_ok_flags)),
            "rebootstraps": vo.n_rebootstraps,
            "trajectory_len": len(traj),
            "wall_s_incl_compile": time.perf_counter() - t0,
        }
        if vo.window is not None:
            out[name]["keyframes_in_ring"] = int(np.asarray(vo.window.kf_valid).sum())
            out[name]["ring_head"] = int(vo.window.head)
    d = np.linalg.norm(trajs["jax"] - trajs["torch"], axis=1)
    out["traj_distance_m"] = {"median": float(np.median(d)), "max": float(np.max(d))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

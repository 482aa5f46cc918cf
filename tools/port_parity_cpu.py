#!/usr/bin/env python3
"""Run the JAX package and the PyTorch port on the CPU on the same synthetic frames and
print one JSON line: each side's ATE (Sim(3)-aligned, against the exact ground truth),
pose_ok rate, re-bootstrap count and wall time, and the two trajectories' distance.

    python tools/port_parity_cpu.py --width 416 --height 160 --frames 42 --chunk 16 --seed 0
    python tools/port_parity_cpu.py --config configs/reference.yaml --width 1240 --height 376
    python tools/port_parity_cpu.py --config configs/turn_robust.yaml --width 1240 --height 376 --frames 74
    python tools/port_parity_cpu.py --mode sift-mask --width 1240 --height 376 --packages jax
    python tools/port_parity_cpu.py --mode shi-mask --ba --frames 74 --width 1240 --height 376
    python tools/port_parity_cpu.py --frames 64 --burst 28 31 --width 1240 --height 376 [--per-frame]
    python tools/port_parity_cpu.py --scene turn --frames 60 --per-frame --width 1240 --height 376

Both run ``run_chunked`` (``run`` with ``--per-frame``) with the default ``VOConfig``, or
with the YAML file given by ``--config``, at the given image size and ``cfg.seed =
--seed``, on uint8 frames of the synthetic corridor. ``--mode`` sets
``find_new_candidates_method`` and ``--ba`` turns window BA on, as ``bench.py``'s modes
do (``shi-mask+ba`` is ``--mode shi-mask --ba``). ``--burst START STOP`` replaces those
frames with uniform noise from seed 0 (``data.synthetic.noise_burst``), the
fault-injection scenario; each side then also reports the trajectory indices whose pose
is not ok. ``--scene turn|textureless|arena`` takes the frames of one of
``tests/test_stress.py``'s sequences instead of the corridor. ``--packages jax`` runs one
side only.
The random streams
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


def _corridor(n, W, H):
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence

    return SyntheticSequence(n_frames=n, width=W, height=H)


def _turn(n, W, H):
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence, trajectory_turn

    return SyntheticSequence(n_frames=n, width=W, height=H, trajectory=trajectory_turn(
        n, speed=0.3, turn_start=20, turn_frames=15, turn_deg=60))


def _textureless(n, W, H):
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence

    return SyntheticSequence(n_frames=n, width=W, height=H, speed=0.3,
                             textureless_span=(10.0, 18.0), occluder=True)


def _arena(n, W, H):
    from lcvo_tpu_torch.data.render import FastArenaRenderer
    from lcvo_tpu_torch.data.synthetic import trajectory_loop

    return FastArenaRenderer(trajectory_loop(n, speed=0.3, straight_frames=25, turn_frames=30),
                             W, H, margin=6.0, device="cpu")


# tests/test_stress.py's sequences (60, 60 and 70 frames there)
SCENES = {"corridor": _corridor, "turn": _turn, "textureless": _textureless, "arena": _arena}


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
    ap.add_argument("--mode", default=None,
                    choices=("shi-mask", "harris-mask", "sift-mask", "sift-sift"),
                    help="find_new_candidates_method of both packages")
    ap.add_argument("--ba", action="store_true", help="turn ba.enabled on in both packages")
    ap.add_argument("--burst", type=int, nargs=2, default=None, metavar=("START", "STOP"),
                    help="replace frames START..STOP-1 with seeded uniform noise")
    ap.add_argument("--per-frame", action="store_true", help="run() in place of run_chunked()")
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"], choices=("jax", "torch"))
    ap.add_argument("--scene", default="corridor", choices=tuple(SCENES),
                    help="the frames: the corridor, or one of tests/test_stress.py's sequences")
    args = ap.parse_args()
    if args.ba and args.no_ba:
        ap.error("--ba and --no-ba exclude each other")

    from lcvo_tpu.config import load_config as jload_config
    from lcvo_tpu.metrics import ate_rmse
    from lcvo_tpu.pipeline import VisualOdometry as JVO
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.synthetic import noise_burst
    from lcvo_tpu_torch.pipeline import VisualOdometry as TVO

    seq = SCENES[args.scene](args.frames, args.width, args.height)
    frames = np.stack([seq.frame(i) for i in range(args.frames)])
    frames = np.clip(np.rint(frames), 0, 255).astype(np.uint8)
    if args.burst:
        frames = noise_burst(frames, *args.burst, seed=0)
    over = {"image_width": args.width, "image_height": args.height, "seed": args.seed}
    if args.no_ba or args.ba:
        over["ba"] = {"enabled": bool(args.ba)}
    if args.mode:
        over["find_new_candidates_method"] = args.mode
    out = {"width": args.width, "height": args.height, "frames": args.frames,
           "chunk": args.chunk, "seed": args.seed, "config": args.config, "no_ba": args.no_ba,
           "mode": args.mode, "ba": args.ba, "burst": args.burst, "burst_seed": 0,
           "per_frame": args.per_frame, "scene": args.scene, "device": "cpu"}
    makers = {"jax": lambda: JVO(jload_config(args.config, overrides=over), seq.K),
              "torch": lambda: TVO(load_config(args.config, overrides=over), seq.K, device="cpu")}
    trajs = {}
    for name in args.packages:
        vo = makers[name]()
        t0 = time.perf_counter()
        if args.per_frame:
            traj = np.asarray(vo.run(iter(frames), len(frames)))
        else:
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
        if args.burst:
            out[name]["not_ok_indices"] = [i for i, f in enumerate(vo.pose_ok_flags) if not f]
        if vo.window is not None:
            out[name]["keyframes_in_ring"] = int(np.asarray(vo.window.kf_valid).sum())
            out[name]["ring_head"] = int(vo.window.head)
    if len(trajs) == 2 and trajs["jax"].shape == trajs["torch"].shape:
        d = np.linalg.norm(trajs["jax"] - trajs["torch"], axis=1)
        out["traj_distance_m"] = {"median": float(np.median(d)), "max": float(np.max(d))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

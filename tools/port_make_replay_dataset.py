"""Generate on-disk replay datasets with the PyTorch port's renderers (counterpart of
``benchmarks/make_replay_dataset.py``; the layouts are the same, so either package's
adapters read what either tool wrote).

The published runs of the system this repo was modelled on are KITTI 05 (2,760 frames,
1241x376, sustained 90 degree turns), Malaga extract-07 (2,120 frames, 800x600) and
parking (598 frames, 640x480). None is redistributable, so this renders synthetic worlds
with exact ground truth at the same scales into the layouts that
``lcvo_tpu_torch.data.datasets`` reads:

    --dataset kitti       straight corridor, kitti layout
    --dataset kitti-turn  arena LOOP with sustained 90 degree turns (2 deg/frame),
                          kitti layout
    --dataset malaga      arena loop at 800x600 with the malaga adapter's K; malaga
                          layout: timestamped ``img_CAMERA1_<t>_left.jpg`` files + a
                          1 Hz GPS log (needs PIL for the JPEGs)
    --dataset parking     corridor at 640x480 with the parking adapter's K; parking layout

Frames are rendered on ``--device`` (``cuda`` unless told otherwise) a batch per call and
encoded on host threads; PNGs are written with the standard library
(``datasets.imwrite_gray_png``), so the tool needs no imaging package for them. The
report gives rendering and encoding their own seconds and frames/s. Resumable: frames
already on disk are skipped. Datasets are not committed (``datasets/`` is git-ignored).

Run:  python tools/port_make_replay_dataset.py --dataset kitti-turn --frames 400 --out datasets/turn
Then: python -m lcvo_tpu_torch.cli.run --config configs/turn_robust.yaml --dataset kitti \\
          --data-root datasets/turn --chunked --checkpoint-every 128 --out runs/turn
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

# the per-dataset intrinsics that the malaga/parking adapters hard-code — the rendered
# worlds must match them
K_MALAGA = np.array([[621.18428, 0, 404.0076], [0, 621.18428, 309.05989], [0, 0, 1]])
K_PARKING = np.array([[331.37, 0, 320.0], [0, 369.568, 240.0], [0, 0, 1]])

PNG_LEVEL = 1        # zlib level of the PNGs: the fastest; files ~18% larger than at 6
ENCODE_THREADS = 4   # zlib and file writes release the GIL


def _write_frames(renderer, path_of, save_frame, n_frames: int, batch: int = 16) -> dict:
    """Render + encode the frames that are not on disk yet, a batch at a time. Rendering
    (host copy included) and encoding are timed apart."""
    render_s = encode_s = 0.0
    done = 0
    with ThreadPoolExecutor(ENCODE_THREADS) as pool:
        for start in range(0, n_frames, batch):
            stop = min(start + batch, n_frames)
            todo = [i for i in range(start, stop) if not os.path.exists(path_of(i))]
            if not todo:
                continue
            t0 = time.perf_counter()
            # the host copy waits for the render
            frames = renderer.frames_device(start, stop).cpu().numpy()
            t1 = time.perf_counter()
            list(pool.map(lambda i: save_frame(path_of(i), frames[i - start]), todo))
            t2 = time.perf_counter()
            render_s += t1 - t0
            encode_s += t2 - t1
            done_before, done = done, done + len(todo)
            if done // 200 > done_before // 200:
                print(f"{done} frames written ({done / (render_s + encode_s):.1f} fps)", flush=True)
    return {"written": done, "render_s": render_s, "encode_s": encode_s}


def _save_png(path: str, img: np.ndarray) -> None:
    from lcvo_tpu_torch.data.datasets import imwrite_gray_png

    tmp = path + ".part"   # a frame is on disk whole or not at all: resuming relies on it
    imwrite_gray_png(tmp, img, level=PNG_LEVEL)
    os.replace(tmp, path)


def gen_kitti(out_root: str, renderer, n_frames: int):
    """KITTI odometry layout: 05/image_0/%06d.png + calib.txt + poses/05.txt."""
    root = os.path.join(out_root, "kitti-dataset")
    img_dir = os.path.join(root, "05", "image_0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    np.savetxt(os.path.join(root, "poses", "05.txt"), renderer.gt_pose_rows())
    P0 = np.hstack([renderer.K, np.zeros((3, 1))]).reshape(-1)
    with open(os.path.join(root, "05", "calib.txt"), "w") as fh:
        fh.write("P0: " + " ".join(f"{v:.12e}" for v in P0) + "\n")
    path_of = lambda i: os.path.join(img_dir, f"{i:06d}.png")
    return root, _write_frames(renderer, path_of, _save_png, n_frames)


def gen_malaga(out_root: str, renderer, n_frames: int, fps: float = 7.5, t0: float = 100000.0):
    """Malaga extract-07 layout: timestamped left jpgs + 1 Hz GPS log.

    The GPS log (10 columns; col 0 = epoch time, cols 8/9 = local x/y — the columns the
    adapter reads) is sampled at 1 Hz from the exact trajectory, so the adapter's
    timestamp interpolation is exercised at full scale."""
    from PIL import Image

    root = os.path.join(out_root, "malaga-urban-dataset-extract-07")
    img_dir = os.path.join(root, "malaga-urban-dataset-extract-07_rectified_800x600_Images")
    os.makedirs(img_dir, exist_ok=True)
    stamps = t0 + np.arange(n_frames) / fps
    pos = renderer.gt_positions()
    gps_t = np.arange(t0, stamps[-1] + 1.0, 1.0)
    rows = np.zeros((len(gps_t), 10))
    rows[:, 0] = gps_t
    rows[:, 8] = np.interp(gps_t, stamps, pos[:, 0])
    rows[:, 9] = np.interp(gps_t, stamps, pos[:, 2])
    gps_path = os.path.join(root, "malaga-urban-dataset-extract-07_all-sensors_GPS.txt")
    with open(gps_path, "w") as fh:
        fh.write("% Time ... LocalX LocalY (synthetic; cols 0/8/9 as real log)\n")
        np.savetxt(fh, rows)
    # exact full GT poses are NOT part of the real malaga layout (GPS only) —
    # keep them alongside for offline analysis
    np.savetxt(os.path.join(root, "exact_poses_kitti_format.txt"), renderer.gt_pose_rows())

    def save(path, img):
        tmp = path + ".part"
        Image.fromarray(img, mode="L").save(tmp, format="JPEG", quality=92)
        os.replace(tmp, path)

    path_of = lambda i: os.path.join(img_dir, f"img_CAMERA1_{stamps[i]:.6f}_left.jpg")
    return root, _write_frames(renderer, path_of, save, n_frames)


def gen_parking(out_root: str, renderer, n_frames: int):
    """Parking layout: images/img_%05d.png + poses.txt (KITTI-format rows)."""
    root = os.path.join(out_root, "parking")
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    np.savetxt(os.path.join(root, "poses.txt"), renderer.gt_pose_rows())
    path_of = lambda i: os.path.join(img_dir, f"img_{i:05d}.png")
    return root, _write_frames(renderer, path_of, _save_png, n_frames)


def make_dataset(dataset: str, frames: int | None = None, out: str | None = None,
                 speed: float = 0.35, device="cuda", size: tuple | None = None) -> dict:
    """Render ``dataset`` under ``out`` and return the report. ``size=(W, H)`` replaces
    the dataset's own frame size (for small fixtures; malaga and parking then keep their
    adapters' K, as the adapters would read it)."""
    from lcvo_tpu_torch.data.render import FastArenaRenderer, FastCorridorRenderer
    from lcvo_tpu_torch.data.synthetic import trajectory_loop

    if dataset == "kitti":
        n = frames or 2760
        out = out or os.path.join(REPO, "datasets")
        W, H = size or (1240, 376)
        r = FastCorridorRenderer(n, W, H, speed=speed, device=device)
        root, rep = gen_kitti(out, r, n)
    elif dataset == "kitti-turn":
        n = frames or 2760
        out = out or os.path.join(REPO, "datasets", "turn")
        W, H = size or (1240, 376)
        traj = trajectory_loop(n, speed=speed, straight_frames=260, turn_frames=45)
        r = FastArenaRenderer(traj, W, H, device=device)
        root, rep = gen_kitti(out, r, n)
    elif dataset == "malaga":
        n = frames or 2120
        out = out or os.path.join(REPO, "datasets", "malaga")
        W, H = size or (800, 600)
        traj = trajectory_loop(n, speed=speed, straight_frames=300, turn_frames=50)
        r = FastArenaRenderer(traj, W, H, K=K_MALAGA, device=device)
        root, rep = gen_malaga(out, r, n)
    elif dataset == "parking":
        n = frames or 598
        out = out or os.path.join(REPO, "datasets", "parking-root")
        W, H = size or (640, 480)
        r = FastCorridorRenderer(n, W, H, speed=speed, K=K_PARKING, device=device)
        root, rep = gen_parking(out, r, n)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    w = rep["written"]
    return {
        "dataset": dataset, "frames": n, "written": w, "width": W, "height": H,
        "seconds": round(rep["render_s"] + rep["encode_s"], 1),
        "render_s": rep["render_s"], "encode_s": rep["encode_s"],
        "render_fps": w / rep["render_s"] if rep["render_s"] > 0 else None,
        "encode_fps": w / rep["encode_s"] if rep["encode_s"] > 0 else None,
        "encode_threads": ENCODE_THREADS, "device": str(r.device), "root": root,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="kitti",
                    choices=("kitti", "kitti-turn", "malaga", "parking"))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="data_root directory to write into")
    ap.add_argument("--speed", type=float, default=0.35)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; pass cpu to render there)")
    args = ap.parse_args(argv)
    rep = make_dataset(args.dataset, args.frames, args.out, args.speed, args.device)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()

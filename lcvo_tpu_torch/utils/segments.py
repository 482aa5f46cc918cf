"""Windows of a sequence resumed from the JAX package's own states: the port's side of
the window lock-step (``tools/port_segment_lockstep.py`` writes the states and compares
the runs; ``chip_smoke.py``'s ``[segments:<path>]`` runs the committed ones).

A segments directory holds ``segments.json`` (the windows: start, end, the state file,
the JAX package's entries over the window and the entry the window starts from) and one
checkpoint per window. :func:`run_port_window` resumes a window's state in a port host
loop (a state stripped of its image leaves gets them from the frame before) and runs the
window's frames with the loop the JAX run used; :func:`compare_window` holds its entries
against the JAX package's.
"""

from __future__ import annotations

import os
import time

import numpy as np

SEGMENTS = "segments.json"
# the states chip_smoke.py resumes, one directory per path (``segments_dir``)
SEGMENTS_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "data", "jax_segments")
APART_OF_STEP = 0.01     # a center this far off, in steps of the reference run, is apart
# tools/port_make_replay_dataset.py's kitti-turn trajectory
KITTI_TURN = {"speed": 0.35, "straight_frames": 260, "turn_frames": 45}


def segments_dir(path: str) -> str:
    """The directory of path ``path``'s states (``replay:kitti_turn`` ->
    ``replay_kitti_turn``, ``shi-mask+ba`` -> ``shi-mask_ba``)."""
    return os.path.join(SEGMENTS_ROOT, path.replace(":", "_").replace("+", "_"))


class Frames:
    """A sequence's frames by index, its K and its ground truth (cam->world (N, 4, 4) or
    None): from a dataset directory, an in-memory array or the arena renderer."""

    def __init__(self, frame, n: int, K, gt_T=None, describe: dict | None = None):
        self.frame, self.n, self.K, self.gt_T = frame, n, np.asarray(K, np.float64), gt_T
        self.describe = describe or {}

    def range(self, a: int, b: int):
        return (self.frame(i) for i in range(a, b))


def dataset_frames(data_root: str, layout: str = "kitti", n: int | None = None) -> Frames:
    from lcvo_tpu_torch.data.datasets import load_dataset

    ds = load_dataset(layout, data_root)
    n = min(n or ds.n_frames, ds.n_frames)
    return Frames(ds.frame, n, ds.K, ds.gt_poses(),
                  {"layout": layout, "data_root": data_root, "gap": ds.bootstrap_pair[1]})


def array_frames(frames: np.ndarray, K, gt_T=None) -> Frames:
    return Frames(lambda i: frames[i], len(frames), K, gt_T)


def rows_to_T(rows: np.ndarray) -> np.ndarray:
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :4] = np.asarray(rows).reshape(-1, 3, 4)
    return T


def render_frames(dataset: str, n: int, device: str, batch: int = 64) -> Frames:
    """The frames ``tools/port_make_replay_dataset.py`` writes for ``kitti-turn``, made
    on ``device`` a batch at a time and kept as uint8 on the host."""
    from lcvo_tpu_torch.data.render import FastArenaRenderer
    from lcvo_tpu_torch.data.synthetic import trajectory_loop

    if dataset != "kitti-turn":
        raise ValueError(f"no renderer here for {dataset!r}")
    r = FastArenaRenderer(trajectory_loop(n, **KITTI_TURN), 1240, 376, device=device)
    out = np.empty((n, 376, 1240), np.uint8)
    for a in range(0, n, batch):
        out[a:a + batch] = r.frames_device(a, min(a + batch, n)).cpu().numpy()
    return Frames(lambda i: out[i], n, r.K, rows_to_T(r.gt_pose_rows()),
                  {"render": dataset, "device": str(device), "gap": 6})


def replay_config(config: str | None, seed: int, H: int, W: int, gap: int):
    """The port's configuration of a replay as the CLI loads it: the file, the frames'
    size, the dataset's bootstrap gap and ``seed``."""
    from lcvo_tpu_torch.config import load_config

    return load_config(config, overrides={"image_height": H, "image_width": W, "seed": seed,
                                          "bootstrap": {"frame_gap": gap}})


def rounded(a) -> list:
    """An array as a list of float64 rounded to 9 decimals (the JSON the records keep)."""
    return np.round(np.asarray(a, np.float64), 9).tolist()


def entries_of(poses, pose_ok, n_inliers) -> dict:
    P = np.asarray(poses, np.float64)
    return {"centers": rounded(P[:, :3, 3]), "rotations": rounded(P[:, :3, :3].reshape(-1, 9)),
            "pose_ok": [bool(x) for x in pose_ok], "n_inliers": [int(x) for x in n_inliers]}


def run_port_window(vo, seg_dir: str, rec: dict, w: dict, frames: Frames) -> dict:
    """Resume the port's host loop ``vo`` from window ``w``'s JAX state and run the
    window's frames with the segments' loop; the new entries (as ``entries_of``) and the
    seconds. A stripped state gets its image leaves from frame ``start - 1``."""
    start, end = w["start"], w["end"]
    produced = vo.resume(os.path.join(seg_dir, w["state"]), prev_frame=frames.frame(start - 1))
    n0 = len(vo.trajectory)
    if produced != start or not np.allclose(vo.trajectory[-1], w["anchor"]["centers"],
                                            rtol=0, atol=1e-6):
        raise RuntimeError(f"window {start}: the file resumed at frame {produced} at "
                           f"{vo.trajectory[-1]}, not {start} at {w['anchor']['centers']}")
    ninl: list[int] = []
    t0 = time.perf_counter()
    if rec["loop"] == "chunked":
        vo.run_chunked_continue(frames.range(start, end), produced=start, chunk=rec["chunk"],
                                n_frames=end,
                                on_chunk=lambda s, R, t, ok, n: ninl.extend(int(x) for x in n))
    else:
        vo.run_continue(frames.range(start, end), end, start,
                        on_frame=lambda i, r: ninl.append(int(r.n_inliers)))
    seconds = time.perf_counter() - t0
    return {**entries_of(vo.poses[n0:], vo.pose_ok_flags[n0:], ninl), "seconds": seconds}


def compare_window(ref: dict, run: dict, start: int, anchor) -> dict:
    """``run``'s entries over a window against ``ref``'s (the same window): the
    unaligned camera-center distance at the first entry, at the end and its largest
    value, the share of equal pose_ok, the first frame where pose_ok or the inlier count
    part, the first where a center is apart (off by more than ``APART_OF_STEP`` of the
    reference's step from ``anchor``, the center the window starts from, and from entry
    to entry), and the earlier of the two."""
    a, b = np.asarray(run["centers"]), np.asarray(ref["centers"])
    if a.shape != b.shape:
        return {"entries": len(a), "reference_entries": len(b)}
    d = np.linalg.norm(a - b, axis=1)
    ok = np.asarray(run["pose_ok"]) == np.asarray(ref["pose_ok"])
    same = ok & (np.asarray(run["n_inliers"]) == np.asarray(ref["n_inliers"]))
    parted = np.flatnonzero(~same)
    step = np.linalg.norm(np.diff(np.vstack([anchor, b]), axis=0), axis=1)
    apart = np.flatnonzero(d > APART_OF_STEP * step)
    first = [int(start + x[0]) for x in (parted, apart) if len(x)]
    return {"entries": len(a), "distance_m_end": float(d[-1]) if len(d) else 0.0,
            "distance_m_max": float(d.max()) if len(d) else 0.0,
            "distance_m_first": float(d[0]) if len(d) else 0.0,
            "pose_ok_equal_share": float(ok.mean()) if len(ok) else 1.0,
            "first_parted_frame": int(start + parted[0]) if len(parted) else None,
            "first_apart_frame": int(start + apart[0]) if len(apart) else None,
            "first_frame": min(first) if first else None}

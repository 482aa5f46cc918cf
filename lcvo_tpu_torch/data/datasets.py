"""Dataset adapters: KITTI 05, Malaga extract-07, parking — plus a prefetching
frame loader (port of ``lcvo_tpu/data/datasets.py``; same on-disk layouts, so a
directory written for one package is read by both).

Replaces the reference's inline per-dataset setup code (``src/main.py:14-68`` for
setup, ``:216-226`` for per-frame reads; the PoseEstimator fallback re-reads frames
from disk at ``src/vo_pipeline.py:285-303``). Here each dataset is a self-contained
adapter object (intrinsics, ground truth, frame paths, bootstrap pair) injected into
the host loop — no ambient globals, no layer violations.

Host-side decode: PNGs through the native library (``data/native_loader.py``), a file it
declines and every JPEG through PIL. Frames stay numpy uint8 on the host; the host loop
stacks a chunk and uploads it once. :class:`Prefetcher` overlaps decode of frame i+1 with
device compute of frame i (double-buffered ingest).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field

import numpy as np


def _imread_gray(path: str, dtype=np.uint8) -> np.ndarray:
    """Grayscale frame as uint8 by default: the device-side pipeline casts to
    f32 after transfer, and 8-bit transfer quarters the host->device bytes. Every file
    is offered to the native PNG decoder first, so a file it cannot read (a JPEG, a PNG
    feature it lacks) is counted in ``native_loader.counts()["declined"]`` before PIL
    reads it: no frame takes the PIL path unseen."""
    from lcvo_tpu_torch.data import native_loader

    out = native_loader.decode_png(path, dtype)
    if out is not None:
        return out
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=dtype)


def imwrite_gray_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG with the standard library
    only: signature, ``IHDR``, one ``IDAT`` (zlib over filter-0 rows), ``IEND``. Colour
    type 0 and no interlace: what the native decoder reads, and every other reader too."""
    import struct
    import zlib

    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected an (H, W) uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)  # filter type 0 in front of every row
    rows[:, 1:] = img

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                 + chunk(b"IEND", b""))


@dataclass
class SequenceDataset:
    """A monocular frame sequence with intrinsics and optional ground truth."""

    name: str
    K: np.ndarray                    # (3, 3)
    frame_paths: list
    bootstrap_pair: tuple = (0, 6)
    gt: np.ndarray | None = None     # (N, 3) world positions, or None
    gt_T: np.ndarray | None = None   # (N, 4, 4) cam→world poses, or None

    @property
    def n_frames(self) -> int:
        return len(self.frame_paths)

    def frame(self, i: int) -> np.ndarray:
        return _imread_gray(self.frame_paths[i])

    def frames(self):
        for p in self.frame_paths:
            yield _imread_gray(p)

    def gt_positions(self) -> np.ndarray | None:
        return self.gt

    def gt_poses(self) -> np.ndarray | None:
        """Full (N, 4, 4) cam→world ground-truth poses when the dataset provides
        rotations (KITTI/parking pose files, synthetic); None for GPS-only GT
        (Malaga) — positions-only metrics still apply there."""
        return self.gt_T


def _pose_txt_poses(path: str) -> np.ndarray:
    """KITTI-style pose file: rows of flattened 3x4 [R|t] cam→world. Returns
    (N, 4, 4) homogeneous poses; camera centers are the translation columns."""
    P = np.loadtxt(path)
    T = np.tile(np.eye(4), (len(P), 1, 1))
    T[:, :3, :4] = P.reshape(-1, 3, 4)
    return T


def _pose_txt_positions(path: str) -> np.ndarray:
    """Camera centers from a KITTI-style pose file (see :func:`_pose_txt_poses`)."""
    P = np.loadtxt(path)
    return P[:, [3, 7, 11]]


def kitti(root: str, sequence: str = "05") -> SequenceDataset:
    """KITTI odometry grayscale (reference ``src/main.py:14-29``).

    ``root`` contains ``<sequence>/image_0/*.png`` and ``poses/<sequence>.txt``.
    Intrinsics come from ``<sequence>/calib.txt`` (``P0:`` row) when present —
    the standard KITTI layout — falling back to the reference's hard-coded K
    (``src/main.py:16-21``). Bootstrap pair [0, 6] follows the reference.
    """
    img_dir = os.path.join(root, sequence, "image_0")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith(".png"))
    paths = [os.path.join(img_dir, n) for n in names]
    gt_path = os.path.join(root, "poses", f"{sequence}.txt")
    gt = gt_T = None
    if os.path.exists(gt_path):
        gt_T = _pose_txt_poses(gt_path)
        gt = gt_T[:, :3, 3].copy()
    K = np.array(
        [[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]], np.float64
    )
    calib_path = os.path.join(root, sequence, "calib.txt")
    if os.path.exists(calib_path):
        with open(calib_path) as fh:
            for line in fh:
                if line.startswith("P0:"):
                    p = np.fromstring(line.split(":", 1)[1], sep=" ")
                    if p.size == 12:
                        P0 = p.reshape(3, 4)
                        K = P0[:, :3].astype(np.float64)
                    break
    return SequenceDataset("kitti", K, paths, bootstrap_pair=(0, 6), gt=gt, gt_T=gt_T)


def _malaga_image_stamp(name: str) -> float | None:
    """Timestamp embedded in a Malaga image filename
    (``img_CAMERA1_<epoch.seconds>_left.jpg``)."""
    import re

    m = re.search(r"_([0-9]+\.[0-9]+)_left", name)
    return float(m.group(1)) if m else None


def malaga(root: str) -> SequenceDataset:
    """Malaga urban extract-07 (reference ``src/main.py:31-47``): left images of the
    rectified 800x600 stereo stream; GPS local x/y (cols 8, 9) as ground truth.

    The GPS log is ~1 Hz while images stream at ~7.5 fps, so GT is associated by
    TIMESTAMP: each image's filename stamp is interpolated into the GPS track
    (the reference plotted raw GPS rows against frame indices,
    ``src/main.py:31-47`` — meaningless for per-frame error on real data)."""
    img_dir = os.path.join(root, "malaga-urban-dataset-extract-07_rectified_800x600_Images")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith("left.jpg"))
    paths = [os.path.join(img_dir, n) for n in names]
    gps_path = os.path.join(root, "malaga-urban-dataset-extract-07_all-sensors_GPS.txt")
    gt = None
    if os.path.exists(gps_path):
        # real Malaga GPS logs carry a '%'-prefixed header line
        g = np.loadtxt(gps_path, comments="%")
        g = np.atleast_2d(g)
        stamps = [_malaga_image_stamp(n) for n in names]
        if all(s is not None for s in stamps) and len(g) >= 2:
            ts = np.asarray(stamps, np.float64)
            order = np.argsort(g[:, 0])
            gx = np.interp(ts, g[order, 0], g[order, 8])
            gy = np.interp(ts, g[order, 0], g[order, 9])
            gt = np.stack([gx, np.zeros(len(ts)), gy], axis=-1)
        else:  # stamp-less fixtures: fall back to row-per-frame
            gt = np.stack([g[:, 8], np.zeros(len(g)), g[:, 9]], axis=-1)
    K = np.array(
        [[621.18428, 0, 404.0076], [0, 621.18428, 309.05989], [0, 0, 1]], np.float64
    )
    return SequenceDataset("malaga", K, paths, bootstrap_pair=(0, 6), gt=gt)


def parking(root: str) -> SequenceDataset:
    """Parking-garage sequence (reference ``src/main.py:49-65``): ``images/img_%05d.png``,
    K from the course handout, bootstrap pair [0, 4]."""
    img_dir = os.path.join(root, "images")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith(".png"))
    paths = [os.path.join(img_dir, n) for n in names]
    gt_path = os.path.join(root, "poses.txt")
    gt = gt_T = None
    if os.path.exists(gt_path):
        gt_T = _pose_txt_poses(gt_path)
        gt = gt_T[:, :3, 3].copy()
    K = np.array([[331.37, 0, 320], [0, 369.568, 240], [0, 0, 1]], np.float64)
    return SequenceDataset("parking", K, paths, bootstrap_pair=(0, 4), gt=gt, gt_T=gt_T)


def load_dataset(name: str, data_root: str) -> SequenceDataset:
    """Factory by config name. ``data_root`` is the directory holding the dataset
    folder (kitti-dataset / malaga-urban-dataset-extract-07 / parking)."""
    if name == "kitti":
        return kitti(os.path.join(data_root, "kitti-dataset"))
    if name == "malaga":
        return malaga(os.path.join(data_root, "malaga-urban-dataset-extract-07"))
    if name == "parking":
        return parking(os.path.join(data_root, "parking"))
    if name == "synthetic":
        return SyntheticDataset()
    raise ValueError(f"unknown dataset {name!r}")


class SyntheticDataset(SequenceDataset):
    """Rendered corridor sequence with exact ground truth (no files on disk)."""

    def __init__(self, n_frames: int = 120, **kw):
        from lcvo_tpu_torch.data.synthetic import SyntheticSequence

        self._seq = SyntheticSequence(n_frames=n_frames, **kw)
        T = np.tile(np.eye(4), (n_frames, 1, 1))
        T[:, :3, :3] = self._seq.R_wc
        T[:, :3, 3] = self._seq.t_wc
        super().__init__(
            name="synthetic",
            K=self._seq.K,
            frame_paths=list(range(n_frames)),
            bootstrap_pair=(0, 6),
            gt=self._seq.gt_positions(),
            gt_T=T,
        )

    def frame(self, i: int) -> np.ndarray:
        return self._seq.frame(i)

    def frames(self):
        for i in range(self.n_frames):
            yield self._seq.frame(i)


class Prefetcher:
    """Background-thread frame decode with a bounded queue.

    Overlaps host decode (+ an optional host-side ``transform``) with device compute:
    a host thread that yields numpy frames. The host-to-device copy is not made here:
    the chunked loop stacks a chunk and uploads it once.
    """

    def __init__(self, dataset: SequenceDataset, start: int = 0, depth: int = 2, transform=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._n = dataset.n_frames

        def worker():
            for i in range(start, self._n):
                if self._stop.is_set():
                    break
                f = dataset.frame(i)
                if transform is not None:
                    f = transform(f)
                self._q.put((i, f))
            self._q.put((None, None))

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            i, f = self._q.get()
            if i is None:
                return
            yield f

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

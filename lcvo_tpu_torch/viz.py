"""Visualization: live 4-panel dashboard, trajectory plots, video export (port of
``lcvo_tpu/viz.py``).

Host-side matplotlib, entirely out of the device path (tensors of the state and the
result come to the host here); matplotlib and PIL are imported inside the functions that
need them, so the module imports without either — the equivalent of the
reference's ``Visual`` class (``src/visual.py:11-121``: current frame + keypoints,
local trajectory last-20, global trajectory, keypoint-count curve), its periodic
trajectory savefig (``src/main.py:264-277``) and ``export_video.py``.
"""

from __future__ import annotations

import os

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class Dashboard:
    """4-panel live dashboard mirroring the reference's ``Visual`` layout.

    ``update(frame, state, result)`` records history; ``render(path)`` draws the
    figure (to screen with ``show=True``, or to a PNG frame dump for video export).
    """

    def __init__(self, K: np.ndarray, local_window: int = 20, landmark_range: float = 200.0):
        self.K = np.asarray(K)
        self.local_window = local_window
        self.landmark_range = landmark_range  # reference filters ||X|| < 200 (src/visual.py:57)
        self.positions: list[np.ndarray] = []
        self.n_keypoints: list[int] = []
        self._last = None
        self._landmarks = np.zeros((0, 3))

    def update(self, image, state, result) -> None:
        R = _host(result.R)
        t = _host(result.t)
        cam = -R.T @ t
        self.positions.append(cam)
        self.n_keypoints.append(int(_host(result.n_tracked)))
        P = _host(state.tracks.P)
        X = _host(state.tracks.X)
        valid = _host(state.tracks.valid)
        # range filter relative to the camera (the reference filters ||X|| < 200
        # in world frame, src/visual.py:57 — camera-relative keeps the filter
        # meaningful on long trajectories)
        near = np.linalg.norm(X - cam, axis=1) < self.landmark_range
        self._last = (_host(image), P[valid & near])
        self._landmarks = X[valid & near]

    def render(self, path: str | None = None, show: bool = False):
        import matplotlib

        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(12, 6))
        img, kps = self._last if self._last is not None else (None, None)

        ax = fig.add_subplot(221)
        if img is not None:
            ax.imshow(img, cmap="gray")
            if len(kps):
                # keypoints of range-filtered landmarks on the frame
                # (reference src/visual.py:62-65)
                ax.scatter(kps[:, 0], kps[:, 1], s=4, c="lime", marker="x")
            ax.set_xlim([0, img.shape[1]])
            ax.set_ylim([img.shape[0], 0])
        ax.set_title("landmarks & keypoints")
        ax.set_axis_off()

        pos = np.asarray(self.positions) if self.positions else np.zeros((1, 3))
        ax = fig.add_subplot(222)
        w = pos[-self.local_window :]
        if len(self._landmarks):
            # current landmark cloud in the local map view (reference
            # src/visual.py:86-88)
            ax.scatter(self._landmarks[:, 0], self._landmarks[:, 2], s=6,
                       c="green", alpha=0.2, label="landmarks")
        ax.plot(w[:, 0], w[:, 2], "b.-", label="trajectory")
        ax.set_title(f"local trajectory (last {self.local_window}) + landmarks")
        ax.set_aspect("equal", adjustable="datalim")
        ax.legend(loc="lower right", fontsize=7)

        ax = fig.add_subplot(223)
        ax.plot(pos[:, 0], pos[:, 2], "b-")
        ax.set_title("global trajectory (x-z)")
        ax.set_aspect("equal", adjustable="datalim")

        ax = fig.add_subplot(224)
        ax.plot(self.n_keypoints)
        ax.set_title("# tracked keypoints")

        fig.tight_layout()
        if path:
            fig.savefig(path, dpi=100)
        if show:
            plt.pause(0.001)
        plt.close(fig)
        return fig


def plot_trajectory(est: np.ndarray, gt: np.ndarray | None, path: str, title: str = ""):
    """x-z trajectory plot vs ground truth (the reference's periodic savefig,
    ``src/main.py:264-277``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    est = np.asarray(est)
    ax.plot(est[:, 0], est[:, 2], "b-", label="estimate")
    if gt is not None:
        gt = np.asarray(gt)
        ax.plot(gt[: len(est), 0], gt[: len(est), 2], "r--", label="ground truth")
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def export_video(frame_dir: str, out_path: str, fps: int = 20, prefix: str = "dash_"):
    """Stitch dumped dashboard PNGs into a video (the reference's
    ``export_video.py``: cv2.VideoWriter mp4v at 20 fps).

    Only files matching ``prefix*.png`` are stitched — the run directory also
    holds trajectory plots of a different size. Writer selection: ffmpeg mp4
    when available; otherwise an animated GIF via PIL. Returns
    the path actually written, or an explanatory string if every writer failed
    (frames are kept either way).
    """
    names = sorted(
        n for n in os.listdir(frame_dir) if n.endswith(".png") and n.startswith(prefix)
    )
    if not names:
        raise ValueError(f"no {prefix}*.png frames in {frame_dir}")
    paths = [os.path.join(frame_dir, n) for n in names]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation

        if out_path.endswith(".mp4") and animation.writers.is_available("ffmpeg"):
            import matplotlib.image as mpimg
            import matplotlib.pyplot as plt

            first = mpimg.imread(paths[0])
            fig = plt.figure(figsize=(first.shape[1] / 100, first.shape[0] / 100), dpi=100)
            ax = fig.add_axes([0, 0, 1, 1])
            ax.set_axis_off()
            im = ax.imshow(first)

            def frame_fn(i):
                im.set_data(mpimg.imread(paths[i]))
                return [im]

            anim = animation.FuncAnimation(fig, frame_fn, frames=len(paths), blit=True)
            anim.save(out_path, fps=fps)
            plt.close(fig)
            return out_path
        # no ffmpeg: animated GIF through PIL
        from PIL import Image

        gif_path = os.path.splitext(out_path)[0] + ".gif"
        frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE) for p in paths]
        frames[0].save(
            gif_path,
            save_all=True,
            append_images=frames[1:],
            duration=max(int(1000 / fps), 20),
            loop=0,
        )
        return gif_path
    except Exception as e:  # every writer failed — keep the frames
        return f"video export unavailable ({e}); frames kept in {frame_dir}"

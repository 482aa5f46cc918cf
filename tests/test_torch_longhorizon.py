"""Long-horizon stability on the port (counterparts of ``tests/test_longhorizon.py``,
with its bounds): the package pins full-f32 matmuls with TF32 off, and over 300 frames
the track budget does not leak (late inliers hold, promotions still flow).

Size: the JAX file runs 416x160 with 1024 tracks; the port on the CPU runs 320x128 with
256 tracks (the small size of ``tests/test_torch_pipeline.py``, ``frame_gap`` 4) on the
port's ``FastCorridorRenderer``, rendered on the CPU a batch at a time. The full-width
run is on the card (``chip_smoke.py`` ``[longhorizon]``).
"""

import numpy as np
import torch

W, H, N = 320, 128, 300
RENDER_BATCH = 25


def test_matmul_precision_is_f32():
    """Importing the package pins float32 matmuls at full precision and turns TF32 off
    for matmuls and cuDNN: the counterpart of the JAX package's
    ``jax_default_matmul_precision == "float32"``."""
    import lcvo_tpu_torch  # noqa: F401  (the import applies the settings)

    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_track_budget_does_not_leak_over_300_frames():
    """Median inliers late in a 300-frame run do not decay materially against the
    start, and candidate promotion still flows in the last 100 frames: the leak
    signature was inliers 69 -> 1 with promotions pinned at 0."""
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.render import FastCorridorRenderer
    from lcvo_tpu_torch.metrics import ate_rmse
    from lcvo_tpu_torch.pipeline import VisualOdometry

    threads = torch.get_num_threads()
    try:
        # several test workers share the cores: two threads to render, one to track
        torch.set_num_threads(2)
        seq = FastCorridorRenderer(N, W, H, device="cpu")
        frames = np.concatenate([seq.frames_device(s, min(s + RENDER_BATCH, N)).numpy()
                                 for s in range(0, N, RENDER_BATCH)])
        torch.set_num_threads(1)
        cfg = load_config(overrides={
            "image_width": W, "image_height": H,
            "state": {"max_tracks": 256, "max_candidates": 256, "max_new_per_frame": 96},
            "klt": {"window": 15, "iters": 8, "levels": 3},
            "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
            "bootstrap": {"frame_gap": 4},
        })
        vo = VisualOdometry(cfg, seq.K, device="cpu")
        inliers, promoted = [], []

        def on_frame(i, res):
            inliers.append(int(res.n_inliers))
            promoted.append(int(res.n_promoted))

        traj = vo.run(iter(frames), N, on_frame=on_frame)
    finally:
        torch.set_num_threads(threads)
    est = np.asarray(traj)
    gap = cfg.bootstrap.frame_gap
    gt = seq.gt_positions()[gap: gap + len(est)]

    early = np.median(inliers[:50])
    late = np.median(inliers[-50:])
    assert late > 8, f"late-run inliers collapsed: {late}"
    assert late > 0.3 * early, f"inlier leak: {early} -> {late}"
    assert sum(promoted[-100:]) > 0, "candidate promotion starved"
    ate = ate_rmse(est[: len(gt)], gt[: len(est)])
    assert np.isfinite(ate) and ate < 8.0, f"long-horizon ATE {ate:.2f} m"

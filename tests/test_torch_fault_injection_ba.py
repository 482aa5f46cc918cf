"""The chunked burst of ``tests/test_torch_fault_injection.py`` with window BA on
(``configs/turn_robust.yaml``), a scenario the JAX package's fault-injection file does
not run: every re-bootstrap empties the keyframe window and starts the host mirror of
``frame_idx`` again at 0, so the keyframe cadence restarts, and no refine ends above the
cost it started from. At the small size of ``tests/test_torch_pipeline.py``; the
full-width run is ``chip_smoke.py`` ``[recovery:ba]``.
"""

import os

import numpy as np
import pytest
import torch

from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.pipeline import VisualOdometry, keyframes_in

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 320, 128
SMALL = {
    "image_width": W, "image_height": H,
    "state": {"max_tracks": 256, "max_candidates": 256, "max_new_per_frame": 96},
    "klt": {"window": 15, "iters": 8, "levels": 3},
    "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
    "bootstrap": {"frame_gap": 4},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine and slows these tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chunked_burst_with_ba_restarts_window_and_cadence():
    """``configs/turn_robust.yaml`` (sift-sift, window BA) through the chunked burst:
    every bootstrap leaves an empty window and the host mirror at 0, so the keyframe
    cadence restarts; keyframes pushed and refines run equal the cadence over each
    segment between bootstraps, and no refine ends above the cost it started from."""
    cfg = load_config(os.path.join(ROOT, "configs", "turn_robust.yaml"), overrides=SMALL)
    every = cfg.ba.keyframe_every
    n = 48
    sq = SyntheticSequence(n_frames=n, width=W, height=H)
    frames = np.stack([sq.frame(i) for i in range(n)])
    rng = np.random.default_rng(3)
    frames[18:21] = rng.uniform(0, 255, frames[18:21].shape).astype(frames.dtype)

    vo = VisualOdometry(cfg, sq.K, device="cpu")
    segments, after = [], []
    boot = vo.bootstrap

    def watched_bootstrap(*a, **k):
        segments.append(vo._frame_idx)          # steps since the previous bootstrap
        out = boot(*a, **k)
        after.append((vo._frame_idx, int(vo.window.kf_valid.sum()), int(vo.window.head)))
        return out

    vo.bootstrap = watched_bootstrap
    traj = vo.run_chunked(frames, chunk=8)
    segments = segments[1:] + [vo._frame_idx]   # the first call starts from nothing
    gap = cfg.bootstrap.frame_gap
    assert len(traj) == n - gap
    assert vo.n_rebootstraps >= 1 and len(segments) == vo.n_rebootstraps + 1
    assert after == [(0, 0, 0)] * len(after), after
    want = sum(keyframes_in(0, s, every) for s in segments)
    assert vo.n_keyframes == want and want >= 2, (vo.n_keyframes, segments)
    assert vo.ba_refine_stats() == (want, 0)
    assert int(vo.window.kf_valid.sum()) == min(segments[-1] // every, cfg.ba.window)
    assert vo._frame_idx == int(vo.state.frame_idx)
    assert int(vo.state.health) == 0 and all(vo.pose_ok_flags[-4:])

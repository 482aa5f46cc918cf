"""The recovery path of both packages on the same frames: the JAX package and the port
run ``run_chunked`` and ``run`` at the small size of ``tests/test_torch_pipeline.py``
(320x128, 256 tracks, ``frame_gap`` 4) through the same seeded noise burst.

Equal: the number of poses, ``n_rebootstraps``, the trajectory index of the pose each
re-bootstrap anchors at, which entries hold that anchor pose, and ``pose_ok`` there.
Each package's ATE stays under the JAX fault-injection tests' bound (1.0 m). The random
streams do not cross packages (RANSAC draws differ), so nothing else is compared.
"""

import numpy as np
import pytest
import torch

from lcvo_tpu.config import load_config as jload_config
from lcvo_tpu.pipeline import VisualOdometry as JVisualOdometry
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence, noise_burst
from lcvo_tpu_torch.metrics import ate_rmse
from lcvo_tpu_torch.pipeline import VisualOdometry

SMALL = {
    "image_width": 320, "image_height": 128,
    "state": {"max_tracks": 256, "max_candidates": 256, "max_new_per_frame": 96},
    "klt": {"window": 15, "iters": 8, "levels": 3},
    "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
    "bootstrap": {"frame_gap": 4},
}
N = 48
BURST = (18, 21)
BURST_SEED = 3
ATE_BOUND_M = 1.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine and slows these tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticSequence(n_frames=N, width=320, height=128, speed=0.3)
    frames = np.stack([seq.frame(i) for i in range(N)])
    return seq, noise_burst(frames, *BURST, seed=BURST_SEED)


def _drive(vo, frames, chunked: bool) -> dict:
    """Run one package's loop; record where each re-bootstrap anchored (the index of
    the last pose emitted before the host loop counted it) and which entries then hold
    that pose."""
    anchors = []
    seen = [0]

    def note(index_of_next):
        if vo.n_rebootstraps > seen[0]:
            anchors.append(index_of_next - 1)
            seen[0] = vo.n_rebootstraps

    if chunked:
        vo.run_chunked(frames, chunk=8, on_chunk=lambda start, *rest: note(start))
    else:
        vo.run(iter(frames), N, on_frame=lambda i, res: note(i))
    note(len(vo.trajectory))   # a count made after the last emit
    poses = np.asarray(vo.poses)
    held = []
    for a in anchors:
        i = a + 1
        while i < len(poses) and np.array_equal(poses[i], poses[a]):
            held.append(i)
            i += 1
    gap = vo.cfg.bootstrap.frame_gap
    return {"n_poses": len(vo.trajectory), "n_rebootstraps": vo.n_rebootstraps,
            "anchors": anchors, "held": held,
            "held_pose_ok": [bool(vo.pose_ok_flags[i]) for i in held],
            "traj": np.asarray(vo.trajectory), "gap": gap}


@pytest.mark.parametrize("chunked", [True, False], ids=["run_chunked", "run"])
def test_recovery_matches_across_packages(scene, chunked):
    seq, frames = scene
    got = {
        "jax": _drive(JVisualOdometry(jload_config(overrides=SMALL), seq.K), frames, chunked),
        "torch": _drive(VisualOdometry(load_config(overrides=SMALL), seq.K, device="cpu"),
                        frames, chunked),
    }
    j, t = got["jax"], got["torch"]
    assert j["n_rebootstraps"] >= 1
    for key in ("n_poses", "n_rebootstraps", "anchors", "held", "held_pose_ok"):
        assert t[key] == j[key], (key, t[key], j[key])
    assert t["n_poses"] == N - t["gap"]
    assert len(t["held"]) >= 1 and not any(t["held_pose_ok"])
    for name, r in got.items():
        gap = r["gap"]
        ate = ate_rmse(r["traj"], seq.gt_positions()[gap: gap + len(r["traj"])])
        assert np.isfinite(ate) and ate < ATE_BOUND_M, (name, ate)

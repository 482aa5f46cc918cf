"""Lock-step of the sift-sift reference configuration (``configs/reference.yaml``: SIFT
bootstrap, five-point, sift-sift candidates) at the small size of
``tests/test_torch_lockstep.py``, 256 keypoints, 32 frames through ``run_chunked``: the
JAX package and the port from the same seed draw the same RANSAC samples.

Held equal: poses, pose_ok and re-bootstraps count and frames, and every PnP inlier
count. Measured (this file's run, the CPU): no MSAC winner swaps on this path, the
camera centers stay within 8.2e-4 of the JAX package's (median 6.5e-5), R within
4.2e-5, all 28 inlier counts equal. Tolerances, about twice that: R 1e-4, camera
center 2e-3.
"""

import os

import numpy as np
import pytest
import torch

from lcvo_tpu.pipeline import VisualOdometry as JVisualOdometry
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.pipeline import VisualOdometry
from test_torch_lockstep import assert_lockstep, configs, drive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_configuration_runs_in_lockstep():
    seq = SyntheticSequence(n_frames=N, width=320, height=128, speed=0.3)
    frames = np.stack([seq.frame(i) for i in range(N)]).astype(np.uint8)
    tcfg, jcfg = configs(os.path.join(ROOT, "configs", "reference.yaml"),
                         descriptor={"max_keypoints": 256})
    assert tcfg.find_new_candidates_method == "sift-sift" and tcfg.ransac.e_solver == "five_point"
    port = drive(VisualOdometry(tcfg, seq.K, device="cpu"), frames, "chunked")
    jax_run = drive(JVisualOdometry(jcfg, seq.K), frames, "chunked")
    cmp = assert_lockstep(port, jax_run, r_tol=1e-4, center_tol=2e-3)
    assert cmp["inliers_equal_share"] == 1.0 and all(port["pose_ok"])

"""Lock-step of the throughput configuration (``configs/throughput.yaml``: window BA,
sift-sift candidates, KLT bootstrap, eight-point) at the small size of
``tests/test_torch_lockstep.py``, 128 keypoints, a window of 4 every 3rd frame, 32
frames through ``run_chunked``: the JAX package and the port from the same seed draw the
same RANSAC samples.

Held equal: poses, pose_ok, re-bootstraps. Measured (this file's run, the CPU): the
eight-point bootstrap's winner swap of ``tests/test_torch_lockstep.py`` (the LAPACK
SVDs round apart), then camera centers within 0.063 of the JAX package's (median
0.051), R within 6.5e-3, 24 of 28 inlier counts equal (the first differs at entry 4).
Tolerances, about twice that: R 1.3e-2, camera center 0.13.
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


def test_throughput_configuration_with_ba_runs_in_lockstep():
    seq = SyntheticSequence(n_frames=N, width=320, height=128, speed=0.3)
    frames = np.stack([seq.frame(i) for i in range(N)]).astype(np.uint8)
    tcfg, jcfg = configs(os.path.join(ROOT, "configs", "throughput.yaml"),
                         descriptor={"max_keypoints": 128},
                         ba={"window": 4, "keyframe_every": 3, "gn_iters": 3})
    assert tcfg.ba.enabled
    port = drive(VisualOdometry(tcfg, seq.K, device="cpu"), frames, "chunked")
    jax_run = drive(JVisualOdometry(jcfg, seq.K), frames, "chunked")
    cmp = assert_lockstep(port, jax_run, r_tol=1.3e-2, center_tol=0.13)
    assert cmp["inliers_equal_share"] >= 0.5 and all(port["pose_ok"])

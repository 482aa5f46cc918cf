"""The port's metrics against the JAX package's on the same seeded numpy trajectories
(numpy float64 on both sides: agreement <= 1e-12), and the MetricsLogger row for row and
key for key, fed with the port's tensors on one side and numpy scalars on the other."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lcvo_tpu import metrics as jm
from lcvo_tpu_torch import metrics as tm

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _trajectory(seed: int, n: int = 260, step: float = 0.9):
    """A seeded drive with a turn in the middle: gt poses, and an estimate with another
    scale, a slow scale drift, yaw noise and position noise (what monocular VO leaves)."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(np.where((np.arange(n) > n // 3) & (np.arange(n) < n // 3 + 45),
                             np.radians(2.0), 0.0))
    gt = np.tile(np.eye(4), (n, 1, 1))
    est = gt.copy()
    p = np.zeros(3)
    q = np.zeros(3)
    for i in range(n):
        R = _yaw(yaw[i])
        gt[i, :3, :3], gt[i, :3, 3] = R, p
        est[i, :3, :3] = _yaw(yaw[i] + rng.normal(0, 0.004))
        est[i, :3, 3] = q + rng.normal(0, 0.01, 3)
        p = p + R @ np.array([0.0, 0.0, step])
        q = q + 0.37 * (1.0 - 0.0006 * i) * (R @ np.array([0.0, 0.0, step]))
    return est, gt


def _close(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_umeyama_and_ate_match(seed):
    est, gt = _trajectory(seed)
    for with_scale in (True, False):
        a = tm.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], with_scale)
        b = jm.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], with_scale)
        for x, y in zip(a, b):
            _close(x, y)
        _close(tm.ate_rmse(est[:, :3, 3], gt[:, :3, 3], with_scale),
               jm.ate_rmse(est[:, :3, 3], gt[:, :3, 3], with_scale))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_stats_and_rpe_pose_match(seed, delta):
    est, gt = _trajectory(seed)
    _close(tm.rpe_stats(est[:, :3, 3], gt[:, :3, 3], delta),
           jm.rpe_stats(est[:, :3, 3], gt[:, :3, 3], delta))
    a, b = tm.rpe_pose(est, gt, delta), jm.rpe_pose(est, gt, delta)
    assert a.keys() == b.keys()
    for k in a:
        _close(a[k], b[k])
    assert a["trans_rmse_m"] > 0 and a["rot_rmse_deg"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_scale_stats_match(seed):
    est, gt = _trajectory(seed)
    flags = np.random.default_rng(seed).uniform(size=len(est)) > 0.05
    for kw in ({}, {"seg": 30}, {"pose_ok": flags}):
        a = tm.segment_scale_stats(est[:, :3, 3], gt[:, :3, 3], **kw)
        b = jm.segment_scale_stats(est[:, :3, 3], gt[:, :3, 3], **kw)
        assert a == b and a["n_segments"] >= 5
    # the scale drift built into the estimate shows
    assert a["seg_scale_min"] < 1.0 < a["seg_scale_max"]
    assert tm.segment_scale_stats(est[:40, :3, 3], gt[:40, :3, 3]) == {} \
        == jm.segment_scale_stats(est[:40, :3, 3], gt[:40, :3, 3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kitti_metrics_match(seed):
    est, gt = _trajectory(seed)
    a, b = tm.kitti_odometry_error(est, gt), jm.kitti_odometry_error(est, gt)
    assert a[2] == b[2] > 0
    _close(a[:2], b[:2])
    a = tm.kitti_t_err_pct_pos(est[:, :3, 3], gt[:, :3, 3])
    b = jm.kitti_t_err_pct_pos(est[:, :3, 3], gt[:, :3, 3])
    assert a[1] == b[1] > 0
    _close(a[0], b[0])
    # shorter than the smallest segment: the "too short" answers agree too
    assert tm.kitti_odometry_error(est[:50], gt[:50]) == jm.kitti_odometry_error(est[:50], gt[:50]) \
        == (None, None, 0)
    assert tm.kitti_t_err_pct_pos(est[:50, :3, 3], gt[:50, :3, 3]) == (None, 0)


def test_rot_angle_and_scale_correction_match():
    est, gt = _trajectory(3)
    _close(tm._rot_angle_deg(est[:, :3, :3]), jm._rot_angle_deg(est[:, :3, :3]))
    _close(tm._scale_corrected(est, gt), jm._scale_corrected(est, gt))
    np.testing.assert_allclose(tm._rot_angle_deg(_yaw(np.radians(30.0))), 30.0, atol=1e-9)


def _result(rng, tensors: bool):
    vals = dict(pose_ok=bool(rng.uniform() > 0.2), n_tracked=int(rng.integers(50, 400)),
                n_inliers=int(rng.integers(10, 300)), n_candidates=int(rng.integers(0, 500)),
                n_promoted=int(rng.integers(0, 40)), reproj_rms=float(np.float32(rng.uniform(0.1, 2.0))))
    if tensors:  # what the port's FrameResult holds: 0-d tensors
        vals = {k: torch.tensor(v, dtype=torch.float32 if k == "reproj_rms" else None)
                for k, v in vals.items()}
    else:
        vals["reproj_rms"] = np.float32(vals["reproj_rms"])
    return SimpleNamespace(**vals)


def test_metrics_logger_rows_and_summary_match(tmp_path):
    tl = tm.MetricsLogger(str(tmp_path / "t.jsonl"))
    jl = jm.MetricsLogger(str(tmp_path / "j.jsonl"))
    for i in range(12):
        a = tl.log_frame(i, _result(np.random.default_rng(i), tensors=True))
        b = jl.log_frame(i, _result(np.random.default_rng(i), tensors=False))
        assert a == b and list(a) == list(b)
    for i in range(12, 20):
        a = tl.log_chunk_frame(i, i % 3 != 0, -1 if i % 5 == 0 else 100 + i)
        b = jl.log_chunk_frame(i, i % 3 != 0, -1 if i % 5 == 0 else 100 + i)
        assert list(a) == list(b)
        a.pop("t"), b.pop("t")
        assert a == b
    for lg in (tl, jl):
        lg.log_seg_scales([1.0, 0.98, 1.03])
        lg.close()
    st, sj = tl.summary(), jl.summary()
    assert list(st) == list(sj) == ["metric_rows", "pose_ok_rate", "mean_inliers",
                                    "mean_tracked", "mean_reproj_rms_px"]
    assert st == sj and st["metric_rows"] == 20
    rows_t = [json.loads(l) for l in open(tmp_path / "t.jsonl")]
    rows_j = [json.loads(l) for l in open(tmp_path / "j.jsonl")]
    assert len(rows_t) == len(rows_j) == 23
    for a, b in zip(rows_t, rows_j):
        assert list(a) == list(b)
        a.pop("t", None), b.pop("t", None)
        assert a == b
    assert rows_t[-1] == {"seg": 2, "seg_scale": 1.03}
    assert rows_t[12]["inliers"] is None or rows_t[15]["inliers"] is None


def test_metrics_logger_without_file_and_empty_summary():
    lg = tm.MetricsLogger()
    assert lg.summary() == {} == jm.MetricsLogger().summary()
    lg.log_chunk_frame(0, True, -1)
    assert lg.summary() == {"metric_rows": 1, "pose_ok_rate": 1.0, "mean_inliers": None}
    lg.log_seg_scales([1.0])   # no file: nothing to write, nothing raised
    lg.close()

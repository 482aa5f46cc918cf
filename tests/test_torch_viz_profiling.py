"""The port's visualization and profiling modules on the CPU: counterparts of the three
tests of tests/test_viz.py (fed with tensors, as the port's state and result hold them)
and of tests/test_profiling.py's trace test (tests/test_torch_tracing.py holds the
port's spans and recorder)."""

import json
import os

import numpy as np
import pytest
import torch

from lcvo_tpu_torch.utils import profiling
from lcvo_tpu_torch.viz import Dashboard, export_video, plot_trajectory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeTracks:
    def __init__(self, n=12):
        rng = np.random.default_rng(0)
        X = rng.uniform(-5, 30, (n, 3)).astype(np.float32)
        X[-2:] = 500.0  # beyond the 200 m range filter
        self.P = torch.from_numpy(rng.uniform(10, 100, (n, 2)).astype(np.float32))
        self.X = torch.from_numpy(X)
        self.valid = torch.ones(n, dtype=torch.bool)


class _FakeState:
    def __init__(self):
        self.tracks = _FakeTracks()


class _FakeResult:
    def __init__(self, i):
        self.R = torch.eye(3)
        self.t = torch.tensor([0.1 * i, 0.0, 0.3 * i])
        self.n_tracked = torch.tensor(12)


def _dash(tmp_path, n=3):
    rng = np.random.default_rng(0)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    dash = Dashboard(K)
    for i in range(n):
        img = torch.from_numpy(rng.uniform(0, 255, (96, 128)).astype(np.float32))
        dash.update(img, _FakeState(), _FakeResult(i))
        dash.render(str(tmp_path / f"dash_{i:03d}.png"))
    return dash


def test_dashboard_renders_frames(tmp_path):
    dash = _dash(tmp_path)
    pngs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".png"))
    assert len(pngs) == 3
    assert (tmp_path / pngs[0]).stat().st_size > 1000
    # the map panel scatters the current landmark cloud and the frame panel only
    # keypoints of in-range landmarks
    assert len(dash._landmarks) == 10            # 12 tracks, 2 beyond 200 m
    assert len(dash._last[1]) == 10
    assert isinstance(dash._last[0], np.ndarray) and dash.n_keypoints == [12, 12, 12]
    np.testing.assert_allclose(dash.positions[2], [-0.2, 0.0, -0.6], atol=1e-6)


def test_dashboard_matches_jax_package_history(tmp_path):
    """The same state and results as numpy through the JAX package's Dashboard: the
    history the panels draw from is the same."""
    from lcvo_tpu.viz import Dashboard as JDashboard

    class NP:
        def __init__(self, obj):
            for k, v in vars(obj).items():
                setattr(self, k, NP(v) if isinstance(v, _FakeTracks) else
                        (v.numpy() if isinstance(v, torch.Tensor) else v))

    K = np.eye(3)
    a, b = Dashboard(K), JDashboard(K)
    img = np.zeros((8, 8), np.float32)
    for i in range(3):
        a.update(torch.from_numpy(img), _FakeState(), _FakeResult(i))
        b.update(img, NP(_FakeState()), NP(_FakeResult(i)))
    np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
    np.testing.assert_array_equal(a._landmarks, b._landmarks)
    np.testing.assert_array_equal(a._last[1], b._last[1])
    assert a.n_keypoints == b.n_keypoints


def test_export_video_end_to_end(tmp_path):
    """Frames -> video artifact (mp4 with ffmpeg, else animated GIF via PIL)."""
    _dash(tmp_path)
    out = export_video(str(tmp_path), str(tmp_path / "run.mp4"), fps=5)
    assert os.path.exists(out), f"no video artifact: {out!r}"
    assert out.endswith((".mp4", ".gif"))
    assert os.path.getsize(out) > 1000
    with pytest.raises(ValueError, match="no absent_"):
        export_video(str(tmp_path), str(tmp_path / "x.mp4"), prefix="absent_")


def test_plot_trajectory(tmp_path):
    est = np.cumsum(np.tile([0.1, 0, 0.3], (20, 1)), axis=0)
    gt = est + 0.05
    p = str(tmp_path / "traj.png")
    plot_trajectory(est, gt, p, title="test")
    assert os.path.getsize(p) > 1000
    plot_trajectory(est, None, str(tmp_path / "nogt.png"))
    assert os.path.getsize(tmp_path / "nogt.png") > 1000


def test_trace_capture(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d) as prof:
        with profiling.span("lcvo.test_span"):
            (torch.ones((8, 8)) * 2).sum()
    # a Chrome/Perfetto trace with the named span in it
    assert os.listdir(d) == ["trace.json"]
    with open(os.path.join(d, "trace.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "lcvo.test_span" in names
    assert any(e.key == "lcvo.test_span" for e in prof.key_averages())

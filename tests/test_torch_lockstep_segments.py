"""Window lock-step (``tools/port_segment_lockstep.py``, the port's side in
``lcvo_tpu_torch/utils/segments.py``) on the CPU at the small size of
``tests/test_torch_lockstep.py`` (320x128, 256 tracks, ``frame_gap`` 4): the JAX package
runs uninterrupted and saves its state at window starts, the port resumes each state
(stripped of its image leaves, which it rebuilds from the frame before, and of all but the
last 17 host-list entries) and runs the window's frames with the same draws.

Cases: the default configuration (chunks of 8, windows of 16 frames); turn_robust
(sift-sift, window BA of 4 every 3rd frame, the window ring in the file); the noise burst
of ``tests/test_torch_lockstep_recovery.py`` on frames 18-20, its re-bootstrap inside the
window (its scale comes from the host history the state carries); and a host loop that
already ran a window against a fresh one, which must give the same entries bit for bit.

Held equal: pose_ok of every entry, the window's first inlier count, the number of
entries; the first entry's center within 1e-4. Measured (this file's runs, the CPU), the
largest unaligned camera-center distance to the JAX package's continuation in a window
(the bootstrap's baseline is 1): default 0.0089, turn_robust 0.00066, burst 0.106 (after
its re-bootstrap; 1.3e-5 before it). Tolerances about twice that: 0.02, 0.0015, 0.22.
Where a window parts, it parts in the PnP: on the JAX step's own inputs the port's
``pnp_ransac`` equals the JAX package's op by op, and XLA's compiled one differs from both
(``test_the_pnp_parts_by_xla_compilation``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from lcvo_tpu.pipeline import VisualOdometry as JVisualOdometry
from lcvo_tpu_torch.data.synthetic import SyntheticSequence, noise_burst
from lcvo_tpu_torch.pipeline import VisualOdometry
from lcvo_tpu_torch.utils import segments as segs
from test_torch_lockstep import configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import port_segment_lockstep as psl  # noqa: E402

N = 45
CHUNK = 8
BURST = (18, 21)
TURN = os.path.join(ROOT, "configs", "turn_robust.yaml")
TURN_OVER = {"descriptor": {"max_keypoints": 128},
             "ba": {"window": 4, "keyframe_every": 3, "gn_iters": 3}}
# case: (config file, overrides, frames, window starts, largest center distance)
CASES = {
    "default": (None, {}, "clean", (21, 37), 0.02),
    "turn_robust": (TURN, TURN_OVER, "clean", (21, 37), 0.0015),
    "burst": (None, {}, "burst", (13,), 0.22),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=N, width=320, height=128, speed=0.3)


@pytest.fixture(scope="module")
def frames(seq):
    clean = np.stack([seq.frame(i) for i in range(N)]).astype(np.uint8)
    return {"clean": clean, "burst": noise_burst(clean, *BURST, seed=3)}


@pytest.fixture(scope="module")
def segments(seq, frames, tmp_path_factory):
    """Per case: the JAX package's run with its window states, and the stripped copy."""
    out = {}
    for name, (path, over, which, starts, _) in CASES.items():
        _, jcfg = configs(path, **over)
        d = tmp_path_factory.mktemp(name)
        src = segs.array_frames(frames[which], seq.K)
        rec = psl.run_jax(JVisualOdometry(jcfg, seq.K), src, "chunked", str(d / "full"),
                          starts=starts, chunk=CHUNK)
        psl.strip_segments(str(d / "full"), str(d / "up"))
        out[name] = (rec, str(d / "up"), src)
    return out


def _port(name, seq, segments, vo=None):
    path, over, _, _, _ = CASES[name]
    tcfg, _ = configs(path, **over)
    rec, up, src = segments[name]
    vo = vo or VisualOdometry(tcfg, seq.K, device="cpu")
    return vo, [segs.run_port_window(vo, up, rec, w, src) for w in rec["windows"]]


@pytest.mark.parametrize("name", list(CASES))
def test_windows_from_the_jax_packages_states_run_in_lockstep(name, seq, segments):
    rec, _, _ = segments[name]
    _, runs = _port(name, seq, segments)
    for w, got in zip(rec["windows"], runs):
        cmp = segs.compare_window(w["jax"], got, w["start"], w["anchor"]["centers"])
        assert cmp["entries"] == len(w["jax"]["pose_ok"]) == w["end"] - w["start"], cmp
        assert got["pose_ok"] == w["jax"]["pose_ok"], cmp
        assert got["n_inliers"][0] == w["jax"]["n_inliers"][0], cmp
        assert cmp["distance_m_first"] < 1e-4, cmp
        assert cmp["distance_m_max"] <= CASES[name][4], cmp
    if name == "burst":
        # the re-bootstrap is inside the window, in both packages
        assert rec["jax_rebootstraps"] == 1 and -1 in rec["windows"][0]["jax"]["n_inliers"]
        assert -1 in runs[0]["n_inliers"]


def test_a_host_loop_that_already_ran_resumes_as_a_fresh_one(seq, segments):
    """turn_robust (BA): the second window resumed into the loop that ran the first, and
    into a new ``VisualOdometry``: the same entries bit for bit."""
    vo, runs = _port("turn_robust", seq, segments)
    rec, up, src = segments["turn_robust"]
    fresh = segs.run_port_window(VisualOdometry(vo.cfg, seq.K, device="cpu"), up, rec,
                                rec["windows"][1], src)
    again = segs.run_port_window(vo, up, rec, rec["windows"][1], src)
    for k in ("centers", "rotations", "pose_ok", "n_inliers"):
        assert fresh[k] == runs[1][k] == again[k], k


def test_a_stripped_state_resumes_as_the_full_one(seq, segments, tmp_path):
    """The image leaves rebuilt from the frame before equal the writer's, and the cut
    host lists are what a resumed loop reads: the same step after either file."""
    from lcvo_tpu_torch.utils import checkpoint as ckpt

    rec, up, src = segments["default"]
    w = rec["windows"][0]
    tcfg, _ = configs()
    full = os.path.join(os.path.dirname(up), "full", w["state"])
    assert ckpt.has_image_leaves(full) and not ckpt.has_image_leaves(os.path.join(up, w["state"]))
    a, b = VisualOdometry(tcfg, seq.K, device="cpu"), VisualOdometry(tcfg, seq.K, device="cpu")
    a.resume(full)
    with pytest.raises(ValueError, match="prev_frame"):
        b.resume(os.path.join(up, w["state"]))
    b.resume(os.path.join(up, w["state"]), prev_frame=src.frame(w["start"] - 1))
    torch.testing.assert_close(b.state.prev_image, a.state.prev_image, rtol=0, atol=0)
    for x, y in zip(b.state.prev_pyramid, a.state.prev_pyramid):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert len(b.trajectory) == ckpt.HOST_HISTORY
    assert a._recent_step_scale() == b._recent_step_scale()
    ra, rb = a.step(src.frame(w["start"])), b.step(src.frame(w["start"]))
    torch.testing.assert_close(rb.t, ra.t, rtol=0, atol=0)


def test_a_file_may_lack_only_its_image_leaves(seq, segments, tmp_path):
    """``load_checkpoint`` of a stripped file keeps the template's image leaves, and a
    file that lacks any other leaf raises ``KeyError``."""
    from lcvo_tpu_torch.core import state as tst
    from lcvo_tpu_torch.utils import checkpoint as ckpt

    rec, up, _ = segments["default"]
    tcfg, _ = configs()
    tmpl = tst.make_vo_state(tcfg, (128, 320), "cpu")
    path = os.path.join(up, rec["windows"][0]["state"])
    state = ckpt.load_checkpoint(path, tmpl)[0]
    assert state.prev_image is tmpl.prev_image
    assert all(a is b for a, b in zip(state.prev_pyramid, tmpl.prev_pyramid))
    with np.load(path) as data:
        np.savez(tmp_path / "lacks_R.npz", **{k: data[k] for k in data.files if k != "state:.R"})
    with pytest.raises(KeyError, match="state:.R"):
        ckpt.load_checkpoint(str(tmp_path / "lacks_R.npz"), tmpl)


def test_the_pnp_parts_by_xla_compilation(seq, frames, segments):
    """The default case's first window: where the centers first move apart, the probe
    from the JAX package's state there finds the PnP; on the JAX step's own inputs the
    port's ``pnp_ransac`` equals the JAX package's op by op (to 1e-5), and XLA's
    compiled ``pnp_ransac`` is as far from both."""
    path, over, _, _, _ = CASES["default"]
    tcfg, jcfg = configs(path, **over)
    rec, _, src = segments["default"]
    _, runs = _port("default", seq, segments)
    w = rec["windows"][0]
    cmp = segs.compare_window(w["jax"], runs[0], w["start"], w["anchor"]["centers"])
    assert cmp["first_frame"] is not None
    full = os.path.join(os.path.dirname(segments["default"][1]), "full")
    probe = psl.probe_frame(jcfg, tcfg, seq.K, full, w, src, cmp["first_frame"], CHUNK)
    pnp = probe["pnp_on_the_jax_steps_inputs"]
    assert len(set(pnp["n_inliers"].values())) == 1, pnp
    assert pnp["port_vs_jax_op_by_op"]["t_max"] < 1e-5, pnp
    assert pnp["port_vs_jax"]["t_max"] > 100 * pnp["port_vs_jax_op_by_op"]["t_max"], pnp
    assert pnp["winner"]["port"]["best"] == pnp["winner"]["jax_op_by_op"]["best"], pnp
    assert probe["port_vs_jax"]["tracks_px"]["max"] < 1e-3, probe


def test_drift_of_synthetic_windows():
    """Scale: a run whose steps grow from 1x to 2x the truth's reads log2 = 1, one at
    constant scale 0; rotation: a run that turns 5 degrees more than the truth over the
    window reads 5."""
    n = 40
    gt = np.stack([np.arange(n + 1, dtype=float), np.zeros(n + 1), np.zeros(n + 1)], 1)
    eye = np.tile(np.eye(3), (n + 1, 1, 1))
    steps = np.linspace(1.0, 2.0, n)
    grow = np.vstack([[0, 0, 0], np.stack([np.cumsum(steps), np.zeros(n), np.zeros(n)], 1)])
    d = psl.drift(grow, eye, gt, eye, span=1)
    assert d["scale_log2"] == pytest.approx(np.log2(steps[-1] / steps[0]))
    assert psl.drift(3 * gt, eye, gt, eye)["scale_log2"] == pytest.approx(0.0, abs=1e-12)

    def yaw(a):
        c, s = np.cos(np.radians(a)), np.sin(np.radians(a))
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    truth = np.stack([yaw(a) for a in np.linspace(0, 30, n + 1)])
    est = np.stack([yaw(a) for a in np.linspace(0, 35, n + 1)])
    assert psl.drift(gt, est, gt, truth)["rot_deg"] == pytest.approx(5.0, abs=1e-6)


def test_sign_test_and_first_frames_on_synthetic_windows():
    """Ties drop out of the sign test; the port worse in all of 10 windows is p = 2^-10
    one-sided. A window's first parted and first apart frames."""
    out = psl.sign_test([2.0] * 10 + [1.0], [1.0] * 10 + [1.0])
    assert (out["port_worse"], out["port_better"], out["ties"]) == (10, 0, 1)
    assert out["p_port_worse"] == pytest.approx(2.0 ** -10)
    assert psl.sign_test([1.0, 2.0], [2.0, 1.0])["p_two_sided"] == pytest.approx(1.0)
    ref = {"centers": [[float(i), 0, 0] for i in range(1, 6)], "pose_ok": [True] * 5,
           "n_inliers": [50, 49, 48, 47, 46]}
    run = {"centers": [[float(i), 0, 0] for i in range(1, 6)], "pose_ok": [True] * 5,
           "n_inliers": [50, 49, 47, 47, 46]}
    run["centers"][1] = [2.02, 0, 0]      # 2% of a unit step off
    cmp = segs.compare_window(ref, run, 100, anchor=[0.0, 0, 0])
    assert (cmp["first_apart_frame"], cmp["first_parted_frame"], cmp["first_frame"]) == (101, 102, 101)
    assert cmp["distance_m_max"] == pytest.approx(0.02) and cmp["pose_ok_equal_share"] == 1.0

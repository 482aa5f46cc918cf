"""Fault injection on the port (counterparts of ``tests/test_fault_injection.py``, with
its assertions and bounds): corrupted-frame bursts trip ``health`` and the host loop
re-bootstraps from the last good pose at the pre-failure metric scale, in the per-frame
and the chunked loop and through the CLI; a gutted track table refills by re-detection;
a cleared one is detected. The burst with window BA on is in
``tests/test_torch_fault_injection_ba.py``.

Sizes: the JAX file runs 416x160 with 1024 tracks; the port on the CPU runs the same
scenarios at the small size of ``tests/test_torch_pipeline.py`` (320x128, 256 tracks,
``frame_gap`` 4), and the scenario the JAX file runs twice (52 frames, burst at 20-22)
once, shared by its two tests; the forced track drop at the JAX file's own size and
configuration (its test's docstring says why). The full-width versions run on the card
(``chip_smoke.py`` ``[recovery*]``).
"""

import numpy as np
import pytest
import torch

from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.metrics import ate_rmse
from lcvo_tpu_torch.pipeline import VisualOdometry

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


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=60, width=W, height=H)


@pytest.fixture(scope="module")
def cfg():
    return load_config(overrides=SMALL)


def _burst_frames(seq, n, start, stop, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        f = seq.frame(i)
        if start <= i < stop:
            f = rng.uniform(0, 255, size=f.shape).astype(f.dtype)
        yield f


def test_corrupted_frame_burst_triggers_rebootstrap(seq, cfg):
    """Noise frames destroy KLT tracking; the health counter must trip and the host loop
    must re-bootstrap anchored at the last good pose, then keep running."""
    n = 46
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    traj = vo.run(_burst_frames(seq, n, 20, 23, 0), n)
    assert len(traj) > 10
    assert vo.n_rebootstraps >= 1
    assert int(vo.state.health) == 0
    ok_tail = [bool(r.pose_ok) for r in vo.results[-8:]]
    assert all(ok_tail), f"pipeline did not recover after fault burst: {ok_tail}"
    assert int(vo.state.tracks.count()) >= cfg.ransac.min_pnp_inliers


@pytest.fixture(scope="module")
def burst_run_52(seq, cfg):
    """The scenario the JAX file runs twice: 52 frames, burst at 20-22, per-frame loop."""
    n = 52
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    traj = vo.run(_burst_frames(seq, n, 20, 23, 1), n)
    return vo, np.asarray(traj), n


def test_rebootstrap_trajectory_continuity(seq, cfg, burst_run_52):
    """One pose per frame across a forced re-bootstrap, so ground truth aligns index
    for index, and the Sim(3)-aligned ATE of the whole recovered trajectory < 1.0 m."""
    vo, est, n = burst_run_52
    gap = cfg.bootstrap.frame_gap
    assert vo.n_rebootstraps >= 1
    assert len(est) == n - gap, (len(est), n - gap)
    assert len(vo.results) == len(est)
    gt = seq.gt_positions()[gap: gap + len(est)]
    ate = ate_rmse(est, gt)
    assert np.isfinite(ate) and ate < 1.0, f"ATE across re-bootstrap too large: {ate}"


def test_rebootstrap_preserves_metric_scale(cfg, burst_run_52):
    """The re-initialized map keeps the pre-failure metric scale: median step length
    after recovery within 0.75-1.33 of before."""
    vo, est, _ = burst_run_52
    gap = cfg.bootstrap.frame_gap
    d = np.linalg.norm(np.diff(est, axis=0), axis=1)
    flags = np.asarray(vo.pose_ok_flags, bool)
    good = flags[:-1] & flags[1:] & (d > 1e-9)
    pre = d[: 20 - gap - 1][good[: 20 - gap - 1]]
    post = d[-12:][good[-12:]]
    assert len(pre) >= 5 and len(post) >= 5, (len(pre), len(post))
    ratio = float(np.median(post) / np.median(pre))
    assert 0.75 < ratio < 1.33, f"metric scale not preserved across re-bootstrap: {ratio:.3f}"


def test_forced_track_drop_refills_via_redetection():
    """Clearing all but 8 tracks mid-run does not kill the pipeline: candidates are
    re-detected and promoted and the table grows past 3 x 8 again. At
    ``tests/test_fault_injection.py``'s own configuration (416x160, the dataclass
    defaults): there both packages, drawing the same samples, refill to 65-68 tracks
    (17 s on one thread). At this file's 320x128 with 512 tracks both end on the bound
    (``tools/port_track_drop.py --tracks 512``, seed 0: the JAX package 25, the port 24,
    its pyramid rounding the KLT chain 1e-4 px apart; seeds 1 and 2 equal in both), and
    with 256 tracks neither refills past 24."""
    cfg = load_config(overrides={"image_width": 416, "image_height": 160})
    seq = SyntheticSequence(n_frames=60, width=416, height=160)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    n_boot = cfg.bootstrap.frame_gap + 1
    vo.bootstrap([seq.frame(i) for i in range(n_boot)])
    for i in range(n_boot, 20):
        vo.step(seq.frame(i))

    before = int(vo.state.tracks.count())
    assert before > 20
    valid = vo.state.tracks.valid
    keep = torch.zeros_like(valid)
    keep[torch.nonzero(valid).flatten()[:8]] = True
    vo.state = vo.state._replace(tracks=vo.state.tracks._replace(valid=keep))
    assert int(vo.state.tracks.count()) == 8

    counts = []
    for i in range(20, 40):
        res = vo.step(seq.frame(i))
        counts.append(int(res.n_tracked))
    assert int(vo.state.health) == 0
    assert counts[-1] > 3 * 8, f"track table did not refill: {counts}"


def _chunked_burst(cfg, n, start, stop, seed, chunk=8):
    sq = SyntheticSequence(n_frames=n, width=W, height=H)
    frames = np.stack([sq.frame(i) for i in range(n)])
    rng = np.random.default_rng(seed)
    frames[start:stop] = rng.uniform(0, 255, frames[start:stop].shape).astype(frames.dtype)
    vo = VisualOdometry(cfg, sq.K, device="cpu")
    traj = vo.run_chunked(frames, chunk=chunk)
    return vo, sq, np.asarray(traj)


def test_chunked_mode_rebootstraps_after_corruption(cfg):
    """The chunked loop survives a burst too: health trips inside a chunk, the host loop
    re-bootstraps between chunks, one pose per frame, ATE < 1.0 m, and the steps after
    recovery keep the pre-failure metric scale."""
    n = 48
    vo, sq, est = _chunked_burst(cfg, n, 18, 21, 3)
    gap = cfg.bootstrap.frame_gap
    assert len(est) == n - gap, (len(est), n - gap)
    assert vo.n_rebootstraps >= 1
    assert int(vo.state.health) == 0
    ate = ate_rmse(est, sq.gt_positions()[gap: gap + len(est)])
    assert np.isfinite(ate) and ate < 1.0, f"chunked-recovery ATE {ate:.2f} m"
    d = np.linalg.norm(np.diff(est, axis=0), axis=1)
    ratio = float(np.median(d[-8:]) / np.median(d[:8]))
    assert 0.75 < ratio < 1.33, f"chunked scale seam: {ratio:.3f}"


def test_chunked_sequence_ends_during_recovery_burst(cfg):
    """The sequence runs out while the re-bootstrap burst is still filling: the host loop
    holds the anchor pose for the frames it took, and does not run the last chunk's
    frames through the per-frame tail: exactly one pose per frame from the gap on."""
    n = 33
    vo, _, est = _chunked_burst(cfg, n, 27, 31, 5)
    gap = cfg.bootstrap.frame_gap
    assert vo.n_rebootstraps >= 1
    assert len(est) == n - gap, (len(est), n - gap)
    assert len(vo.poses) == len(est)


def test_total_track_loss_increments_health(seq, cfg):
    """Clearing the whole table (tracks and candidates) is detected: pose_ok False and
    health >= 1."""
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    n_boot = cfg.bootstrap.frame_gap + 1
    vo.bootstrap([seq.frame(i) for i in range(n_boot)])
    vo.step(seq.frame(n_boot))
    s = vo.state
    vo.state = s._replace(
        tracks=s.tracks._replace(valid=torch.zeros_like(s.tracks.valid)),
        cands=s.cands._replace(valid=torch.zeros_like(s.cands.valid)),
    )
    res = vo.step(seq.frame(n_boot + 1))
    assert not bool(res.pose_ok)
    assert int(vo.state.health) >= 1


def test_chunked_cli_summary_reports_recovery(tmp_path):
    """The port's CLI tells the truth through a recovery: a corrupted KITTI-layout
    dataset on disk, the chunked CLI on the CPU, a counted re-bootstrap, a pose_ok rate
    under 1 and one metrics row per trajectory entry."""
    from PIL import Image

    from lcvo_tpu_torch.cli import run as cli

    n = 48
    seq4 = SyntheticSequence(n_frames=n, width=W, height=H)
    rng = np.random.default_rng(7)
    root = tmp_path / "kitti-dataset"
    (root / "05" / "image_0").mkdir(parents=True)
    (root / "poses").mkdir()
    for i in range(n):
        f = np.clip(seq4.frame(i), 0, 255)
        if 20 <= i < 23:
            f = rng.uniform(0, 255, size=f.shape)
        Image.fromarray(f.astype(np.uint8)).save(root / "05" / "image_0" / f"{i:06d}.png")
    rows = [np.hstack([seq4.R_wc[i], seq4.t_wc[i].reshape(3, 1)]).reshape(-1) for i in range(n)]
    np.savetxt(root / "poses" / "05.txt", np.stack(rows))
    p0 = np.hstack([seq4.K, np.zeros((3, 1))]).reshape(-1)
    (root / "05" / "calib.txt").write_text("P0: " + " ".join(f"{v:.12e}" for v in p0) + "\n")
    small_yaml = tmp_path / "small.yaml"
    small_yaml.write_text("state: {max_tracks: 256, max_candidates: 256, max_new_per_frame: 96}\n"
                          "klt: {window: 15, iters: 8, levels: 3}\n"
                          "ransac: {e_hypotheses: 256, pnp_hypotheses: 256}\n")

    out = cli.summarise_only([
        "--dataset", "kitti", "--data-root", str(tmp_path), "--config", str(small_yaml),
        "--frames", str(n), "--chunked", "--out", str(tmp_path / "run"), "--device", "cpu",
    ])
    assert out["n_rebootstraps"] >= 1, out
    assert out["pose_ok_rate"] < 1.0, out
    assert out["metric_rows"] == out["frames"], out

"""The port's pipeline with sliding-window BA on: one keyframe step against the JAX
package from a carried-over ``(state, window)``, the per-frame and the chunked loop on
the CPU under the bounds of ``tests/test_pipeline.py``, and the host's mirror of
``frame_idx`` that decides the BA cadence.

Stated tolerances for the keyframe step (``process_frame`` with the JAX package's PnP
samples, then push + refine): live R, t and the ring's R, t <= 1e-3; ``head`` and
``kf_valid`` equal; the pushed row's ``obs_valid``/``obs_gen`` differ on <= 1% of slots
and its ``obs`` agree to 1e-2 px where both sides hold the track; refined landmarks
<= 2e-2 where both sides adjusted them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.config import load_config as jload_config
from lcvo_tpu.ops import ransac as jransac
from lcvo_tpu.pipeline import VisualOdometry as JVisualOdometry
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.core.state import state_from_numpy, window_from_numpy
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.metrics import ate_rmse
from lcvo_tpu_torch.ops.ransac import sample_minimal_sets as port_sample
from lcvo_tpu_torch.pipeline import (VisualOdometry, keyframes_in, make_ba_step, make_chunk_fn,
                                     make_process_frame, uniforms_fn)
from lcvo_tpu_torch.utils import jax_random
from test_torch_pipeline import chunked_keys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the small configuration of tests/test_pipeline.py
SMALL = {
    "image_width": 320, "image_height": 128,
    "state": {"max_tracks": 512, "max_candidates": 768, "max_new_per_frame": 128},
    "klt": {"window": 15, "iters": 8, "levels": 3},
    "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
    "bootstrap": {"frame_gap": 4},
}
BA = {"enabled": True, "window": 6, "keyframe_every": 3, "gn_iters": 4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine and slows these tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(**over):
    return load_config(overrides={**SMALL, **over})


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=60, width=320, height=128, speed=0.3)


@pytest.fixture(scope="module")
def frames(seq):
    return np.stack([seq.frame(i) for i in range(60)])


def _ate(vo, seq):
    gap = vo.cfg.bootstrap.frame_gap
    est = np.asarray(vo.trajectory)
    return ate_rmse(est, seq.gt_positions()[gap: gap + len(est)])


def test_ba_keyframe_step_parity(seq, frames):
    """JAX bootstrap and five steps (keyframes at frame_idx 2 and 4), state and window
    carried across, then the step that ends on frame_idx 6 on both sides."""
    over = {**SMALL, "ba": {**BA, "keyframe_every": 2, "gauge": "newest"}}
    jcfg, tcfg = jload_config(overrides=over), load_config(overrides=over)
    gap = jcfg.bootstrap.frame_gap
    jvo = JVisualOdometry(jcfg, seq.K)
    jvo.bootstrap([frames[i] for i in range(gap + 1)])
    for i in range(gap + 1, gap + 6):
        jvo.step(frames[i])
    assert int(jvo.state.frame_idx) == 5 and int(jvo.window.head) == 2
    to_np = lambda tree: jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)
    tstate = state_from_numpy(to_np(jvo.state), device="cpu")
    twindow = window_from_numpy(to_np(jvo.window), device="cpu")

    key = jvo._next_key()
    k_pnp, _ = jax.random.split(key)

    def jax_samples(valid):
        idx = jransac.sample_minimal_sets(k_pnp, valid.shape[0], jnp.asarray(valid.numpy()),
                                          jcfg.ransac.pnp_hypotheses, 3)
        idx = torch.from_numpy(np.array(idx)).long()
        # the port's own draw from the step's key is the JAX package's, exactly
        u = uniforms_fn(jcfg.ransac.pnp_hypotheses, "cpu")(np.asarray(key)[None])[0]
        assert torch.equal(port_sample(u, valid.shape[0], valid.bool()), idx)
        return idx

    img = frames[gap + 6]
    jvo.state, jres = jvo._process(jvo.state, jnp.asarray(img), key)
    assert int(jvo.state.frame_idx) % jcfg.ba.keyframe_every == 0
    jvo._ba_step()

    fn = make_process_frame(tcfg, seq.K, "cpu")
    tstate, tres = fn(tstate, torch.from_numpy(img.copy()), None, pnp_sampler=jax_samples)
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-3)
    tstate, twindow, ba_res = make_ba_step(tcfg, seq.K, "cpu")(tstate, twindow)

    jw, js = jvo.window, jvo.state
    np.testing.assert_allclose(tstate.R.numpy(), np.asarray(js.R), atol=1e-3)
    np.testing.assert_allclose(tstate.t.numpy(), np.asarray(js.t), atol=1e-3)
    np.testing.assert_allclose(twindow.R.numpy(), np.asarray(jw.R), atol=1e-3)
    np.testing.assert_allclose(twindow.t.numpy(), np.asarray(jw.t), atol=1e-3)
    assert int(twindow.head) == int(jw.head) == 3
    np.testing.assert_array_equal(twindow.kf_valid.numpy(), np.asarray(jw.kf_valid))
    # the two older rows came across, so they are equal; the pushed row follows the
    # two trackers' outputs
    for f in ("obs", "obs_gen", "obs_valid"):
        np.testing.assert_array_equal(getattr(twindow, f).numpy()[:2], np.asarray(getattr(jw, f))[:2])
    tv, jv = twindow.obs_valid.numpy()[2], np.asarray(jw.obs_valid)[2]
    assert np.mean(tv != jv) <= 0.01
    assert np.mean(twindow.obs_gen.numpy()[2] != np.asarray(jw.obs_gen)[2]) <= 0.01
    both = tv & jv
    assert both.sum() > 100
    assert np.abs(twindow.obs.numpy()[2][both] - np.asarray(jw.obs)[2][both]).max() <= 1e-2
    # refined landmarks and retired anchors
    t_adj = tstate.tracks.ang.numpy() == np.float32(np.pi)
    j_adj = np.asarray(js.tracks.ang) == np.float32(np.pi)
    sel = t_adj & j_adj & tstate.tracks.valid.numpy() & np.asarray(js.tracks.valid)
    assert sel.sum() > 100 and np.mean(t_adj != j_adj) <= 0.02
    assert np.abs(tstate.tracks.X.numpy()[sel] - np.asarray(js.tracks.X)[sel]).max() <= 2e-2
    assert float(ba_res.cost) <= float(ba_res.cost0)
    assert int(tstate.frame_idx) == 6


@pytest.fixture(scope="module")
def per_frame_and_chunked(seq, frames):
    """The per-frame loop fed the chunked loop's keys (the JAX package's loops split
    the chain otherwise), and the chunked loop."""
    cfg = small(ba=BA)
    vo_a = VisualOdometry(cfg, seq.K, device="cpu")
    keys = iter(chunked_keys(cfg.seed, 40, cfg.bootstrap.frame_gap, 8))
    vo_a._next_key = lambda: next(keys)
    vo_a.run(iter(list(frames[:40])), n_frames=40)
    vo_b = VisualOdometry(cfg, seq.K, device="cpu")
    vo_b.run_chunked(frames[:40], chunk=8)
    return vo_a, vo_b


def test_chunked_ba_matches_per_frame(per_frame_and_chunked):
    """BA inside the chunked loop gives the trajectory of the per-frame loop on the
    same cadence: median distance < 0.1 m as tests/test_pipeline.py asks, and here,
    with the per-frame loop fed the chunked loop's keys, the same to 1e-6."""
    vo_a, vo_b = per_frame_and_chunked
    est_a, est_b = np.asarray(vo_a.trajectory), np.asarray(vo_b.trajectory)
    assert len(est_a) == len(est_b) == 36
    delta = np.linalg.norm(est_a - est_b, axis=1)
    assert np.median(delta) < 0.1
    np.testing.assert_allclose(est_a, est_b, atol=1e-6)
    assert bool(vo_b.window.kf_valid.any())
    for a, b in zip(vo_a.window, vo_b.window):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_ba_cadence_counts_and_ring_after_the_wrap(per_frame_and_chunked, seq):
    """35 steps at keyframe_every 3: 11 keyframes, 11 refines, none of which raised
    its cost; the ring of 6 wrapped, so every slot is real and head = 11 % 6."""
    for vo in per_frame_and_chunked:
        assert vo._frame_idx == int(vo.state.frame_idx) == 35
        assert vo.n_keyframes == 11
        assert vo.ba_refine_stats() == (11, 0)
        assert bool(vo.window.kf_valid.all()) and int(vo.window.head) == 11 % 6
        assert _ate(vo, seq) < 0.5
        assert all(vo.pose_ok_flags) and vo.n_rebootstraps == 0


@pytest.mark.parametrize("idx,n,every,want", [(0, 16, 5, 3), (16, 16, 5, 3), (4, 1, 5, 1),
                                              (5, 4, 5, 0), (0, 0, 3, 0), (7, 9, 1, 9)])
def test_keyframes_in(idx, n, every, want):
    assert keyframes_in(idx, n, every) == want
    assert want == sum((idx + j + 1) % every == 0 for j in range(n))


def test_full_run_with_ba(seq, frames):
    """Sliding-window BA enabled: the trajectory stays accurate and BA really runs."""
    cfg = small(ba=BA)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.run(iter(frames), n_frames=60)
    est = np.asarray(vo.trajectory)
    assert len(est) >= 50
    err = _ate(vo, seq)
    assert err < 0.5, f"ATE with BA {err:.3f} m too large"
    assert bool(vo.window.kf_valid.any())
    assert vo.ba_refine_stats() == (vo.n_keyframes, 0) and vo.n_keyframes == 55 // 3


def test_full_run_turn_robust_config(seq, frames):
    """The turn-robust operating point (anchor re-triangulation + full window BA at
    the NEWEST gauge) runs the whole loop, stays accurate, and retires the anchors of
    the slots BA adjusted."""
    cfg = small(ba={**BA, "gauge": "newest"}, triangulation={"track_refine": True})
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.run(iter(frames), n_frames=60)
    est = np.asarray(vo.trajectory)
    assert len(est) >= 50
    err = _ate(vo, seq)
    assert err < 0.5, f"turn-robust ATE {err:.3f} m too large"
    assert bool(vo.window.kf_valid.any())
    assert np.any(np.isclose(vo.state.tracks.ang.numpy(), np.pi))


@pytest.mark.parametrize("ba_over", [{"landmarks_only": True}, {"gauge": "oldest"}],
                         ids=["landmarks_only", "oldest"])
def test_run_chunked_other_ba_settings(seq, frames, ba_over):
    cfg = small(ba={**BA, **ba_over})
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.run_chunked(frames[:25], chunk=8)
    assert len(vo.trajectory) == 21 and _ate(vo, seq) < 0.5
    assert vo.ba_refine_stats() == (20 // 3, 0)


@pytest.mark.parametrize("chunked", [False, True], ids=["per_frame", "chunked"])
def test_frame_idx_mirror_follows_rebootstraps(seq, frames, chunked):
    """An unsatisfiable min_pnp_inliers forces re-bootstraps. Each starts frame_idx
    and the keyframe ring again; the host's mirror equals the device's counter at the
    end, and the ring holds no keyframe from before the last bootstrap."""
    cfg = small(ba={**BA, "keyframe_every": 2},
                ransac={"e_hypotheses": 256, "pnp_hypotheses": 256, "min_pnp_inliers": 10**6},
                bootstrap={"frame_gap": 4, "rebootstrap_skip": 2})
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    if chunked:
        vo.run_chunked(frames[:22], chunk=4)
    else:
        vo.run(iter(frames[:22]), n_frames=22)
    assert vo.n_rebootstraps >= 2
    assert len(vo.trajectory) == 18 and np.all(np.isfinite(np.asarray(vo.trajectory)))
    assert vo._frame_idx == int(vo.state.frame_idx) < 8
    assert int(vo.window.kf_valid.sum()) == vo._frame_idx // 2
    assert int(vo.window.head) == vo._frame_idx // 2


def test_chunk_fn_reads_frame_idx_when_not_given(seq, frames):
    """``chunk_fn`` with the caller's frame_idx and without (read from the device)
    give the same carry; ``set_chunk_carry`` without a frame count reads the mirror
    back; a state swapped in behind the loop's back is caught at the next read-back."""
    cfg = small(ba=BA)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.bootstrap(list(frames[:5]))
    vo.step(frames[5])
    refines = []
    chunk_fn = make_chunk_fn(cfg, seq.K, "cpu", on_refine=refines.append)
    batch = torch.from_numpy(frames[6:11].copy())
    keys = jax_random.split(vo._next_key(), 5)
    (s1, w1), outs1 = chunk_fn(vo.chunk_carry(), batch, keys, frame_idx=1)
    (s2, w2), outs2 = chunk_fn(vo.chunk_carry(), batch, keys)
    assert len(refines) == 4 and all(float(r.cost) <= float(r.cost0) for r in refines)
    for a, b in zip(outs1 + tuple(w1) + (s1.R, s1.t, s1.tracks.X),
                    outs2 + tuple(w2) + (s2.R, s2.t, s2.tracks.X)):
        assert torch.equal(a, b)
    assert int(w1.head) == 2 and int(s1.frame_idx) == 6
    assert outs1[0].shape == (5, 3, 3) and outs1[3].shape == (5,)

    vo.set_chunk_carry((s1, w1))
    assert vo._frame_idx == 6
    vo.set_chunk_carry((s1, w1), 0)
    assert vo._frame_idx == 6 and vo.n_keyframes == 0
    vo.state = vo.state._replace(frame_idx=vo.state.frame_idx + 1)
    with pytest.raises(RuntimeError, match="mirror of frame_idx"):
        vo.run_chunked_continue(iter(frames[11:19]), produced=11, chunk=4, n_frames=19)


def test_chunk_carry_without_ba_is_the_state(seq, frames):
    cfg = small()
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.bootstrap(list(frames[:5]))
    assert vo.window is None and vo.chunk_carry() is vo.state
    assert vo.ba_refine_stats() == (0, 0)
    state, _ = make_chunk_fn(cfg, seq.K, "cpu")(vo.chunk_carry(), torch.from_numpy(frames[5:7].copy()),
                                               jax_random.split(vo._next_key(), 2),
                                               frame_idx=0)
    vo.set_chunk_carry(state, 2)
    assert vo._frame_idx == int(vo.state.frame_idx) == 2 and vo.n_keyframes == 0


@pytest.mark.parametrize("name", ["throughput.yaml", "turn_robust.yaml"])
def test_ba_config_files_are_supported_at_full_width(seq, name):
    """Both shipped BA configurations construct the port's VisualOdometry on the CPU:
    1240x376, 1024 tracks, window 10, every 5th frame, five LM steps, newest gauge."""
    cfg = load_config(os.path.join(ROOT, "configs", name))
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    assert (cfg.ba.window, cfg.ba.keyframe_every, cfg.ba.gn_iters, cfg.ba.gauge) == (10, 5, 5, "newest")
    assert tuple(vo.window.obs.shape) == (10, 1024, 2) and int(vo.window.head) == 0
    assert not bool(vo.window.kf_valid.any())
    make_chunk_fn(cfg, seq.K, "cpu")


def test_unknown_gauge_raises(seq):
    with pytest.raises(ValueError, match="ba.gauge"):
        VisualOdometry(small(ba={**BA, "gauge": "middle"}), seq.K, device="cpu")

"""The port's pipeline in the SIFT modes (sift-mask, sift-sift, SIFT bootstrap,
five-point solver, ``configs/reference.yaml``): one step against the JAX package from a
carried-over state, and whole runs on the CPU under the bounds of
``tests/test_pipeline.py``.

Stated tolerances for the step: R, t <= 1e-3; ``prev_desc`` <= 1e-3 (L2 per row) on
>= 98% of rows; the new candidate sets agree on >= 95% (points within 1e-2 px).
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
from lcvo_tpu_torch.core.state import make_vo_state, state_from_numpy
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.metrics import ate_rmse
from lcvo_tpu_torch.ops.ransac import sample_minimal_sets as port_sample
from lcvo_tpu_torch.pipeline import VisualOdometry, make_process_frame, uniforms_fn
from test_torch_pipeline import chunked_keys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_YAML = os.path.join(ROOT, "configs", "reference.yaml")

# the small configuration of tests/test_pipeline.py
SMALL = {
    "image_width": 320, "image_height": 128,
    "state": {"max_tracks": 512, "max_candidates": 768, "max_new_per_frame": 128},
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


def small(**over):
    return load_config(overrides={**SMALL, **over})


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=60, width=320, height=128, speed=0.3)


@pytest.fixture(scope="module")
def frames(seq):
    return np.stack([seq.frame(i) for i in range(40)])


def _ate(vo, seq):
    gap = vo.cfg.bootstrap.frame_gap
    est = np.asarray(vo.trajectory)
    assert np.all(np.isfinite(est))
    return ate_rmse(est, seq.gt_positions()[gap: gap + len(est)])


# ---------------------------------------------------------------------------
# One step against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sift-sift", "sift-mask"])
def test_process_frame_step_parity_sift_modes(seq, frames, mode):
    """JAX bootstrap (which seeds prev_desc in sift-sift mode), the state carried across
    with state_from_numpy, then one process_frame on both sides on the same frame with
    the JAX package's PnP samples."""
    # few bootstrap corners and many keypoints, so that one step admits a candidate
    # set worth comparing (most keypoints lie near a track or match the previous frame)
    over = {**SMALL, "find_new_candidates_method": mode, "descriptor": {"max_keypoints": 384},
            "detector": {"max_corners": 100}}
    tcfg, jcfg = load_config(overrides=over), jload_config(overrides=over)
    gap = jcfg.bootstrap.frame_gap
    jvo = JVisualOdometry(jcfg, seq.K)
    jvo.bootstrap([frames[i] for i in range(gap + 1)])
    tree = jax.tree_util.tree_map(np.asarray, jvo.state)
    tstate = state_from_numpy(tree, device="cpu")
    if mode == "sift-sift":
        assert tstate.prev_desc.shape == (384, 128) and tstate.prev_desc_valid.dtype == torch.bool
        np.testing.assert_array_equal(tstate.prev_desc.numpy(), np.asarray(jvo.state.prev_desc))
        assert int(tstate.prev_desc_valid.sum()) > 50
    else:
        assert tstate.prev_desc is None and tstate.prev_desc_valid is None

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

    img = frames[gap + 1]
    jstate, jres = jvo._process(jvo.state, jnp.asarray(img), key)
    fn = make_process_frame(tcfg, seq.K, "cpu")
    tstate2, tres = fn(tstate, torch.from_numpy(img.copy()), None, pnp_sampler=jax_samples)

    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-3)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-3)
    assert bool(tres.pose_ok) and bool(jres.pose_ok)
    assert int(tres.n_candidates) == pytest.approx(int(jres.n_candidates), rel=0.05)

    # the new candidate set: valid candidates of either side with a partner on the other
    jc = np.asarray(jstate.cands.C)[np.asarray(jstate.cands.valid)]
    tc = tstate2.cands.C.numpy()[tstate2.cands.valid.numpy()]
    assert len(jc) >= 10
    d = np.linalg.norm(jc[:, None, :] - tc[None, :, :], axis=-1)
    assert np.mean(d.min(1) <= 1e-2) >= 0.95 and np.mean(d.min(0) <= 1e-2) >= 0.95

    if mode == "sift-sift":
        jd, td = np.asarray(jstate.prev_desc), tstate2.prev_desc.numpy()
        assert np.mean(np.linalg.norm(jd - td, axis=1) <= 1e-3) >= 0.98
        assert np.mean(np.asarray(jstate.prev_desc_valid) == tstate2.prev_desc_valid.numpy()) >= 0.98
    else:
        assert tstate2.prev_desc is None


def test_make_vo_state_allocates_descriptor_table_only_for_sift_sift():
    cfg = small(find_new_candidates_method="sift-sift", descriptor={"max_keypoints": 96})
    s = make_vo_state(cfg, (128, 320), device="cpu")
    assert s.prev_desc.shape == (96, 128) and s.prev_desc.dtype == torch.float32
    assert s.prev_desc_valid.shape == (96,) and not bool(s.prev_desc_valid.any())
    for mode in ("sift-mask", "shi-mask"):
        s = make_vo_state(small(find_new_candidates_method=mode), (128, 320), device="cpu")
        assert s.prev_desc is None and s.prev_desc_valid is None


# ---------------------------------------------------------------------------
# Whole runs on the CPU (the bounds of tests/test_pipeline.py)
# ---------------------------------------------------------------------------


def test_reference_preset_end_to_end(seq):
    """configs/reference.yaml (five-point essential RANSAC, SIFT descriptor-matching
    init, 21x21/10 KLT, sift-sift candidates) runs end to end within the ATE bound."""
    cfg = load_config(REFERENCE_YAML, overrides={
        "image_width": 320, "image_height": 128, "descriptor": {"max_keypoints": 384}})
    assert (cfg.find_new_candidates_method, cfg.bootstrap.init_method, cfg.ransac.e_solver,
            cfg.klt.window, cfg.ba.enabled) == ("sift-sift", "sift", "five_point", 21, False)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    n = 30
    vo.run(seq.frames(), n_frames=n)
    assert len(vo.trajectory) == n - cfg.bootstrap.frame_gap
    err = _ate(vo, seq)
    assert err < 0.5, f"reference-preset ATE {err:.3f} m"
    assert vo.state.prev_desc.shape == (384, 128)


@pytest.mark.parametrize("mode", ["sift-mask", "sift-sift"])
def test_full_run_sift_candidate_modes(seq, mode):
    cfg = small(find_new_candidates_method=mode, descriptor={"max_keypoints": 256})
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.run(seq.frames(), n_frames=40)
    assert len(vo.trajectory) == 40 - cfg.bootstrap.frame_gap
    assert _ate(vo, seq) < 0.6
    assert (vo.state.prev_desc is not None) == (mode == "sift-sift")
    assert int(vo.state.cands.count()) > 0


@pytest.mark.parametrize("solver", ["eight_point", "five_point"])
def test_sift_bootstrap(seq, frames, solver):
    """Descriptor-matching two-view init: enough inliers, all landmarks in front of the
    bootstrap camera; in sift-sift mode the descriptor table is seeded with the last
    bootstrap frame's."""
    cfg = small(bootstrap={"frame_gap": 4, "init_method": "sift"},
                descriptor={"max_keypoints": 384},
                ransac={"e_hypotheses": 256, "pnp_hypotheses": 256, "e_solver": solver},
                find_new_candidates_method="sift-sift")
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    n_inl = vo.bootstrap([frames[i] for i in range(cfg.bootstrap.frame_gap + 1)])
    assert n_inl > 20
    assert int(vo.state.tracks.count()) > 20
    X = vo.state.tracks.X.numpy()[vo.state.tracks.valid.numpy()]
    assert np.all(X[:, 2] > 0)
    assert int(vo.state.prev_desc_valid.sum()) > 50
    norms = torch.linalg.norm(vo.state.prev_desc[vo.state.prev_desc_valid], dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms), atol=1e-4, rtol=0)


def test_run_and_run_chunked_agree_in_sift_sift_mode(seq, frames):
    """The per-frame loop fed the chunked loop's keys (the JAX package's loops split the
    chain otherwise) gives the chunked loop's trajectory."""
    cfg = small(find_new_candidates_method="sift-sift", descriptor={"max_keypoints": 192})
    a = VisualOdometry(cfg, seq.K, device="cpu")
    keys = iter(chunked_keys(cfg.seed, 17, cfg.bootstrap.frame_gap, 5))
    a._next_key = lambda: next(keys)
    a.run(iter(frames[:17]), n_frames=17)
    b = VisualOdometry(cfg, seq.K, device="cpu")
    rows = []
    b.run_chunked(frames[:17], chunk=5, on_chunk=lambda s, R, t, ok, n: rows.append(len(ok)))
    assert rows == [1, 5, 5, 1, 1]
    np.testing.assert_allclose(np.asarray(a.trajectory), np.asarray(b.trajectory), atol=1e-5)
    assert a.pose_ok_flags == b.pose_ok_flags and all(b.pose_ok_flags)
    torch.testing.assert_close(a.state.prev_desc, b.state.prev_desc, atol=1e-5, rtol=0)


@pytest.mark.parametrize("over", [
    {"find_new_candidates_method": "sift-sift"},
    {"find_new_candidates_method": "sift-mask"},
    {"bootstrap": {"init_method": "sift"}},
    {"ransac": {"e_solver": "five_point"}},
], ids=["sift-sift", "sift-mask", "sift-bootstrap", "five_point"])
def test_sift_and_five_point_settings_are_supported(seq, over):
    VisualOdometry(load_config(overrides=over), seq.K, device="cpu")


def test_reference_yaml_is_supported_at_full_width(seq):
    """The file as it is (1024 keypoints, window 21) constructs on the CPU."""
    vo = VisualOdometry(load_config(REFERENCE_YAML), seq.K, device="cpu")
    assert vo.cfg.descriptor.max_keypoints == 1024


def test_unknown_candidate_mode_raises(seq):
    with pytest.raises(ValueError, match="find_new_candidates_method"):
        VisualOdometry(load_config(overrides={"find_new_candidates_method": "orb-mask"}),
                       seq.K, device="cpu")

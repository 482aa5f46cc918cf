"""The port's checkpoint/resume: the file format against the JAX package's (same keys,
dtypes and shapes; a file of either package restores the state and the window in the
other, leaf for leaf), and the port's counterparts of ``tests/test_checkpoint.py``: a
run saved mid-sequence and resumed equals the uninterrupted run exactly, per frame and
chunked, with BA on (one generator on one device: no tolerance is needed).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.config import load_config as jload_config
from lcvo_tpu.core import state as jst
from lcvo_tpu.solve.ba import window as jwin
from lcvo_tpu.utils import checkpoint as jckpt
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.core import state as tst
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.pipeline import VisualOdometry
from lcvo_tpu_torch.solve.ba import window as twin
from lcvo_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = {
    "state": {"max_tracks": 256, "max_candidates": 384, "max_new_per_frame": 64},
    "klt": {"window": 15, "iters": 6},
    "ransac": {"e_hypotheses": 128, "pnp_hypotheses": 128},
    "bootstrap": {"frame_gap": 4},
    "image_width": 320, "image_height": 128,
}
BA = {"enabled": True, "window": 4, "keyframe_every": 3, "gn_iters": 3}
RNG_KEYS = {"rng_key", "torch_rng_state", "torch_rng_device"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(**over):
    return load_config(overrides={**SMALL, **over})


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=30, width=320, height=128, speed=0.3)


@pytest.fixture(scope="module")
def frames(seq):
    return np.stack([seq.frame(i) for i in range(30)])


def _random_like(tree, rng):
    """The JAX tree with every leaf replaced by random values of its dtype and shape."""
    def fill(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return jnp.asarray(rng.random(a.shape) > 0.5)
        if np.issubdtype(a.dtype, np.integer):
            return jnp.asarray(rng.integers(0, 9, a.shape).astype(a.dtype))
        return jnp.asarray(rng.normal(size=a.shape).astype(a.dtype))
    return jax.tree_util.tree_map(fill, tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(mode, seed=0):
    """A random JAX (state, window) of the small size and the port's copy of them."""
    over = {**SMALL, "find_new_candidates_method": mode, "ba": BA,
            "descriptor": {"max_keypoints": 96}}
    jcfg, tcfg = jload_config(overrides=over), load_config(overrides=over)
    rng = np.random.default_rng(seed)
    jstate = _random_like(jst.make_vo_state(jcfg, (128, 320)), rng)
    jw = _random_like(jwin.make_window(jcfg.ba.window, jcfg.state.max_tracks), rng)
    tstate = tst.state_from_numpy(_np_tree(jstate), device="cpu")
    tw = tst.window_from_numpy(_np_tree(jw), device="cpu")
    return (jcfg, jstate, jw), (tcfg, tstate, tw)


HOST = dict(trajectory=[np.arange(3.0) + i for i in range(7)], frame_idx=12,
            poses=[np.eye(4) * (i + 1) for i in range(7)],
            pose_ok_flags=[True, False, True, True, True, False, True],
            extras={"n_rebootstraps": 2})


def _leaves(tree):
    return [leaf for _, leaf in tckpt._walk(tree)]


def _assert_trees_equal(ttree, jtree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = _leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("mode", ["sift-sift", "shi-mask"])
def test_checkpoint_keys_dtypes_shapes_match_jax(tmp_path, mode):
    """Every key, dtype, shape and value the port writes equals what the JAX package
    writes for the carried-over state and window; only the rng entries differ."""
    (jcfg, jstate, jw), (tcfg, tstate, tw) = _carried(mode)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(pj, jstate, window=jw, rng_key=jax.random.PRNGKey(3), **HOST)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    tckpt.save_checkpoint(pt, tstate, window=tw, generator=gen, **HOST)
    dj, dt = np.load(pj), np.load(pt)
    assert set(dj.files) - RNG_KEYS == set(dt.files) - RNG_KEYS
    assert set(dj.files) & RNG_KEYS == {"rng_key"}
    assert set(dt.files) & RNG_KEYS == {"torch_rng_state", "torch_rng_device"}
    for k in set(dt.files) - RNG_KEYS:
        assert dj[k].dtype == dt[k].dtype and dj[k].shape == dt[k].shape, k
        np.testing.assert_array_equal(dj[k], dt[k], err_msg=k)
    # the keys the format is known by
    for k in ("state:.tracks/.P", "state:.tracks/.ang", "state:.cands/.age", "state:.R",
              "state:.frame_idx", "state:.prev_pyramid/[0]", "state:.prev_pyramid/[2]",
              "state:.health", "state:.prev_R", "window:.obs_gen", "window:.head",
              "trajectory", "poses", "pose_ok_flags", "frame_idx_host",
              "extra:n_rebootstraps"):
        assert k in dt.files, k
    assert ("state:.prev_desc" in dt.files) == (mode == "sift-sift")
    assert ("state:.prev_desc_valid" in dt.files) == (mode == "sift-sift")
    assert dt["torch_rng_state"].dtype == np.uint8 and str(dt["torch_rng_device"]) == "cpu"
    assert dt["window:.head"].dtype == np.int32 and dt["state:.tracks/.gen"].dtype == np.int32


@pytest.mark.parametrize("mode", ["sift-sift", "shi-mask"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, mode):
    """A file written by the JAX package restores state and window in the port equal to
    ``state_from_numpy`` / ``window_from_numpy`` of the same trees; it has no generator
    state."""
    (jcfg, jstate, jw), (tcfg, tstate, tw) = _carried(mode, seed=1)
    p = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(p, jstate, window=jw, rng_key=jax.random.PRNGKey(3), **HOST)
    state, window, traj, fidx, rng, poses, flags, extras = tckpt.load_checkpoint(
        p, tst.make_vo_state(tcfg, (128, 320), "cpu"),
        twin.make_window(tcfg.ba.window, tcfg.state.max_tracks, "cpu"))
    for a, b in zip(_leaves(state) + _leaves(window), _leaves(tstate) + _leaves(tw)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (state.prev_desc is None) == (mode != "sift-sift")
    assert isinstance(state.prev_pyramid, tuple) and len(state.prev_pyramid) == 3
    assert rng is None and fidx == 12 and len(traj) == 7 and len(poses) == 7
    assert flags == HOST["pose_ok_flags"] and int(extras["n_rebootstraps"]) == 2


@pytest.mark.parametrize("mode", ["sift-sift", "shi-mask"])
def test_port_checkpoint_loads_into_jax(tmp_path, mode):
    """A file written by the port loads through the JAX package's ``load_checkpoint``
    with a JAX template, leaf for leaf."""
    (jcfg, jstate, jw), (tcfg, tstate, tw) = _carried(mode, seed=2)
    p = str(tmp_path / "t.npz")
    gen = torch.Generator(device="cpu")
    tckpt.save_checkpoint(p, tstate, window=tw, generator=gen, **HOST)
    state, window, traj, fidx, key, poses, flags, extras = jckpt.load_checkpoint(
        p, jst.make_vo_state(jcfg, (128, 320)),
        jwin.make_window(jcfg.ba.window, jcfg.state.max_tracks))
    _assert_trees_equal(tstate, state)
    _assert_trees_equal(tw, window)
    for a, b in zip(jax.tree_util.tree_leaves(state) + jax.tree_util.tree_leaves(window),
                    jax.tree_util.tree_leaves(jstate) + jax.tree_util.tree_leaves(jw)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert key is None and fidx == 12 and len(traj) == 7
    assert flags == HOST["pose_ok_flags"] and int(extras["n_rebootstraps"]) == 2


def test_jax_checkpoint_resumes_in_the_port_with_the_seeded_generator(tmp_path, seq):
    """``resume`` of a JAX-written file: state, window, host lists and the mirror of
    frame_idx come back; the PRNG key is ignored and the generator stays as seeded."""
    (jcfg, jstate, jw), (tcfg, tstate, tw) = _carried("sift-sift", seed=3)
    jstate = jstate._replace(frame_idx=jnp.asarray(7, jnp.int32))
    p = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(p, jstate, window=jw, rng_key=jax.random.PRNGKey(3), **HOST)
    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    fresh = vo._gen.get_state().clone()
    assert vo.resume(p) == 12
    assert torch.equal(vo._gen.get_state(), fresh)
    assert vo._frame_idx == 7 and vo.n_rebootstraps == 2
    assert len(vo.trajectory) == len(vo.poses) == len(vo.pose_ok_flags) == 7
    _assert_trees_equal(vo.state, jstate)
    _assert_trees_equal(vo.window, jw)


def test_state_roundtrip(tmp_path, seq, frames):
    cfg = small()
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.bootstrap([frames[i] for i in range(5)])
    for i in range(5, 12):
        vo.record(vo.step(frames[i]))
    p = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(p, vo.state, trajectory=vo.trajectory, frame_idx=12)
    template = tst.make_vo_state(cfg, (128, 320), "cpu")
    state2, window2, traj2, fidx, rng, poses, flags, extras = tckpt.load_checkpoint(p, template)
    assert fidx == 12 and window2 is None and rng is None and poses is None and flags is None
    assert len(traj2) == len(vo.trajectory) and extras == {}
    for a, b in zip(_leaves(vo.state), _leaves(state2)):   # bitwise, every leaf
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the restored state continues as the live one does
    vo2 = VisualOdometry(cfg, seq.K, device="cpu")
    vo2.state = state2
    vo2._gen.set_state(vo._gen.get_state())
    r_a, r_b = vo.step(frames[12]), vo2.step(frames[12])
    assert torch.equal(r_a.t, r_b.t) and torch.equal(r_a.R, r_b.R)


@pytest.mark.parametrize("chunked", [False, True], ids=["per_frame", "chunked"])
def test_host_loop_checkpoint_resume(tmp_path, seq, frames, chunked):
    """A run interrupted mid-sequence and resumed in a fresh VisualOdometry reproduces
    the uninterrupted trajectory exactly, with BA on: the window, the generator and the
    mirror of frame_idx (so the BA cadence) all come back."""
    cfg = small(ba=BA)
    p = str(tmp_path / "ck.npz")
    vo_a = VisualOdometry(cfg, seq.K, device="cpu")
    vo_b = VisualOdometry(cfg, seq.K, device="cpu")
    vo_c = VisualOdometry(cfg, seq.K, device="cpu")
    if chunked:
        traj_a = vo_a.run_chunked(frames, chunk=4)
        # stops after frame 20: bootstrap 5, four chunks of 4; saves at 13 and at 21
        vo_b.run_chunked(frames[:21], chunk=4, checkpoint_every=6, checkpoint_path=p)
        start = vo_c.resume(p)
        assert start == 21
        vo_c.run_chunked_continue(iter(frames[start:]), start, chunk=4, n_frames=30)
    else:
        traj_a = vo_a.run(iter(frames), 30)
        vo_b.run(iter(frames[:18]), 18, checkpoint_every=6, checkpoint_path=p)
        start = vo_c.resume(p)
        assert start == 18
        vo_c.run_continue(iter(frames[start:]), 30, start)
    assert vo_c._frame_idx == int(vo_c.state.frame_idx) == vo_a._frame_idx
    assert len(vo_c.trajectory) == len(traj_a) == 26
    np.testing.assert_array_equal(np.asarray(vo_c.trajectory), np.asarray(traj_a))
    np.testing.assert_array_equal(np.asarray(vo_c.poses), np.asarray(vo_a.poses))
    assert vo_c.pose_ok_flags == vo_a.pose_ok_flags
    for a, b in zip(_leaves(vo_c.state) + _leaves(vo_c.window),
                    _leaves(vo_a.state) + _leaves(vo_a.window)):
        assert torch.equal(a, b)
    assert not os.path.exists(p + ".tmp")


@pytest.mark.parametrize("name", ["throughput.yaml", "turn_robust.yaml"])
def test_ba_config_files_run_save_and_resume(tmp_path, seq, frames, name):
    """Both shipped BA configurations (at the small image size, 128 keypoints) go
    through run, run_chunked, save, resume, run_continue and run_chunked_continue, and
    the resumed runs equal the uninterrupted ones."""
    cfg = load_config(os.path.join(ROOT, "configs", name), overrides={
        **SMALL, "descriptor": {"max_keypoints": 128},
        "ba": {"window": 3, "keyframe_every": 2, "gn_iters": 2}})
    assert cfg.ba.enabled and cfg.find_new_candidates_method == "sift-sift"
    p = str(tmp_path / "ck.npz")
    full = VisualOdometry(cfg, seq.K, device="cpu")
    full.run_chunked(frames[:17], chunk=4)
    part = VisualOdometry(cfg, seq.K, device="cpu")
    part.run_chunked(frames[:13], chunk=4, checkpoint_every=4, checkpoint_path=p)
    rest = VisualOdometry(cfg, seq.K, device="cpu")
    assert rest.resume(p) == 13
    rest.run_chunked_continue(iter(frames[13:17]), 13, chunk=4, n_frames=17)
    np.testing.assert_array_equal(np.asarray(rest.trajectory), np.asarray(full.trajectory))
    assert rest.state.prev_desc is not None and bool(rest.window.kf_valid.all())

    per = VisualOdometry(cfg, seq.K, device="cpu")
    per.run(iter(frames[:11]), 11)
    per.save(p, 11)
    per.run_continue(iter(frames[11:14]), 14, 11)
    again = VisualOdometry(cfg, seq.K, device="cpu")
    assert again.resume(p) == 11
    again.run_continue(iter(frames[11:14]), 14, 11)
    np.testing.assert_array_equal(np.asarray(again.trajectory), np.asarray(per.trajectory))
    assert len(per.trajectory) == 10 and np.all(np.isfinite(np.asarray(per.trajectory)))


def test_atomic_write_replaces_the_old_file_and_leaves_no_tmp(tmp_path):
    (_, _, _), (tcfg, tstate, tw) = _carried("shi-mask")
    p = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(p, tstate, frame_idx=1)
    tckpt.save_checkpoint(p, tstate, window=tw, frame_idx=2)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    d = np.load(p)
    assert int(d["frame_idx_host"]) == 2 and "window:.head" in d.files
    assert "trajectory" not in d.files and "torch_rng_state" not in d.files


def test_shape_or_dtype_mismatch_raises(tmp_path):
    (_, _, _), (tcfg, tstate, tw) = _carried("shi-mask")
    p = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(p, tstate, window=tw, frame_idx=1)
    other = load_config(overrides={**SMALL, "state": {"max_tracks": 128, "max_candidates": 384}})
    with pytest.raises(ValueError, match=r"state:\.tracks/\.P: shape \(256, 2\)"):
        tckpt.load_checkpoint(p, tst.make_vo_state(other, (128, 320), "cpu"))
    with pytest.raises(ValueError, match=r"window:\.R: shape"):
        tckpt.load_checkpoint(p, tstate, twin.make_window(BA["window"] + 1, 256, "cpu"))
    wrong = tstate._replace(health=tstate.health.to(torch.int64))
    with pytest.raises(ValueError, match=r"state:\.health: dtype int32"):
        tckpt.load_checkpoint(p, wrong)
    with pytest.raises(KeyError):       # a template with a leaf the file lacks
        tckpt.load_checkpoint(p, tstate._replace(prev_desc=torch.zeros((4, 128))))


def test_bfloat16_pyramid_roundtrips_by_bit_pattern(tmp_path):
    cfg = small(runtime={"dtype": "bfloat16"})
    state = tst.make_vo_state(cfg, (128, 320), "cpu")
    g = torch.Generator().manual_seed(0)
    pyr = tuple(torch.randn(p.shape, generator=g).to(torch.bfloat16) for p in state.prev_pyramid)
    state = state._replace(prev_pyramid=pyr)
    p = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(p, state)
    assert np.load(p)["state:.prev_pyramid/[1]"].dtype == np.uint16
    back = tckpt.load_checkpoint(p, tst.make_vo_state(cfg, (128, 320), "cpu"))[0]
    for a, b in zip(back.prev_pyramid, pyr):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_resume_refuses_a_generator_of_another_device_type(tmp_path, seq, frames):
    """The state of a CPU generator does not continue a CUDA generator's stream, and
    the other way round: resume raises and says so."""
    cfg = small(ba=BA)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.bootstrap(list(frames[:5]))
    p, q = str(tmp_path / "ck.npz"), str(tmp_path / "cuda.npz")
    vo.save(p, 5)
    d = dict(np.load(p))
    d["torch_rng_device"] = np.asarray("cuda")
    np.savez(q, **d)
    fresh = VisualOdometry(cfg, seq.K, device="cpu")
    with pytest.raises(ValueError, match="'cuda' generator"):
        fresh.resume(q)
    assert fresh.resume(p) == 5
    assert torch.equal(fresh._gen.get_state(), vo._gen.get_state())


def test_resume_needs_a_frame_counter_and_tolerates_missing_poses(tmp_path, seq, frames):
    cfg = small()
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    vo.bootstrap(list(frames[:5]))
    p = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(p, vo.state, trajectory=[np.ones(3), np.zeros(3)])
    with pytest.raises(ValueError, match="no frame counter"):
        VisualOdometry(cfg, seq.K, device="cpu").resume(p)
    tckpt.save_checkpoint(p, vo.state, trajectory=[np.ones(3), np.zeros(3)], frame_idx=6)
    vo2 = VisualOdometry(cfg, seq.K, device="cpu")
    assert vo2.resume(p) == 6
    assert vo2.pose_ok_flags == [True, True] and vo2.window is None
    np.testing.assert_array_equal(vo2.poses[0][:3, 3], np.ones(3))
    np.testing.assert_array_equal(vo2.poses[0][:3, :3], np.eye(3))

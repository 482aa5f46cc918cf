"""The port's pipeline: step-level parity with the JAX package, the host loop's
paths on the CPU, the device rule, and the package's import hygiene."""

import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.config import load_config as jload_config
from lcvo_tpu.data.synthetic import SyntheticSequence as JSyntheticSequence
from lcvo_tpu.ops import ransac as jransac
from lcvo_tpu.pipeline import VisualOdometry as JVisualOdometry
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.core.state import make_vo_state, state_from_numpy
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.metrics import ate_rmse
from lcvo_tpu_torch.pipeline import (VisualOdometry, make_bootstrap_fns, make_chunk_fn,
                                     make_process_frame)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = {
    "image_width": 320, "image_height": 128,
    "state": {"max_tracks": 256, "max_candidates": 256, "max_new_per_frame": 96},
    "klt": {"window": 15, "iters": 8, "levels": 3},
    "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
    "bootstrap": {"frame_gap": 4},
}


def small(**over):
    ov = {**SMALL, **over}
    return load_config(overrides=ov), jload_config(overrides=ov)


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
    return SyntheticSequence(n_frames=40, width=320, height=128, speed=0.3)


@pytest.fixture(scope="module")
def frames(seq):
    return np.stack([seq.frame(i) for i in range(40)])


def test_synthetic_frames_match_jax_package(frames):
    """The port's copy of the renderer gives the JAX package's frames exactly."""
    js = JSyntheticSequence(n_frames=40, width=320, height=128, speed=0.3)
    for i in (0, 17, 39):
        np.testing.assert_array_equal(frames[i], js.frame(i))


def test_process_frame_step_parity(seq, frames):
    """JAX bootstrap, the state carried across with state_from_numpy, then one
    process_frame on both sides on the same frame with the JAX package's PnP samples
    (from jax.random.split of the step key): R and t <= 1e-3, n_tracked and
    n_inliers within 1%, and the track tables' valid masks equal except on <= 1% of
    slots."""
    tcfg, jcfg = small()
    gap = jcfg.bootstrap.frame_gap
    jvo = JVisualOdometry(jcfg, seq.K)
    jvo.bootstrap([frames[i] for i in range(gap + 1)])
    tree = jax.tree_util.tree_map(np.asarray, jvo.state)
    tstate = state_from_numpy(tree, device="cpu")

    key = jvo._next_key()
    k_pnp, _ = jax.random.split(key)
    n_hyp = jcfg.ransac.pnp_hypotheses
    used = {}

    def jax_samples(valid):
        used["valid"] = valid.numpy().copy()
        idx = jransac.sample_minimal_sets(k_pnp, valid.shape[0], jnp.asarray(used["valid"]),
                                          n_hyp, 3)
        return torch.from_numpy(np.array(idx)).long()

    img = frames[gap + 1]
    jstate, jres = jvo._process(jvo.state, jnp.asarray(img), key)
    fn = make_process_frame(tcfg, seq.K, "cpu")
    tstate2, tres = fn(tstate, torch.from_numpy(img.copy()), None, pnp_sampler=jax_samples)

    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-3)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-3)
    assert bool(tres.pose_ok) and bool(jres.pose_ok)
    for f in ("n_tracked", "n_inliers"):
        a, b = int(getattr(tres, f)), int(getattr(jres, f))
        assert abs(a - b) <= 0.01 * b, (f, a, b)
    jv = np.asarray(jstate.tracks.valid)
    assert np.mean(tstate2.tracks.valid.numpy() != jv) <= 0.01
    assert int(tstate2.frame_idx) == int(jstate.frame_idx)
    assert int(tres.n_candidates) == pytest.approx(int(jres.n_candidates), rel=0.02)


def test_bootstrap_pieces_parity(seq, frames):
    """Bootstrap pieces on the same inputs: detection gives the same point set, the
    KLT chain the same tracks (<= 1e-3 px where both keep them), and the two-view
    init with the JAX package's essential samples the same pose (<= 1e-3)."""
    from lcvo_tpu.ops.pyramid import build_pyramid as jbuild
    from lcvo_tpu.pipeline import make_bootstrap_fns as jmake_bootstrap_fns
    from lcvo_tpu_torch.ops.pyramid import build_pyramid as tbuild

    tcfg, jcfg = small()
    gap = jcfg.bootstrap.frame_gap
    jdet, jtrack, jtwo = jmake_bootstrap_fns(jcfg, seq.K)
    tdet, ttrack, ttwo = make_bootstrap_fns(tcfg, seq.K, "cpu")
    imgs = [frames[i] for i in range(gap + 1)]
    jp0, jok = jdet(jnp.asarray(imgs[0]))
    tp0, tok = tdet(torch.from_numpy(imgs[0].copy()))
    assert ({tuple(p) for p in tp0.numpy()[tok.numpy()].tolist()}
            == {tuple(p) for p in np.asarray(jp0)[np.asarray(jok)].tolist()})

    jpts, jv = jp0, jok
    tpts, tv = torch.from_numpy(np.array(jp0)), torch.from_numpy(np.array(jok))
    for a, b in zip(imgs[:-1], imgs[1:]):
        jpts, jv = jtrack(jbuild(jnp.asarray(a), 3), jbuild(jnp.asarray(b), 3), jpts, jv)
        tpts, tv = ttrack(tbuild(torch.from_numpy(a.copy()), 3),
                          tbuild(torch.from_numpy(b.copy()), 3), tpts, tv)
    jv = np.asarray(jv)
    assert np.mean(tv.numpy() == jv) >= 0.99
    both = jv & tv.numpy()
    assert np.abs(tpts.numpy()[both] - np.asarray(jpts)[both]).max() <= 1e-3

    key = jax.random.PRNGKey(3)
    jR, jt, jX, jgood, jn = jtwo(key, jp0, jpts, jnp.asarray(jv))
    idx = jransac.sample_minimal_sets(key, jv.shape[0], jnp.asarray(jv),
                                      jcfg.ransac.e_hypotheses, 8)
    tR, tt, tX, tgood, tn = ttwo(None, torch.from_numpy(np.array(jp0)),
                                 torch.from_numpy(np.array(jpts)), torch.from_numpy(jv),
                                 e_idx=torch.from_numpy(np.array(idx)).long())
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    assert abs(int(tn) - int(jn)) <= 0.01 * int(jn)
    assert np.mean(tgood.numpy() != np.asarray(jgood)) <= 0.01


def _check_run(vo, seq, n, bound=0.5):
    gap = vo.cfg.bootstrap.frame_gap
    est = np.asarray(vo.trajectory)
    assert est.shape == (n - gap, 3) and np.all(np.isfinite(est))
    assert len(vo.poses) == len(vo.pose_ok_flags) == len(est)
    err = ate_rmse(est, seq.gt_positions()[gap: gap + len(est)])
    assert err < bound, f"ATE {err:.3f} m"
    return err


def test_run_chunked_cpu(seq, frames):
    """Bootstrap, two chunks of 6 and a tail of 2 on the CPU: ATE under the 0.5 m
    bound of tests/test_pipeline.py, every pose healthy, one row per chunk emit."""
    tcfg, _ = small()
    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    rows = []
    vo.run_chunked(frames[:19], chunk=6, on_chunk=lambda s, R, t, ok, ninl: rows.append(
        (s, len(ok), int(np.min(ninl)))))
    _check_run(vo, seq, 19)
    assert all(vo.pose_ok_flags) and vo.n_rebootstraps == 0
    assert [r[:2] for r in rows] == [(0, 1), (1, 6), (7, 6), (13, 1), (14, 1)]
    assert min(r[2] for r in rows) > 30


def test_run_per_frame_cpu(seq, frames):
    """The per-frame loop (run → run_continue) on the same frames."""
    tcfg, _ = small()
    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    seen = []
    vo.run(iter(frames[:14]), n_frames=14, on_frame=lambda i, res: seen.append(i))
    _check_run(vo, seq, 14)
    assert seen == list(range(10))
    assert all(r.R.shape == (3, 3) for r in vo.results)


@pytest.mark.parametrize("ba", [False, True], ids=["no_ba", "ba"])
def test_make_chunk_step_equals_run_chunked(seq, frames, ba):
    """``make_chunk_step`` is the host loop's chunk step: stepping it over two chunks of 6
    from ``chunk_carry()``, with the host mirror as ``frame_idx`` and the carry handed
    back by ``set_chunk_carry``, gives ``run_chunked``'s poses exactly (with BA: its
    keyframes and refines too)."""
    over = {"ba": {"enabled": True, "window": 4, "keyframe_every": 3, "gn_iters": 3}} if ba else {}
    tcfg, _ = small(**over)
    gap, chunk = tcfg.bootstrap.frame_gap, 6
    n = gap + 1 + 2 * chunk
    ref = VisualOdometry(tcfg, seq.K, device="cpu")
    want = []
    ref.run_chunked(frames[:n], chunk=chunk, on_chunk=lambda s, R, t, ok, ninl: want.append(
        (R, t, ok)) if len(ok) == chunk else None)

    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    vo.bootstrap(list(frames[: gap + 1]))
    step = vo.make_chunk_step(chunk)
    for c in range(2):
        batch = torch.from_numpy(frames[gap + 1 + c * chunk: gap + 1 + (c + 1) * chunk])
        carry, (Rs, ts, ok, _) = step(vo.chunk_carry(), batch, vo._gen, frame_idx=vo._frame_idx)
        vo.set_chunk_carry(carry, chunk)
        np.testing.assert_array_equal(Rs.numpy(), want[c][0])
        np.testing.assert_array_equal(ts.numpy(), want[c][1])
        np.testing.assert_array_equal(ok.numpy(), want[c][2])
    assert ref.n_rebootstraps == 0 and vo._frame_idx == ref._frame_idx == 2 * chunk
    assert (vo.n_keyframes, vo.ba_refine_stats()) == (ref.n_keyframes, ref.ba_refine_stats())
    assert vo.n_keyframes == (4 if ba else 0)


def test_run_chunked_recovers_by_rebootstrap(seq, frames):
    """An unsatisfiable min_pnp_inliers makes every step fail: the chunk ends with
    health >= 2, the loop re-bootstraps over the next rebootstrap_skip + 1 frames,
    and the trajectory stays one pose per frame from frame_gap on."""
    tcfg, _ = small(ransac={"e_hypotheses": 256, "pnp_hypotheses": 256,
                            "min_pnp_inliers": 10**6},
                    bootstrap={"frame_gap": 4, "rebootstrap_skip": 2})
    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    vo.run_chunked(frames[:18], chunk=4)
    est = np.asarray(vo.trajectory)
    assert est.shape == (14, 3) and np.all(np.isfinite(est))
    assert vo.n_rebootstraps >= 2
    assert not all(vo.pose_ok_flags)


def test_run_recovers_and_extends_weak_bootstrap(seq, frames):
    """Per-frame loop: a weak bootstrap (min_matches unreachable) extends the window
    with a warning; failing steps re-bootstrap; one pose per frame throughout."""
    tcfg, _ = small(bootstrap={"frame_gap": 4, "min_matches": 10**6, "rebootstrap_skip": 2},
                    ransac={"e_hypotheses": 256, "pnp_hypotheses": 256,
                            "min_pnp_inliers": 10**6})
    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    with pytest.warns(UserWarning, match="weak bootstrap"):
        vo.run(iter(frames[:16]), n_frames=16)
    est = np.asarray(vo.trajectory)
    assert est.shape == (12, 3) and np.all(np.isfinite(est))
    assert vo.n_rebootstraps >= 1


def test_uint8_frames_are_cast_on_device(seq, frames):
    """process_frame takes uint8 frames and casts them itself."""
    tcfg, _ = small()
    u8 = np.clip(np.rint(frames[:12]), 0, 255).astype(np.uint8)
    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    vo.run_chunked(u8, chunk=4)
    _check_run(vo, seq, 12)
    assert vo.state.prev_image.dtype == torch.float32


def test_short_stream_raises(seq, frames):
    tcfg, _ = small()
    with pytest.raises(ValueError, match="frame_gap"):
        VisualOdometry(tcfg, seq.K, device="cpu").run(iter(frames[:2]), n_frames=2)
    with pytest.raises(ValueError, match="frame_gap"):
        VisualOdometry(tcfg, seq.K, device="cpu").run_chunked(frames[:3], chunk=4)


def test_default_device_is_cuda_and_never_falls_back(seq):
    """With no device= the entry point asks for CUDA; without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check is for hosts without it")
    tcfg, _ = small()
    with pytest.raises(RuntimeError, match="CUDA"):
        VisualOdometry(tcfg, seq.K)


@pytest.mark.parametrize("build", [
    lambda cfg, K: make_process_frame(cfg, K),
    lambda cfg, K: make_bootstrap_fns(cfg, K),
    lambda cfg, K: make_chunk_fn(cfg, K),
    lambda cfg, K: make_vo_state(cfg, (cfg.image_height, cfg.image_width)),
    lambda cfg, K: state_from_numpy({}),
], ids=["make_process_frame", "make_bootstrap_fns", "make_chunk_fn", "make_vo_state",
        "state_from_numpy"])
def test_step_builders_default_to_cuda(seq, build):
    """The step and state builders also default to CUDA and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check is for hosts without it")
    tcfg, _ = small()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(tcfg, seq.K)


@pytest.mark.parametrize("over,item", [
    ({"ba": {"enabled": True}}, "window BA"),
])
def test_unported_settings_raise(seq, over, item):
    """No setting of the configuration is left unported: window BA, the last one that
    raised ``NotImplementedError``, now builds the host loop with its keyframe ring and
    the chunk step (tests/test_torch_pipeline_ba.py runs them)."""
    cfg = load_config(overrides=over)
    vo = VisualOdometry(cfg, seq.K, device="cpu")
    assert vo.window is not None and vo.window.R.shape == (cfg.ba.window, 3, 3)
    assert callable(make_chunk_fn(cfg, seq.K, "cpu"))
    src = open(os.path.join(ROOT, "lcvo_tpu_torch", "pipeline.py")).read()
    assert "NotImplementedError" not in src, item


def test_checkpoint_resume_not_ported(seq, frames, tmp_path):
    """Checkpoint/resume is ported (tests/test_torch_checkpoint.py): ``save`` writes a
    file that ``resume`` in a fresh host loop reads back."""
    tcfg, _ = small()
    vo = VisualOdometry(tcfg, seq.K, device="cpu")
    vo.bootstrap(list(frames[:5]))
    path = str(tmp_path / "x.npz")
    vo.save(path, 5)
    vo2 = VisualOdometry(tcfg, seq.K, device="cpu")
    assert vo2.resume(path) == 5
    assert torch.equal(vo2.state.tracks.X, vo.state.tracks.X)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))))
def test_config_files_load_into_both_packages(path):
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(jload_config(path))


def test_default_config_matches_jax_package():
    assert dataclasses.asdict(load_config()) == dataclasses.asdict(jload_config())


def test_package_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this one has JAX loaded by tests/conftest.py), import
    the port and every submodule, then check sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import lcvo_tpu_torch
        for m in pkgutil.walk_packages(lcvo_tpu_torch.__path__, "lcvo_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "lcvo_tpu"))
        assert not bad, bad
        import torch
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
        print("ok", len(list(pkgutil.walk_packages(lcvo_tpu_torch.__path__))))
    """)
    env = {k: v for k, v in os.environ.items() if k != "LCVO_NO_MATMUL_PRECISION_OVERRIDE"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")

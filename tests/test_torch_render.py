"""The port's renderers (``lcvo_tpu_torch/data/render.py``) against the JAX package's
(``lcvo_tpu/data/render_jax.py``) on the CPU, on the same poses: the lattice hash bit
for bit, the frames pixel for pixel up to the stated share, and the port's counterparts
of the four tests of tests/test_render_jax.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcvo_tpu.data import render_jax as jrender
from lcvo_tpu.data import synthetic as jsyn
from lcvo_tpu_torch.data import render as trender
from lcvo_tpu_torch.data import synthetic as tsyn
from lcvo_tpu_torch.data.render import FastArenaRenderer, FastCorridorRenderer

# Both sides are f32 elementwise programs of the same formula; what may differ is how
# the two compilers round a fused expression, which moves a grey level by one where the
# value sits on an integer boundary. Measured on this fixture: every arena frame equal,
# 0.01% of the corridor's pixels off by one level.
MIN_EQUAL_SHARE = 0.999
MAX_DIFF = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(seed):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.integers(-2**31, 2**31, 500), rng.integers(-40, 40, 500),
                         [-1, 0, 1, -2**31, 2**31 - 1]]).astype(np.int32)
    yi = np.concatenate([rng.integers(-40, 40, 500), rng.integers(-2**31, 2**31, 500),
                         [-1, 0, 1, 2**31 - 1, -2**31]]).astype(np.int32)
    return xi, yi


@pytest.mark.parametrize("seed", [0, 7, 7 + 505 + 3, 2**32 - 1, 2**40 + 12345])
def test_hash2_bit_exact_against_both_numpy_fixtures_and_jax(seed):
    """Negative lattice indices wrap as a cast to uint32 does; every seed of the renderer
    (world seed + plane offset + octave) and seeds at and past 2**32."""
    xi, yi = _lattice(seed % 1000)
    got = trender._hash2(torch.from_numpy(xi), torch.from_numpy(yi), seed).numpy()
    assert got.dtype == np.float32 and got.min() >= 0.0 and got.max() < 1.0
    for fixture in (tsyn._hash2, jsyn._hash2):   # f64 in [0, 1) with 24 bits: exact in f32
        want = fixture(xi, yi, seed)
        np.testing.assert_array_equal(got.astype(np.float64), want)
    np.testing.assert_array_equal(got, np.asarray(jrender._hash2(jnp.asarray(xi), jnp.asarray(yi), seed)))


def test_value_noise_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(-300, 300, (64, 48)).astype(np.float32)
    v = rng.uniform(-300, 300, (64, 48)).astype(np.float32)
    got = trender._value_noise(torch.from_numpy(u), torch.from_numpy(v), 7, octaves=4, base_freq=1.7)
    want = np.asarray(jrender._value_noise(jnp.asarray(u), jnp.asarray(v), 7, octaves=4, base_freq=1.7))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def _compare(port, ref, idx):
    worst, equal = 0, 1.0
    for i in idx:
        a, b = port.frame(i), ref.frame(i)
        assert a.dtype == np.uint8 and a.shape == b.shape
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        worst, equal = max(worst, int(d.max())), min(equal, float((d == 0).mean()))
    assert worst <= MAX_DIFF and equal >= MIN_EQUAL_SHARE, (worst, equal)


def test_corridor_frames_match_jax():
    _compare(FastCorridorRenderer(40, 256, 96, device="cpu"),
             jrender.FastCorridorRenderer(40, 256, 96), (0, 20, 39))


@pytest.mark.parametrize("occluder", [False, True])
def test_arena_frames_match_jax(occluder):
    """Straight, mid-turn and after the turn; with and without the moving billboard."""
    traj = tsyn.trajectory_loop(60, 0.35, straight_frames=20, turn_frames=15)
    jtraj = jsyn.trajectory_loop(60, 0.35, straight_frames=20, turn_frames=15)
    np.testing.assert_array_equal(traj[0], jtraj[0])
    np.testing.assert_array_equal(traj[1], jtraj[1])
    _compare(FastArenaRenderer(traj, 256, 96, occluder=occluder, device="cpu"),
             jrender.FastArenaRenderer(jtraj, 256, 96, occluder=occluder), (0, 10, 27, 40, 59))


def test_arena_frames_match_jax_with_own_intrinsics():
    K = np.array([[621.18428, 0, 404.0076 / 4], [0, 621.18428, 309.05989 / 4], [0, 0, 1]])
    traj = tsyn.trajectory_loop(30, 0.35, straight_frames=10, turn_frames=10)
    _compare(FastArenaRenderer(traj, 200, 150, K=K, device="cpu"),
             jrender.FastArenaRenderer(traj, 200, 150, K=K), (0, 15, 29))


def test_batch_render_equals_frame_by_frame():
    traj = tsyn.trajectory_loop(24, 0.35, straight_frames=8, turn_frames=8)
    for r in (FastArenaRenderer(traj, 128, 64, occluder=True, device="cpu"),
              FastCorridorRenderer(24, 128, 64, device="cpu")):
        batch = r.frames_device(3, 19)
        assert batch.shape == (16, 64, 128) and batch.dtype == torch.uint8
        for j in (0, 7, 15):
            np.testing.assert_array_equal(batch[j].numpy(), r.frame(3 + j))


def test_renderers_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    traj = tsyn.trajectory_loop(8, 0.35)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastArenaRenderer(traj, 64, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastCorridorRenderer(8, 64, 32)


# -- counterparts of tests/test_render_jax.py ------------------------------------------

def test_render_matches_numpy_renderer():
    seq = tsyn.SyntheticSequence(n_frames=4, width=256, height=96)
    r = FastCorridorRenderer(4, 256, 96, device="cpu")
    np.testing.assert_allclose(seq.t_wc, r.t_wc)
    np.testing.assert_allclose(seq.R_wc, r.R_wc)
    a = seq.frame(2)
    b = r.frame(2).astype(np.float32)
    d = np.abs(a - b)
    # f32 interpolation + plane-boundary argmin ties: tiny everywhere but a
    # handful of edge pixels
    assert d.mean() < 2.0, d.mean()
    assert np.percentile(d, 99) < 5.0


def test_far_wall_scales_with_trajectory():
    r = FastCorridorRenderer(3000, 64, 32, speed=0.35, device="cpu")
    assert r.world.end_z > 3000 * 0.35  # camera must never pass the far wall


def test_gt_pose_rows_roundtrip():
    r = FastCorridorRenderer(10, 64, 32, device="cpu")
    rows = r.gt_pose_rows()
    assert rows.shape == (10, 12)
    P = rows.reshape(10, 3, 4)
    np.testing.assert_allclose(P[:, :, 3], r.t_wc)
    np.testing.assert_allclose(P[:, :, :3], r.R_wc)
    np.testing.assert_array_equal(rows, jrender.FastCorridorRenderer(10, 64, 32).gt_pose_rows())


def test_arena_renderer_closed_world():
    """Arena frames must be fully textured in every heading (closed room): no
    flat/void regions mid-turn, deterministic, and the occluder billboard only
    changes a localized pixel set."""
    traj = tsyn.trajectory_loop(60, speed=0.3, straight_frames=10, turn_frames=40)
    r = FastArenaRenderer(traj, 128, 64, device="cpu")
    # mid-turn frame: camera heading ~45-90 deg off axis
    f = r.frame(40)
    assert f.dtype == np.uint8 and f.shape == (64, 128)
    assert f.std() > 10.0  # textured everywhere
    # per-row variance: no large void band
    assert (f.std(axis=1) > 3.0).mean() > 0.95
    np.testing.assert_array_equal(f, r.frame(40))  # deterministic
    r_occ = FastArenaRenderer(traj, 128, 64, occluder=True, device="cpu")
    d = np.abs(r_occ.frame(40).astype(int) - f.astype(int)) > 5
    assert 20 < d.sum() < 0.25 * f.size  # present but localized

"""Multi-stream: the port's batched step and chunk step (``torch.func.vmap`` of the
single-stream functions) against the single-stream step, against the JAX package's
``make_multistream_step``, and over a mesh of 2 gloo ranks on the CPU, each rank a
process that runs its part of the streams (``tests/torch_rank_programs.py:streams``).
The counterparts of tests/test_streams.py, at its sizes (160x96, 64 tracks, 2 levels,
3 iterations).

Tolerances. A stream of the batched step is not always bit-identical to the
single-stream step: a product such as ``R @ X[..., None]`` of one (3, 3) pose against
(N, 3, 1) points takes another BLAS route than the same product batched over streams,
and the last bit of a 3-term sum can differ (measured: R 7e-8, t 6e-7 after one step).
Newly triangulated landmarks carry such a difference further (X 1.2e-3 m at 14 m after
one step). So: one step R, t <= 1e-5, every mask and count equal, the state's floats
within 1e-3 relative + 1e-4; a chunk of 3 frames with keyframe steps R, t <= 1e-3,
the keyframe step's tolerance of tests/test_torch_pipeline_ba.py (measured 2e-5, 2e-4:
each LM step carries the difference on), masks and counts equal, floats within 1e-2
relative + 1e-3; the
JAX package's batched step R, t <= 1e-3, the step-parity tolerance of
tests/test_torch_pipeline.py.
"""

import collections
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

from lcvo_tpu.config import load_config as jload_config
from lcvo_tpu.ops import ransac as jransac
from lcvo_tpu.parallel import streams as jstreams
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.parallel import streams as ps
from lcvo_tpu_torch.parallel.launch import run_ranks
from lcvo_tpu_torch.parallel.mesh import make_mesh, mesh_from_config
from lcvo_tpu_torch.pipeline import VisualOdometry, make_chunk_fn, make_process_frame

W, H = 160, 96
SMALL = {
    "image_width": W, "image_height": H,
    "state": {"max_tracks": 64, "max_candidates": 96, "max_new_per_frame": 32},
    "ransac": {"pnp_hypotheses": 64, "e_hypotheses": 64},
    "klt": {"levels": 2, "iters": 3},
}
BA = {"ba": {"enabled": True, "window": 4, "gn_iters": 2, "keyframe_every": 2},
      "triangulation": {"track_refine": True}}
N_HYP = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=32, width=W, height=H)


@pytest.fixture(scope="module")
def frames(seq):
    return np.stack([seq.frame(i) for i in range(32)]).astype(np.float32)


def _bootstrapped(cfg, seq, frames, n_streams):
    """Stream s bootstrapped by the port's single-stream bootstrap on frames s.. of the
    corridor, then run s % 2 steps, so the streams differ in content and in
    ``frame_idx``. Returns the host loops."""
    gap = cfg.bootstrap.frame_gap
    vos = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a weak-bootstrap warning changes nothing here
        for s in range(n_streams):
            vo = VisualOdometry(cfg, seq.K, device="cpu")
            vo.bootstrap(list(frames[s: s + gap + 1]))
            for k in range(s % 2):
                vo.step(frames[s + gap + 1 + k])
            vos.append(vo)
    return vos


def _next_frames(vos, frames, n):
    """(S, n, H, W): the n frames after where each stream stands."""
    gap = vos[0].cfg.bootstrap.frame_gap
    return torch.from_numpy(np.stack([
        frames[s + gap + 1 + vo._frame_idx: s + gap + 1 + vo._frame_idx + n]
        for s, vo in enumerate(vos)]))


def _samples(rng, vos, shape):
    """PnP minimal sets drawn among each stream's valid tracks: (S, *shape, 3)."""
    out = []
    for vo in vos:
        live = np.flatnonzero(vo.state.tracks.valid.numpy())
        out.append(rng.choice(live, size=shape + (3,)))
    return torch.from_numpy(np.stack(out)).long()


def _leaves(tree):
    return [x for x in tree_flatten(tree)[0] if x is not None]


def _assert_close_state(a, b, rtol, atol, what):
    """Masks, counters and indices equal; floats within ``rtol``/``atol``."""
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.shape == y.shape and x.dtype == y.dtype, what
        if x.is_floating_point():
            assert torch.allclose(x, y, rtol=rtol, atol=atol, equal_nan=True), (what, x.shape)
        else:
            assert torch.equal(x, y), (what, x.shape)


@pytest.mark.parametrize("over", [{}, BA], ids=["state", "state_and_window"])
def test_batched_carry_matches_the_jax_package(over):
    """``make_batched_carry`` gives the JAX package's batched carry: the same leaves in
    the same order, each with a leading stream dim, the same shapes, dtypes and values
    (the JAX package's ``None`` leaves are ``None`` here too)."""
    cfg = load_config(overrides={**SMALL, **over})
    jcfg = jload_config(overrides={**SMALL, **over})
    carry = ps.make_batched_carry(cfg, (H, W), 3, device="cpu")
    jcarry = jstreams.make_batched_carry(jcfg, (H, W), 3)
    jleaves = jax.tree_util.tree_leaves(jcarry)
    assert len(_leaves(carry)) == len(jleaves)
    for x, y in zip(_leaves(carry), jleaves):
        assert x.shape[0] == 3 and x.shape == y.shape
        assert str(x.dtype).split(".")[1] == str(y.dtype)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    state = carry[0] if over else carry
    assert state.prev_desc is None and ps.select_stream(state, 2).R.shape == (3, 3)


@pytest.fixture(scope="module")
def plain_streams(seq, frames):
    cfg = load_config(overrides=SMALL)
    return cfg, _bootstrapped(cfg, seq, frames, 2)


def test_batched_step_matches_single_stream(seq, frames, plain_streams):
    """Stream s of the batched step equals the single-stream step on the same state,
    image and injected samples: R, t <= 1e-5 (see the module's docstring), every count
    and mask equal; and ``agg`` holds the sums."""
    cfg, vos = plain_streams
    states = ps.stack_streams([vo.state for vo in vos])
    imgs = _next_frames(vos, frames, 1)[:, 0]
    idx = _samples(np.random.default_rng(1), vos, (N_HYP,))
    step = ps.make_multistream_step(cfg, seq.K, device="cpu")
    out, res, agg = step(states, imgs, idx)
    pf = make_process_frame(cfg, seq.K, "cpu")
    for s in range(len(vos)):
        s1, r1 = pf(vos[s].state, imgs[s], None, pnp_sampler=lambda valid: idx[s])
        assert torch.allclose(res.R[s], r1.R, rtol=0, atol=1e-5)
        assert torch.allclose(res.t[s], r1.t, rtol=0, atol=1e-5)
        for f in ("pose_ok", "n_tracked", "n_inliers", "n_candidates", "n_promoted"):
            assert torch.equal(getattr(res, f)[s], getattr(r1, f)), f
        assert bool(r1.pose_ok)
        _assert_close_state(ps.select_stream(out, s), s1, 1e-3, 1e-4, f"stream {s}")
    assert int(agg["tracked"]) == int(res.n_tracked.sum())
    assert int(agg["inliers"]) == int(res.n_inliers.sum())
    assert int(agg["promoted"]) == int(res.n_promoted.sum())
    assert int(agg["pose_ok"]) == int(res.pose_ok.sum()) == len(vos)


def _to_jax_state(tstates, jtemplate):
    """The port's batched state as the JAX package's (same NamedTuples, same leaf order;
    the port's None leaves are absent from the JAX tree)."""
    leaves = [jnp.asarray(x.numpy()) for x in _leaves(tstates)]
    jleaves, treedef = jax.tree_util.tree_flatten(jtemplate)
    assert [l.shape for l in leaves] == [l.shape for l in jleaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_batched_step_matches_jax_multistream_step(seq, frames, plain_streams):
    """Stream s of the port's batched step against the JAX package's
    ``make_multistream_step`` (no mesh) on the same batched state and images, the port
    fed the JAX samples of each stream's key: R, t <= 1e-3, pose_ok equal, inlier
    counts within 1%; fed the keys themselves, the port's step equals the injected one
    exactly."""
    cfg, vos = plain_streams
    jcfg = jload_config(overrides={**SMALL, "runtime": {"donate_state": False}})
    S = len(vos)
    states = ps.stack_streams([vo.state for vo in vos])
    imgs = _next_frames(vos, frames, 1)[:, 0]
    jstates = _to_jax_state(states, jstreams.make_batched_state(jcfg, (H, W), S))
    keys = jax.random.split(jax.random.PRNGKey(5), S)
    jstep = jstreams.make_multistream_step(jcfg, seq.K)
    _, jres, jagg = jstep(jstates, jnp.asarray(imgs.numpy()), keys)

    # the JAX samples of stream s: its key's PnP half, over the tracks the port's KLT
    # kept (the single-stream step hands them to the sampler)
    pf = make_process_frame(cfg, seq.K, "cpu")
    idx = []
    for s in range(S):
        k_pnp, _ = jax.random.split(keys[s])

        def jax_samples(valid):
            got = jransac.sample_minimal_sets(k_pnp, valid.shape[0], jnp.asarray(valid.numpy()),
                                              jcfg.ransac.pnp_hypotheses, 3)
            idx.append(torch.from_numpy(np.array(got)).long())
            return idx[-1]

        pf(vos[s].state, imgs[s], None, pnp_sampler=jax_samples)
    step = ps.make_multistream_step(cfg, seq.K, device="cpu")
    _, res, agg = step(states, imgs, torch.stack(idx))
    # the streams' keys themselves: the port draws the JAX samples, so the same step
    _, res_k, _ = step(states, imgs, np.asarray(keys))
    for f in res._fields:
        assert torch.equal(getattr(res_k, f), getattr(res, f)), f
    np.testing.assert_allclose(res.R.numpy(), np.asarray(jres.R), atol=1e-3)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), atol=1e-3)
    np.testing.assert_array_equal(res.pose_ok.numpy(), np.asarray(jres.pose_ok))
    assert bool(res.pose_ok.all())
    for a, b in zip(res.n_inliers.tolist(), np.asarray(jres.n_inliers).tolist()):
        assert abs(a - b) <= 0.01 * b, (a, b)
    assert set(agg) == set(jagg)


@pytest.fixture(scope="module")
def ba_streams(seq, frames):
    cfg = load_config(overrides={**SMALL, **BA})
    return cfg, _bootstrapped(cfg, seq, frames, 4)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory, seq, frames, ba_streams, plain_streams):
    """Two gloo ranks (``tests/torch_rank_programs.py:streams``), each given the whole
    batch of 4 streams and taking its part of 2: the BA chunk step over a mesh of the
    world (the streams at frame_idx 0, 1, 0, 1 with injected samples), and the step with
    the mesh from ``runtime.mesh_shape: [2]`` (injected samples, then the streams' keys).
    Returns the inputs and each rank's results."""
    cfg, vos = ba_streams
    chunk = 3
    fidx = [vo._frame_idx for vo in vos]
    assert fidx == [0, 1, 0, 1]
    _, pvos = plain_streams
    inputs = {
        "chunk": {"overrides": {**SMALL, **BA}, "K": seq.K, "frame_idx": fidx,
                  "carry": ps.stack_streams([vo.chunk_carry() for vo in vos]),
                  "frames": _next_frames(vos, frames, chunk),
                  "samples": _samples(np.random.default_rng(2), vos, (chunk, N_HYP))},
        "step": {"overrides": {**SMALL, "runtime": {"mesh_shape": [2], "mesh_axes": ["data"]}},
                 "K": seq.K, "states": ps.stack_streams([vo.state for vo in pvos] * 2),
                 "images": torch.cat([_next_frames(pvos, frames, 1)[:, 0]] * 2),
                 "samples": _samples(np.random.default_rng(4), pvos * 2, (N_HYP,))},
    }
    d = tmp_path_factory.mktemp("streams_ranks")
    torch.save(inputs, d / "inputs.pt")
    run_ranks("tests/torch_rank_programs.py:streams", 2, [str(d / "inputs.pt"), str(d / "out")],
              device="cpu", timeout=240)
    return inputs, [dict(np.load(d / f"out_rank{r}.npz")) for r in range(2)]


def test_batched_chunk_step_with_ba_over_a_cpu_mesh_matches_each_stream(seq, rank_results):
    """The batched chunk step with BA on (window 4, a keyframe every 2nd frame, 2 LM
    steps, anchor refits on), chunk 3, over a mesh of 2 gloo ranks on the CPU, each
    rank running its part of 2 streams; streams at frame_idx 0, 1, 0, 1 (so the keyframe
    steps fall on different frames of different streams): each stream of each rank's
    part equals its own ``chunk_fn`` with the same samples. R, t <= 1e-3, pose_ok and
    inlier counts equal, the carry's masks, counters and ring equal, its floats as the
    module's docstring says."""
    inputs, ranks = rank_results
    c = inputs["chunk"]
    cfg = load_config(overrides=c["overrides"])
    cf = make_chunk_fn(cfg, seq.K, "cpu")
    for r, got in enumerate(ranks):
        assert got["chunk/R"].shape == (2, 3, 3, 3) and got["chunk/n_inliers"].shape == (2, 3)
        carry = [torch.from_numpy(got[f"chunk/carry/{i}"])
                 for i in range(len(_leaves(c["carry"])))]
        for k in range(2):
            s = 2 * r + k
            out1, (R1, t1, ok1, ninl1) = cf(ps.select_stream(c["carry"], s), c["frames"][s],
                                            c["samples"][s], frame_idx=c["frame_idx"][s])
            assert torch.allclose(torch.from_numpy(got["chunk/R"][k]), R1, rtol=0, atol=1e-3)
            assert torch.allclose(torch.from_numpy(got["chunk/t"][k]), t1, rtol=0, atol=1e-3)
            assert torch.equal(torch.from_numpy(got["chunk/pose_ok"][k]), ok1)
            assert torch.equal(torch.from_numpy(got["chunk/n_inliers"][k]), ninl1)
            assert bool(ok1.all())
            for x, y in zip([x[k] for x in carry], _leaves(out1), strict=True):
                assert x.shape == y.shape and x.dtype == y.dtype, (r, k)
                if x.is_floating_point():
                    assert torch.allclose(x, y, rtol=1e-2, atol=1e-3, equal_nan=True), (r, k, x.shape)
                else:
                    assert torch.equal(x, y), (r, k, x.shape)
        # the ring moved on the cadence of each stream: from frame_idx 0 the chunk ends on
        # one keyframe (frame_idx 2), from 1 on two (2 and 4)
        head_at = next(i for i, x in enumerate(_leaves(c["carry"])) if x is c["carry"][1].head)
        assert carry[head_at].tolist() == [1, 2]


def test_mesh_from_config_drives_multistream_step(seq, rank_results):
    """``runtime.mesh_shape: [2]`` builds the mesh when none is passed: on each of 2
    gloo ranks the step runs that rank's part of 2 of the 4 streams and gives what the
    step without a mesh gives for them over all 4 (to the step's tolerance: a part of 2
    streams is a batch of another size); ``agg`` holds the sums over all 4 streams on
    both ranks. The keys path steps every stream of the part."""
    inputs, ranks = rank_results
    s = inputs["step"]
    _, res0, _ = ps.make_multistream_step(load_config(overrides=SMALL), seq.K, device="cpu")(
        s["states"], s["images"], s["samples"])
    for r, got in enumerate(ranks):
        for f in res0._fields:
            a, b = torch.from_numpy(got[f"step/res/{f}"]), getattr(res0, f)[2 * r:2 * r + 2]
            assert torch.allclose(a, b, rtol=0, atol=1e-5) if a.is_floating_point() else torch.equal(a, b), f
        assert got["step/agg/tracked"].shape == ()
        assert int(got["step/agg/tracked"]) == int(res0.n_tracked.sum())
        assert int(got["step/agg/inliers"]) == int(res0.n_inliers.sum())
        assert int(got["step/agg/promoted"]) == int(res0.n_promoted.sum())
        assert int(got["step/agg/pose_ok"]) == int(res0.pose_ok.sum())
        assert got["keys/R"].shape == (2, 3, 3) and np.isfinite(got["keys/t"]).all()
        np.testing.assert_array_equal(got["keys/frame_idx"], got["keys/frame_idx_in"] + 1)


def test_make_mesh_raises_without_a_group():
    """No process group in this process: ``make_mesh`` and ``mesh_from_config`` raise,
    naming the mesh's size and the world's."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="a mesh of 2 ranks.*world size 0"):
        make_mesh(2, device_type="cpu")
    mcfg = load_config(overrides={**SMALL, "runtime": {"mesh_shape": [2]}})
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh_from_config(mcfg, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        ps.make_multistream_step(mcfg, np.eye(3), device="cpu")


def test_make_mesh_raises_when_the_world_size_differs(rank_results):
    """On 2 ranks a mesh of 4 from ``runtime.mesh_shape`` is refused on both."""
    _, ranks = rank_results
    assert all(bool(got["mesh_of_another_size_raised"]) for got in ranks)


class _Ops(TorchDispatchMode):
    """Counts the operators that reach the backend (below vmap's batching)."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_batched_chunk_ops_do_not_grow_with_streams(seq, frames, ba_streams):
    """The batched chunk step with its keyframe steps dispatches the same operators, as
    many times, for 1 stream as for 4 (views and copies aside), and every extraction is
    one call of the layered operator: S streams share one set of launches."""
    cfg, vos = ba_streams
    step = ps.make_multistream_chunk_step(cfg, seq.K, device="cpu")
    counts = {}
    for S in (1, 4):
        sub = [vos[0], vos[2], vos[0], vos[2]][:S]          # all at frame_idx 0
        carry = ps.stack_streams([vo.chunk_carry() for vo in sub])
        fr = _next_frames(sub, frames, 2)
        with _Ops() as ops:
            step(carry, fr, ps.chunk_keys(ps.stream_keys(0, S), 2)[1], frame_idx=0)
        counts[S] = ops.count
    layout = {"aten.view", "aten._unsafe_view", "aten.clone", "aten.lift_fresh",
              "aten.expand", "aten.alias"}
    c1 = {k: v for k, v in counts[1].items() if k not in layout}
    c4 = {k: v for k, v in counts[4].items() if k not in layout}
    assert c1 == c4
    assert c4.get("lcvo.extract_blocks_layered") == 2 * 2 * cfg.klt.levels
    assert "lcvo.extract_blocks" not in c4

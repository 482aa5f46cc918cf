"""Lock-step through a recovery and across streams, at the small size of
``tests/test_torch_lockstep.py``: the JAX package and the port from the same seed.

- A seeded noise burst on frames 18-20 of 48 (``tests/test_torch_recovery_parity.py``'s)
  through ``run_chunked`` and ``run``: the re-bootstrap takes its key at the same point
  of the chain in both packages, so the same frames are held and the same pose_ok
  entries fall out.
- Two streams through the batched chunk step with BA (the single-stream bootstrap of
  each package, then ``make_multistream_chunk_step`` over two chunks of 4 with keys
  made as the JAX package's callers make them: ``split(PRNGKey(seed), S)``, each
  stream's chain split per chunk).

Measured (this file's runs, the CPU): the burst through ``run``: one re-bootstrap each,
entries 14-20 not ok in both, camera centers within 0.044 (median 0.039), R within
9.9e-3; through ``run_chunked``: the same re-bootstrap and held entries, centers within
0.289 (median 0.042; the re-bootstrap carries the scale of the steps before it, whose
difference it keeps), R within 0.023. The streams: pose_ok equal, R within 6.3e-3,
stream 1 (bootstrapped one frame later) within 0.100 unaligned (median 0.076) but 2.3e-3
after Sim(3): the two bootstraps fixed scales apart. Tolerances about twice the measured.
"""

import jax
import numpy as np
import pytest
import torch

from lcvo_tpu.parallel import streams as jstreams
from lcvo_tpu.pipeline import VisualOdometry as JVisualOdometry
from lcvo_tpu_torch.data.synthetic import SyntheticSequence, noise_burst
from lcvo_tpu_torch.metrics import lockstep
from lcvo_tpu_torch.parallel import streams as ps
from lcvo_tpu_torch.pipeline import VisualOdometry
from test_torch_lockstep import assert_lockstep, configs, drive

N = 48
BURST = (18, 21)
# (R, camera center) tolerances per loop; measured: see the module docstring and PERF.md
TOL = {"chunked": (5e-2, 0.6), "run": (2e-2, 0.09)}


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
    return np.stack([seq.frame(i) for i in range(N)]).astype(np.uint8)


@pytest.mark.parametrize("loop", ["chunked", "run"])
def test_noise_burst_recovers_in_lockstep(seq, frames, loop):
    tcfg, jcfg = configs()
    burst = noise_burst(frames, *BURST, seed=3)
    port = drive(VisualOdometry(tcfg, seq.K, device="cpu"), burst, loop)
    jax_run = drive(JVisualOdometry(jcfg, seq.K), burst, loop)
    assert port["rebootstraps"] >= 1
    assert not all(port["pose_ok"])
    assert_lockstep(port, jax_run, *TOL[loop])


def test_two_streams_with_ba_run_in_lockstep(seq, frames):
    tcfg, jcfg = configs(ba={"enabled": True, "window": 4, "keyframe_every": 3, "gn_iters": 3})
    S, chunk, gap = 2, 4, tcfg.bootstrap.frame_gap
    tvos = [VisualOdometry(tcfg, seq.K, device="cpu") for _ in range(S)]
    jvos = [JVisualOdometry(jcfg, seq.K) for _ in range(S)]
    for s in range(S):
        tvos[s].bootstrap(list(frames[s: s + gap + 1]))
        jvos[s].bootstrap(list(frames[s: s + gap + 1]))
    tcarry = ps.stack_streams([vo.chunk_carry() for vo in tvos])
    jcarry = jax.tree_util.tree_map(lambda *x: jax.numpy.stack(x), *[vo.chunk_carry() for vo in jvos])
    tstep = ps.make_multistream_chunk_step(tcfg, seq.K, device="cpu")
    jstep = jstreams.make_multistream_chunk_step(jcfg, seq.K)
    tkeys = ps.stream_keys(tcfg.seed, S)
    jkeys = jax.random.split(jax.random.PRNGKey(jcfg.seed), S)
    got = {"port": [], "jax": []}
    for c in range(2):
        fr = np.stack([frames[s + gap + 1 + c * chunk: s + gap + 1 + (c + 1) * chunk]
                       for s in range(S)])
        tkeys, keys = ps.chunk_keys(tkeys, chunk)
        nxt = jax.vmap(jax.random.split)(jkeys)
        jkeys = nxt[:, 0]
        jk = jax.vmap(lambda k: jax.random.split(k, chunk))(nxt[:, 1])
        np.testing.assert_array_equal(keys, np.asarray(jk))
        tcarry, tout = tstep(tcarry, torch.from_numpy(fr), keys, frame_idx=c * chunk)
        jcarry, jout = jstep(jcarry, jax.numpy.asarray(fr), jk)
        got["port"].append([x.numpy() for x in tout])
        got["jax"].append([np.asarray(x) for x in jout])
    for s in range(S):
        R, t, ok, ninl = (np.concatenate([g[i][s] for g in got["port"]]) for i in range(4))
        jR, jt, jok, jninl = (np.concatenate([g[i][s] for g in got["jax"]]) for i in range(4))
        np.testing.assert_array_equal(ok, jok)
        assert ok.all()
        cmp = lockstep(-np.einsum("nji,nj->ni", R, t), ok, ninl,
                       -np.einsum("nji,nj->ni", jR, jt), jok, jninl)
        assert float(np.abs(R - jR).max()) <= 1.3e-2, (s, cmp)
        assert cmp["distance_m_max"] <= 0.2, (s, cmp)
        assert cmp["distance_sim3_m_max"] <= 5e-3, (s, cmp)

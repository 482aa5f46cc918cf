"""Lock-step: whole runs of the JAX package and the port on the CPU from the same seed, at
the small size of ``tests/test_torch_pipeline.py`` (320x128, 256 tracks, ``frame_gap``
4). The port draws the JAX package's random stream (``utils/jax_random.py``), so both
take the same RANSAC samples and the port retraces the JAX trajectory up to rounding.
Here: ``run_chunked`` and ``run`` of the default configuration, and each package resuming
the other's checkpoint mid-run; ``tests/test_torch_lockstep_configs.py`` and
``tests/test_torch_lockstep_recovery.py`` hold the other configurations, a noise burst
and the streams.

Held equal: the number of poses, pose_ok of every entry (so the frames a re-bootstrap
holds), ``n_rebootstraps``, and after a resume the key chain. Held within a tolerance,
measured on these runs and set at about twice it: each entry's world-to-camera R and
camera center.

Measured (this file's runs, the CPU): the two packages' LAPACK SVDs round the
eight-point fits apart (ROADMAP §C, quirk 2: the 8th singular vector of an 8x9 system),
which swaps the MSAC winner between near-equal hypotheses at the default bootstrap; both
winners have 132 inliers and the refined poses differ by about 1e-3 in R. Both runs fix
their scale at that bootstrap, so the camera centers then stay apart: ``run_chunked``
median 0.043, max 0.065, R within 4.4e-3, 27 of 36 inlier counts equal (the first
differs at entry 14); ``run`` median 0.047, max 0.094, R within 5.5e-3, 26 of 36 equal.
Tolerances: R 1.2e-2, camera center 0.19 (the bootstrap's unit baseline is 1), a
quarter of the inlier counts equal.
"""

import numpy as np
import pytest
import torch

from lcvo_tpu.config import load_config as jload_config
from lcvo_tpu.pipeline import VisualOdometry as JVisualOdometry
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.metrics import lockstep
from lcvo_tpu_torch.pipeline import VisualOdometry

SMALL = {
    "image_width": 320, "image_height": 128,
    "state": {"max_tracks": 256, "max_candidates": 256, "max_new_per_frame": 96},
    "klt": {"window": 15, "iters": 8, "levels": 3},
    "ransac": {"e_hypotheses": 256, "pnp_hypotheses": 256},
    "bootstrap": {"frame_gap": 4},
}
N = 40
R_TOL = 1.2e-2
CENTER_TOL = 0.19


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
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


def configs(path=None, **over):
    """The port's and the JAX package's configuration of one run."""
    ov = {**SMALL, **over}
    return load_config(path, overrides=ov), jload_config(path, overrides=ov)


def drive(vo, frames, loop: str, chunk: int = 8) -> dict:
    """One package's host loop over ``frames``: the entries' poses, pose_ok and inlier
    counts (-1 where a pose was held without a PnP solve)."""
    ninl: list[int] = []
    if loop == "chunked":
        vo.run_chunked(frames, chunk=chunk,
                       on_chunk=lambda s, R, t, ok, n: ninl.extend(int(x) for x in n))
    else:
        vo.run(iter(frames), len(frames),
               on_frame=lambda i, r: ninl.append(int(np.asarray(r.n_inliers))))
    return run_of(vo, ninl)


def run_of(vo, ninl) -> dict:
    return {"poses": np.asarray(vo.poses), "pose_ok": list(vo.pose_ok_flags),
            "n_inliers": list(ninl), "rebootstraps": vo.n_rebootstraps}


def assert_lockstep(port: dict, jax_run: dict, r_tol=R_TOL, center_tol=CENTER_TOL) -> dict:
    """The held-equal and held-within checks of the module docstring; returns the
    comparison (``metrics.lockstep``) with the largest R difference."""
    P, J = port["poses"], jax_run["poses"]
    assert P.shape == J.shape
    assert port["pose_ok"] == jax_run["pose_ok"]
    assert port["rebootstraps"] == jax_run["rebootstraps"]
    cmp = lockstep(P[:, :3, 3], port["pose_ok"], port["n_inliers"],
                   J[:, :3, 3], jax_run["pose_ok"], jax_run["n_inliers"])
    cmp["R_max_abs_diff"] = float(np.abs(P[:, :3, :3] - J[:, :3, :3]).max())
    assert cmp["R_max_abs_diff"] <= r_tol, cmp
    assert cmp["distance_m_max"] <= center_tol, cmp
    return cmp


@pytest.fixture(scope="module")
def default_runs(seq, frames):
    """Both packages, the default configuration, both host loops."""
    tcfg, jcfg = configs()
    out = {}
    for loop in ("chunked", "run"):
        out[loop] = (drive(VisualOdometry(tcfg, seq.K, device="cpu"), frames, loop),
                     drive(JVisualOdometry(jcfg, seq.K), frames, loop))
    return out


@pytest.mark.parametrize("loop", ["chunked", "run"])
def test_default_runs_in_lockstep(default_runs, loop):
    """``run_chunked`` (chunks of 8 and a tail) and ``run``: 36 entries, every one
    pose_ok in both, R and camera centers within the tolerances."""
    port, jax_run = default_runs[loop]
    cmp = assert_lockstep(port, jax_run)
    assert len(port["pose_ok"]) == N - 4 and all(port["pose_ok"])
    assert cmp["inliers_equal_share"] >= 0.25


def test_loops_split_the_chain_as_the_jax_package(seq, frames):
    """Every bootstrap, frame and chunk takes its key at the JAX package's point of the
    chain: after a bootstrap, two chunks and a tail, and after a bootstrap and six
    steps, the port's chain is the JAX package's."""
    tcfg, jcfg = configs()
    for loop, n in (("chunked", 4 + 1 + 2 * 8 + 3), ("run", 4 + 1 + 6)):
        t = VisualOdometry(tcfg, seq.K, device="cpu")
        j = JVisualOdometry(jcfg, seq.K)
        drive(t, frames[:n], loop)
        drive(j, frames[:n], loop)
        np.testing.assert_array_equal(t._key, np.asarray(j._key))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_the_others_checkpoint(seq, frames, tmp_path, default_runs,
                                                   writer):
    """A chunked run of one package saves at a chunk boundary; the other package resumes
    the file with the writer's next key and finishes in lock step with the writer's
    uninterrupted run."""
    tcfg, jcfg = configs()
    make = {"port": lambda: VisualOdometry(tcfg, seq.K, device="cpu"),
            "jax": lambda: JVisualOdometry(jcfg, seq.K)}
    reader = "jax" if writer == "port" else "port"
    p = str(tmp_path / "ck.npz")
    want = default_runs["chunked"][0 if writer == "port" else 1]
    part = make[writer]()
    part.run_chunked(frames[:21], chunk=8, checkpoint_every=8, checkpoint_path=p)
    rest = make[reader]()
    start = rest.resume(p)
    assert start == 21
    np.testing.assert_array_equal(np.asarray(rest._key), np.asarray(part._key))
    ninl: list[int] = list(want["n_inliers"][: start - 4])
    rest.run_chunked_continue(iter(frames[start:]), start, chunk=8, n_frames=N,
                              on_chunk=lambda s, R, t, ok, n: ninl.extend(int(x) for x in n))
    got = run_of(rest, ninl)
    # the entries before the resume are the writer's, read back from the file
    np.testing.assert_array_equal(got["poses"][: start - 4], want["poses"][: start - 4])
    assert_lockstep(got, want)


def test_chip_smoke_holds_every_path_to_the_committed_reference(capsys):
    """``chip_smoke.py``'s lock-step table: every path it bounds has an entry in the
    committed JAX reference (``lcvo_tpu_torch/data/jax_lockstep.json``, with the command
    that made it), and each entry held against itself reads distance 0 with every bound
    met (the check's own arithmetic, on the CPU, where the script cannot run)."""
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    with open(os.path.join(root, chip_smoke.LOCKSTEP_FILE)) as fh:
        ref = json.load(fh)["paths"]
    assert set(chip_smoke.LOCKSTEP_BOUNDS) == set(ref)
    for path, r in ref.items():
        assert r["command"].startswith("python tools/port_jax_reference.py --paths ")
        out = chip_smoke.lockstep_check(path, np.asarray(r["centers"]), r["pose_ok"],
                                        r["n_inliers"], r["ate_m"], r["frames_sha256"])
        assert out["distance_m_max"] == 0.0 and out["frames_equal_reference"], path
    assert chip_smoke._lockstep_faults == []
    assert capsys.readouterr().out.count("[lockstep:") == len(ref)

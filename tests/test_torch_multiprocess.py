"""The port's process groups on the CPU (gloo): ``parallel/mesh.py::init_distributed``,
the ``DeviceMesh``-backed ``Mesh`` and its collectives, ``parallel/launch.py::run_ranks``,
and ``tools/port_dryrun_multirank.py`` (the counterpart of tests/test_multiprocess.py,
which runs the JAX package's ``init_distributed`` across two processes).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lcvo_tpu_torch.parallel.launch import run_ranks
from lcvo_tpu_torch.parallel.mesh import init_distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dryrun_multirank_two_ranks_on_the_cpu():
    """The dry run's step, BA chunk step and sharded solve on 2 gloo ranks: exit 0 and
    ``MULTIRANK-OK`` from both ranks."""
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "port_dryrun_multirank.py"),
                        "--nproc", "2", "--device", "cpu", "--timeout", "240"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    for r in range(2):
        assert f"MULTIRANK-OK rank={r} world=2" in p.stdout, p.stdout[-3000:]
    assert "dryrun_multirank(2): OK" in p.stdout


def test_init_distributed_is_a_noop_without_num_processes():
    assert init_distributed() is None
    assert init_distributed(coordinator="localhost:1", device="cpu") is None
    assert not dist.is_initialized()


@pytest.mark.parametrize("rendezvous", ["file_store", "coordinator"])
def test_init_distributed_joins_the_world(tmp_path, rendezvous):
    """Two ranks, joined through a ``file://`` store or a ``host:port`` coordinator: each
    has its own rank, world size 2, the CPU, a mesh of 2 along ``data`` whose index is
    the rank; ``psum`` and ``all_gather`` give the sum and the rank order;
    ``shard_batched_state`` cuts the leaves that divide, keeps the one that does not
    whole and ``None`` as it is, and ``gather_batched_state`` puts the parts back; a
    mesh of 4 ranks, or of a shape that is not the world's, is refused."""
    init = (f"file://{tmp_path / 'store'}" if rendezvous == "file_store"
            else f"localhost:{_free_port()}")
    out = str(tmp_path / "c")
    run_ranks("tests/torch_rank_programs.py:collectives", 2, [out], device="cpu", init=init,
              timeout=120)
    for r in range(2):
        got = np.load(f"{out}_rank{r}.npz")
        assert int(got["rank"]) == r and int(got["world"]) == 2
        assert str(got["device"]) == "cpu"
        assert int(got["mesh_shape"]) == 2 and int(got["index"]) == r
        assert float(got["psum"]) == 3.0
        np.testing.assert_array_equal(got["gathered"], [0, 0, 1, 1])
        np.testing.assert_array_equal(got["part_split"], np.arange(12).reshape(4, 3)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["part_odd"], np.arange(5, dtype=np.float32))
        assert bool(got["part_none"]) and bool(got["round_trip"])
        assert bool(got["bigger_raised"]) and bool(got["shape_raised"])


def test_init_distributed_refuses_a_missing_nccl():
    """``nccl`` where this build has none raises, naming ``is_nccl_available()``; it never
    turns into gloo."""
    if dist.is_nccl_available():
        pytest.skip("this build of PyTorch has NCCL")
    with pytest.raises(RuntimeError, match="is_nccl_available"):
        init_distributed(num_processes=1, process_id=0, backend="nccl", device="cpu")
    assert not dist.is_initialized()


def test_init_distributed_wants_cuda_unless_told():
    """The default device is CUDA: without a card it raises instead of joining on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(num_processes=1, process_id=0)
    assert not dist.is_initialized()


def test_a_failed_rank_fails_the_launch_and_leaves_no_rank_behind(tmp_path):
    """A rank that raises makes ``run_ranks`` raise with its output at once, and the
    other rank, waiting for it in a collective, is killed rather than left to time out."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)a rank failed.*rank 1 fails on purpose"):
        run_ranks("tests/torch_rank_programs.py:fail_on_one_rank", 2, [], device="cpu",
                  init=f"file://{tmp_path / 'store'}", timeout=120)
    assert time.monotonic() - t0 < 60

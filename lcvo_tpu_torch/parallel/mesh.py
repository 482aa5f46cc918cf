"""Process groups, the device mesh and this rank's part of a stream-batched state
(port of ``lcvo_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` of devices and lets XLA
place the shards. Here each device has a process of its own (a rank of
``torch.distributed``), and every rank runs the same program on its own part of the
data (SPMD):

- :func:`init_distributed` joins the process group (the counterpart of
  ``jax.distributed.initialize``) and sets the rank's CUDA device;
- a :class:`Mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
  the world with named axes, one process group per axis;
- :func:`shard_batched_state` gives this rank its part of a batched state (the leading
  stream dim cut in equal parts along an axis), :func:`gather_batched_state` puts the
  parts back together on every rank, and :func:`psum` / :func:`all_gather` are the
  collectives the sharded solvers reduce and gather with (``lax.psum`` and the
  ``out_specs`` of ``shard_map`` in the JAX package);
- :func:`compile_sharded` compiles a function whose collectives run on a mesh axis, as
  the JAX package jits its ``shard_map`` calls: on NCCL its collectives are captured into
  the CUDA graph with it (:func:`capturable`), on gloo it runs eagerly. A mesh keeps the
  compiled steps of its sharded calls.

A mesh needs a process group, so one process on one H100 is a world of one rank (NCCL
holds one rank per device). On the CPU the tests start several ranks on gloo.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from lcvo_tpu_torch.core.state import resolve_device
from lcvo_tpu_torch.utils.graphs import compile_step

# how long a rank waits for the others at the rendezvous and in a collective
TIMEOUT_S = 300


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device="cuda"):
    """Join the process group of ``num_processes`` ranks as rank ``process_id``; a no-op
    returning None when ``num_processes`` is None.

    ``coordinator`` is ``host:port`` of rank 0's store (a URL such as ``file:///path``
    or ``tcp://host:port`` is used as it is; None reads ``MASTER_ADDR``/``MASTER_PORT``).
    ``backend`` is ``nccl`` for CUDA and ``gloo`` for the CPU unless named; gloo also
    takes CUDA tensors. ``device`` is the device type the rank computes on; a CUDA rank
    runs on ``cuda:{LOCAL_RANK}``, or ``cuda:{rank % device_count}`` without that
    variable, and that device is made current. Returns the rank's device."""
    if num_processes is None:
        return None
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend 'nccl' was asked for and torch.distributed.is_nccl_available() "
                           "is False in this build of PyTorch; name backend='gloo' to use gloo")
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=-1 if process_id is None else process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if dev.type != "cuda":
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


class Mesh:
    """A ``DeviceMesh`` over the world's ranks with named axes; ``shape`` is the dict of
    axis name to size that the JAX package's ``Mesh.shape`` gives."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self._compiled: dict = {}       # compile_sharded's steps, by call and static arguments

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.device_mesh.shape))

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` that share this rank's other
        coordinates."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def capturable(mesh: Mesh, axis: str = "data") -> bool:
    """Whether the collectives of ``mesh``'s ``axis`` can be captured into a CUDA graph:
    true for NCCL, whose tensors are on the card; false for gloo. The backend decides,
    never a capture that failed."""
    return dist.get_backend(mesh.group(axis)) == dist.Backend.NCCL


def compile_sharded(make_fn, mesh: Mesh, axis: str, key: tuple):
    """The compiled step (``utils/graphs.py``) of a sharded call whose collectives run on
    ``mesh``'s ``axis``: ``make_fn()`` gives its function. Nothing is donated, as
    ``jax.jit`` of a ``shard_map`` donates nothing. On NCCL it is captured with its
    collectives (``thread_local`` capture mode, see ``utils/graphs.py``), on gloo it runs
    eagerly; the step's ``replayed`` tells which ran. ``key`` names the call (its first
    entry, the step's name) and its static arguments: the mesh keeps the step under it,
    so every later call with that key replays its graphs."""
    if key not in mesh._compiled:
        mesh._compiled[key] = compile_step(make_fn(), donate=False, name=key[0],
                                           eager=not capturable(mesh, axis),
                                           capture_mode="thread_local")
    return mesh._compiled[key]


def make_mesh(n_devices: int | None = None, axis_names: tuple = ("data",),
              shape: tuple | None = None, device_type: str = "cuda") -> Mesh:
    """A mesh over the ``n_devices`` ranks of the world (all of them when None), laid
    out as ``shape`` (all on the first axis when None). It covers the whole world:
    raises when no process group is initialised or when the world size is not the
    mesh's size."""
    if not (dist.is_available() and dist.is_initialized()):
        n = n_devices if shape is None else int(np.prod(shape))
        raise RuntimeError(f"a mesh of {n} ranks needs a process group, and none is "
                           f"initialised (world size 0): call init_distributed first")
    world = dist.get_world_size()
    n = n_devices or world
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or n != world:
        raise RuntimeError(f"a mesh of {int(np.prod(shape))} ranks (shape {shape}, "
                           f"n_devices {n_devices}) over a world of {world} ranks")
    if len(shape) != len(axis_names):
        raise ValueError(f"a mesh of shape {shape} needs {len(shape)} axis names, "
                         f"got {tuple(axis_names)}")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names)))


def mesh_from_config(cfg, device_type: str = "cuda") -> Mesh:
    """Mesh from ``cfg.runtime``: ``mesh_shape`` (empty = all ranks on the first axis)
    laid out over ``mesh_axes``."""
    rt = cfg.runtime
    shape = tuple(rt.mesh_shape) or None
    n = int(np.prod(shape)) if shape else None
    return make_mesh(n_devices=n, axis_names=tuple(rt.mesh_axes), shape=shape,
                     device_type=device_type)


def _splits(x, n: int) -> bool:
    return x.dim() >= 1 and x.shape[0] > 0 and x.shape[0] % n == 0


def shard_batched_state(state_pytree, mesh: Mesh, axis: str = "data"):
    """This rank's part of a batched (leading stream dim) pytree that every rank holds
    whole: the leading dim cut in ``mesh.shape[axis]`` equal parts, part
    ``mesh.index(axis)``; a leaf whose leading dim does not divide (or is 0) whole, as
    the JAX package replicates it."""
    n, k = mesh.shape[axis], mesh.index(axis)

    def part(x):
        if x is None or not _splits(x, n):
            return x
        m = x.shape[0] // n
        return x[k * m:(k + 1) * m]

    return tree_map(part, state_pytree)


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, on every one of them
    (``lax.psum``). ``x`` is left as it is."""
    out = x.clone()
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on the leading dim in the order of
    their coordinates, on every one of them: one collective into one buffer, which a
    CUDA graph can hold."""
    x = x.contiguous()
    out = x.new_empty((mesh.shape[axis] * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group(axis))
    return out


def gather_batched_state(part, mesh: Mesh, axis: str = "data"):
    """The inverse of :func:`shard_batched_state` for a tree whose leaves were all split
    (what a step returns): the parts of the ranks along ``axis`` concatenated along the
    stream dim, on every one of them."""
    return tree_map(lambda x: None if x is None else all_gather(x, mesh, axis), part)

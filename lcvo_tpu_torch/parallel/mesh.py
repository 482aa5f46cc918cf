"""Device mesh and the placement of stream-batched state (port of
``lcvo_tpu/parallel/mesh.py``).

The JAX package shards the stream dimension of a batched state over a
``jax.sharding.Mesh``. Here a :class:`Mesh` is a small array of ``torch.device`` objects
with named axes, and "sharding" over an axis means: the stream dimension is split in equal
parts, part ``k`` lives on the mesh's ``k``-th device along that axis, and each part
runs as one vmapped sub-batch there (:mod:`lcvo_tpu_torch.parallel.streams`). A leaf
whose leading dimension does not divide into the parts is replicated, as at
``lcvo_tpu/parallel/mesh.py:76-79``. Entries along the other axes would hold replicas of
the same part and are not used.

On one H100 the mesh has one device and nothing is split. On the CPU a mesh may hold
several entries of the one CPU device, so the split-and-merge code runs without a
cluster: the counterpart of the JAX package's virtual 8-device CPU mesh. Multi-process
bring-up (``init_distributed``) is not part of this module yet.

The parts run one after another from one host thread (``streams._Parts.run``). That is a
placeholder: on a launch-bound step, several CUDA devices driven from one thread
multiply the host's launches instead of spreading them. The ``torch.distributed`` slice
(one process per device) replaces it; it replaces this loop rather than running beside it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


class Mesh:
    """Devices laid out as an array with one name per axis."""

    def __init__(self, devices, axis_names: tuple):
        arr = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[i] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def devices_along(self, axis: str) -> list:
        """The devices of the entries along ``axis``, at index 0 of the other axes."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out


def make_mesh(n_devices: int | None = None, axis_names: tuple = ("data",),
              shape: tuple | None = None, device_type: str = "cuda") -> Mesh:
    """A mesh over the first ``n_devices`` local devices of ``device_type`` (all of them
    when None), laid out as ``shape`` (all on the first axis when None). The CPU is one
    device: a CPU mesh holds ``n_devices`` entries of it (one when None)."""
    if device_type == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    elif device_type == "cuda":
        count = torch.cuda.device_count()
        n = n_devices or count
        if not 1 <= n <= count:
            raise RuntimeError(f"a mesh of {n} CUDA devices, and this machine has {count}")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def mesh_from_config(cfg, device_type: str = "cuda") -> Mesh:
    """Mesh from ``cfg.runtime``: ``mesh_shape`` (empty = all local devices on the
    first axis) laid out over ``mesh_axes``."""
    rt = cfg.runtime
    shape = tuple(rt.mesh_shape) or None
    n = int(np.prod(shape)) if shape else None
    return make_mesh(n_devices=n, axis_names=tuple(rt.mesh_axes), shape=shape,
                     device_type=device_type)


class Sharding(NamedTuple):
    """Where the parts of a tensor go: one part per device in ``devices``; with
    ``split`` the leading (stream) dim is cut into equal parts, without it every part
    is the whole tensor."""

    devices: tuple
    split: bool

    def place(self, x: torch.Tensor) -> list:
        n = len(self.devices)
        if not self.split:
            return [x.to(d) for d in self.devices]
        if x.dim() < 1 or x.shape[0] % n:
            raise ValueError(f"a leading dim of {tuple(x.shape)[:1]} does not split in {n}")
        m = x.shape[0] // n
        return [x[k * m:(k + 1) * m].to(d) for k, d in enumerate(self.devices)]


def stream_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Sharding for tensors whose leading dim is the stream/batch dim."""
    return Sharding(tuple(mesh.devices_along(axis)), True)


def replicated(mesh: Mesh, axis: str = "data") -> Sharding:
    """The whole tensor on every device along ``axis``."""
    return Sharding(tuple(mesh.devices_along(axis)), False)


def shard_batched_state(state_pytree, mesh: Mesh, axis: str = "data") -> list:
    """The parts of a batched (leading stream dim) pytree, one tree per device along
    ``axis`` of ``mesh``: the leading dim split in equal parts, a leaf whose leading dim
    does not divide (or is 0) replicated. With one device the one part is the tree on
    that device."""
    sh, rep = stream_sharding(mesh, axis), replicated(mesh, axis)
    n = len(sh.devices)

    def place(x):
        if x is None:
            return [None] * n
        ok = x.dim() >= 1 and x.shape[0] > 0 and x.shape[0] % n == 0
        return (sh if ok else rep).place(x)

    leaves, spec = tree_flatten(state_pytree)
    placed = [place(x) for x in leaves]
    return [tree_unflatten([p[k] for p in placed], spec) for k in range(n)]


def gather_batched_state(parts: list, device=None):
    """The inverse of :func:`shard_batched_state` for a tree whose leaves were all
    split: the parts concatenated along the stream dim on ``device`` (the first part's
    when None)."""
    if len(parts) == 1:
        return parts[0]

    def cat(*xs):
        if xs[0] is None:
            return None
        dev = device or xs[0].device
        return torch.cat([x.to(dev) for x in xs], dim=0)

    return tree_map(cat, *parts)
